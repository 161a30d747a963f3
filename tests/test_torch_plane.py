"""The port's live plane over its torch chain engines,
``LivePlane(engine="torch")``, against the JAX package's
``LivePlane(engine="jax")``, on the CPU at float32.

The spec is tests/test_jax_plane.py's (its :32 and :78 build the same one:
3 servers, 5 Poisson requests, a 2-layer reduced stablelm-1.6b), loaded
into the port through JSON, plus the same spec with a server failed and
re-added mid-run.  The weights are the JAX ``Model.init`` pytree through
``params_from_jax``.  Per-request greedy streams, ``n_completed``, the
response quantiles on the simulated clock and the rest of
``RunReport.to_dict()`` must be equal for the slotted and paged layouts
and for the pipeline engine (2 stages, 2 microbatches, both layouts), set
up as tests/test_torch_pipeline.py sets up its reference.
"""
import types

import numpy as np
import pytest
import torch

from repro_torch import api
from repro_torch.configs import get
from repro_torch.models import Model, params_from_jax

OVERRIDES = dict(num_layers=2, vocab_size=256, attn_chunk_threshold=1 << 30,
                 dtype="float32")
PLANE = dict(dt=1.0, max_seq=64, prompt_tokens=6, tokens_per_work=4.0)
LAYOUTS = {
    "slotted": dict(kv_layout="slotted"),
    "paged": dict(kv_layout="paged"),
    "pipeline-paged": dict(kv_layout="paged", parallelism="pipeline",
                           pipeline_stages=2, microbatches=2),
    "pipeline-slotted": dict(kv_layout="slotted", parallelism="pipeline",
                             pipeline_stages=2, microbatches=2),
}


@pytest.fixture(scope="module")
def tiny():
    jax = pytest.importorskip("jax")
    from repro import api as j_api
    from repro.configs import get as jget
    from repro.core import Scenario as JScenario
    from repro.core import Server as JServer
    from repro.models import Model as JModel
    from repro.serving import service_spec_for as j_service_spec_for

    torch.backends.cuda.matmul.allow_tf32 = False    # float32 parity
    torch.backends.cudnn.allow_tf32 = False
    jcfg = jget("stablelm-1.6b").reduced(**OVERRIDES)
    cfg = get("stablelm-1.6b").reduced(**OVERRIDES)
    jmodel = JModel(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    model = Model(cfg, device="cpu")
    params = params_from_jax(jax.tree.map(np.asarray, jparams), cfg, "cpu")
    service = j_service_spec_for(jcfg, max_seq=64)
    servers = tuple(
        JServer(f"srv{i}", service.block_size_gb * 2
                + service.cache_size_gb * 2 * 5, 0.02, 0.01 * (1 + i % 2))
        for i in range(3))
    return types.SimpleNamespace(
        api=j_api, Scenario=JScenario, servers=servers, service=service,
        jmodel=jmodel, jparams=jparams, model=model, params=params)


def _spec(t, events: bool):
    """tests/test_jax_plane.py's spec; with ``events``, ``srv0`` fails at
    t = 2 s, while requests are in flight, and rejoins at t = 4 s."""
    sc = t.Scenario(horizon=8.0)
    if events:
        sc = sc.fail(2.0, "srv0").add(4.0, t.servers[0])
    a = t.api
    return a.ExperimentSpec(
        cluster=a.ClusterSpec(servers=t.servers, service=t.service),
        scenario=a.ScenarioSpec.from_scenario(sc),
        workload=a.WorkloadSpec(generator="poisson", base_rate=1.5,
                                params={"n": 5}),
        seed=0, name="jax-plane-smoke")


def _outcome(report):
    """Per-request streams and the report without the live handle."""
    orch = report.extras.pop("orchestrator")
    streams = {r.rid: list(r.output) for r in orch.finished}
    return streams, report.to_dict()


@pytest.mark.parametrize("events", [False, True], ids=["steady", "fail-add"])
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_torch_plane_matches_jax_plane(tiny, layout, events):
    spec = _spec(tiny, events)
    want = tiny.api.run(spec, plane=tiny.api.LivePlane(
        engine="jax", model=tiny.jmodel, params=tiny.jparams,
        **PLANE, **LAYOUTS[layout]))
    got = api.run(api.ExperimentSpec.from_json(spec.to_json()),
                  plane=api.LivePlane(engine="torch", model=tiny.model,
                                      params=tiny.params, **PLANE,
                                      **LAYOUTS[layout]))
    assert got.completed_all, got.summary_line()
    assert got.n_completed == got.n_jobs == 5 and got.n_failed == 0
    assert np.isfinite(got.response["mean"])
    orch = got.extras["orchestrator"]
    assert all(len(r.output) == r.max_new_tokens for r in orch.finished)
    got_streams, got_dict = _outcome(got)
    want_streams, want_dict = _outcome(want)
    assert got_streams == want_streams
    assert got_dict == want_dict
    if events:
        fail, add = got.events
        assert fail["kind"] == "fail" and fail["requeued"] > 0
        assert add["kind"] == "add" and add["chains"] > fail["chains"]

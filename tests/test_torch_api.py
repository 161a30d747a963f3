"""The port's experiment API (``repro_torch.api``) against the JAX package's
(``repro.api``), on the CPU.

* Specs built in one package load in the other through JSON, in both
  directions, with equal dicts; validation errors name the same field.
* The workload generators and the arrival resolution give bit-identical
  traces.
* On the mock plane (``LivePlane(engine="mock")``) a spec gives the same
  ``RunReport.to_dict()`` in both packages, cluster events and autoscaling
  included.  The live handles in ``extras`` (``orchestrator``,
  ``controller``) serialise as their reprs, which name an address, so the
  comparison leaves them out.
* The autoscale and metrics copies match the reference on the same inputs,
  including the sim-plane half of the controller, driven by the JAX
  package's simulator.
* The plane's knobs validate as the JAX package's do; what the port has not
  ported raises naming its ROADMAP item.

The model plane (``engine="torch"``) is in tests/test_torch_plane.py.
"""
import json
import math
import random
import types

import numpy as np
import pytest

from repro_torch import api
from repro_torch import autoscale as t_autoscale
from repro_torch import core as t_core
from repro_torch.api import planes as t_planes
from repro_torch.core import scenarios as t_scenarios
from repro_torch.core import workload as t_workload
from repro_torch.core.simulator import SimResult
from repro_torch.obs import LogHistogram, MetricsRegistry
from repro_torch.serving import Request, mock_orchestrator


@pytest.fixture(scope="module")
def ref():
    pytest.importorskip("jax")
    from repro import api as j_api
    from repro import autoscale as j_autoscale
    from repro import core as j_core
    from repro import obs as j_obs
    from repro.api import planes as j_planes
    from repro.core import scenarios as j_scenarios
    from repro.core import workload as j_workload
    from repro.core.engines import make_engine
    from repro.serving import Request as JRequest
    from repro.serving import mock_orchestrator as j_mock_orchestrator
    return types.SimpleNamespace(
        api=j_api, autoscale=j_autoscale, core=j_core, obs=j_obs,
        planes=j_planes, scenarios=j_scenarios, workload=j_workload,
        make_engine=make_engine, Request=JRequest,
        mock_orchestrator=j_mock_orchestrator)


PORT = types.SimpleNamespace(api=api, core=t_core, autoscale=t_autoscale,
                             planes=t_planes, scenarios=t_scenarios,
                             workload=t_workload, Request=Request,
                             mock_orchestrator=mock_orchestrator)
SIM_ENGINES = ("batched", "vector")


def packages(ref):
    return {"jax": ref, "torch": PORT}


# ---------------------------------------------------------------------------
# Spec builders: each takes a package namespace and builds the same spec
# ---------------------------------------------------------------------------

def service(ns):
    return ns.core.ServiceSpec(num_blocks=10, block_size_gb=1.32,
                               cache_size_gb=0.11)


def template(ns):
    return ns.core.Server("tmpl", 30.0, 0.05, 0.05)


def cluster(ns, n=8, seed=1234):
    rng = random.Random(seed)
    return tuple(ns.core.Server(f"s{i}", rng.uniform(15, 40),
                                rng.uniform(0.02, 0.2), rng.uniform(0.02, 0.2))
                 for i in range(n))


def scripted(ns, servers, horizon=120.0):
    return (ns.core.Scenario(horizon=horizon, description="fail+burst+recover")
            .fail(horizon * 0.3, "s3")
            .burst(horizon * 0.5, horizon * 0.15, 4.0)
            .recover(horizon * 0.7, servers[3]))


def two_classes(ns, batch_deadline=math.inf):
    RC = ns.core.RequestClass
    return (RC("interactive", "chat", 0, slo_target=2.0),
            RC("batch", "offline", 1, deadline=batch_deadline))


def random_spec(ns, rng: random.Random):
    """A randomized-but-valid spec touching most of the surface
    (tests/test_api.py's generator, over either package)."""
    a = ns.api
    horizon = rng.uniform(50.0, 500.0)
    servers = cluster(ns, rng.randint(4, 10), seed=rng.randrange(10_000))
    precomposed = rng.random() < 0.3
    if precomposed:
        cl = a.ClusterSpec(job_servers=tuple(
            (round(rng.uniform(0.2, 2.0), 3), rng.randint(1, 8))
            for _ in range(rng.randint(1, 4))),
            engine=rng.choice(SIM_ENGINES))
        sc = a.ScenarioSpec(
            horizon=horizon,
            events=(ns.core.ScenarioEvent(horizon * 0.4, "burst", scale=3.0,
                                          duration=horizon * 0.1),))
    else:
        cl = a.ClusterSpec(
            servers=servers, service=service(ns),
            rho_bar=round(rng.uniform(0.4, 0.95), 2),
            tuner=rng.choice(list(a.TUNERS)),
            engine=rng.choice(SIM_ENGINES))
        sc = a.ScenarioSpec.from_scenario(scripted(ns, servers, horizon))
    classes, class_rates = (), None
    if rng.random() < 0.5:
        classes = two_classes(ns, rng.choice([math.inf, 30.0]))
        class_rates = (round(rng.uniform(0.5, 3.0), 3),
                       round(rng.uniform(0.5, 3.0), 3))
    autoscale = None
    if not precomposed and rng.random() < 0.5:
        scaler = rng.choice(list(a.SCALERS))
        params = {}
        if scaler == "slo-admission":
            params = {"slo": 4.0, "inner": {"policy": "target-util",
                                            "params": {"high": 0.9}}}
        elif scaler == "predictive":
            params = {"lead": round(rng.uniform(10.0, 40.0), 1)}
        autoscale = a.AutoscaleSpec(
            policy=scaler, template=template(ns), params=params,
            interval=round(rng.uniform(2.0, 10.0), 1),
            max_servers=rng.randint(4, 32),
            slo_response_time=rng.choice([None, 4.0]))
    return a.ExperimentSpec(
        cluster=cl, scenario=sc,
        workload=a.WorkloadSpec(
            base_rate=round(rng.uniform(1.0, 8.0), 3),
            class_rates=class_rates, classes=classes,
            seed=rng.choice([None, rng.randrange(100)])),
        policy=a.PolicySpec(name=rng.choice(list(a.DISPATCH_POLICIES)),
                            aging_rate=rng.choice([0.0, 0.001])),
        admission=a.AdmissionSpec(level=rng.choice([1.0, 0.5])),
        autoscale=autoscale,
        seed=rng.randrange(1000),
        warmup_fraction=rng.choice([0.0, 0.1]),
        rng_scheme=rng.choice(["legacy", "counter"]),
        name=f"rand-{rng.randrange(10_000)}")


def spec_fail_recover(ns):                     # tests/test_api.py:404
    a, servers = ns.api, cluster(ns, 6)
    return a.ExperimentSpec(
        cluster=a.ClusterSpec(servers=servers, service=service(ns)),
        scenario=a.ScenarioSpec.from_scenario(
            ns.core.Scenario(horizon=60.0).fail(20.0, "s3")
            .recover(40.0, servers[3])),
        workload=a.WorkloadSpec(base_rate=2.0), seed=0, name="both-planes")


def spec_multitenant(ns):                      # tests/test_api.py:426
    a = ns.api
    return a.ExperimentSpec(
        cluster=a.ClusterSpec(servers=(ns.core.Server("b0", 16.0, 0.05, 0.08),),
                              service=service(ns)),
        scenario=a.ScenarioSpec(horizon=40.0),
        workload=a.WorkloadSpec(class_rates=(2.0, 2.0),
                                classes=two_classes(ns, 2.0)),
        policy=a.PolicySpec(name="priority", aging_rate=0.001),
        seed=1)


def spec_warmup(ns, fraction=0.5):             # tests/test_api.py:626
    a = ns.api
    return a.ExperimentSpec(
        cluster=a.ClusterSpec(servers=cluster(ns, 6), service=service(ns)),
        scenario=a.ScenarioSpec(horizon=60.0),
        workload=a.WorkloadSpec(base_rate=2.0), seed=0,
        warmup_fraction=fraction)


def spec_autoscale_predictive(ns):             # tests/test_api.py:359
    a, tmpl = ns.api, template(ns)
    return a.ExperimentSpec(
        cluster=a.ClusterSpec(servers=(ns.core.Server(
            "b0", tmpl.memory_gb, tmpl.tau_c, tmpl.tau_p),),
            service=service(ns)),
        scenario=a.ScenarioSpec(horizon=150.0),
        workload=a.WorkloadSpec(base_rate=4.0),
        autoscale=a.AutoscaleSpec(
            policy="predictive", template=tmpl,
            params={"lead": 20.0, "margin": 1.2},
            interval=5.0, cooldown=20.0, warmup_lag=10.0,
            min_servers=1, max_servers=12, slo_response_time=3.0,
            telemetry_window=20.0),
        seed=0)


def heavy_service(ns):
    """Half a GB of cache per block and slot: a few slots per server, so a
    scaler sees high utilisation at a few requests per second."""
    return ns.core.ServiceSpec(num_blocks=10, block_size_gb=1.32,
                               cache_size_gb=0.5)


def spec_autoscale_target_util(ns):
    """Scripted fail/burst/recover under a reactive scaler."""
    a = ns.api
    servers = cluster(ns, 4)
    return a.ExperimentSpec(
        cluster=a.ClusterSpec(servers=servers, service=heavy_service(ns)),
        scenario=a.ScenarioSpec.from_scenario(scripted(ns, servers, 100.0)),
        workload=a.WorkloadSpec(base_rate=2.0),
        autoscale=a.AutoscaleSpec(
            policy="target-util", template=template(ns),
            params={"high": 0.8, "low": 0.3}, interval=4.0, cooldown=8.0,
            warmup_lag=6.0, max_servers=10, slo_response_time=4.0),
        seed=3)


def spec_autoscale_slo_admission(ns):
    """Two tenants, the admission gate wrapped around a queue-gradient
    scaler, through the same scripted events."""
    a = ns.api
    servers = cluster(ns, 4)
    return a.ExperimentSpec(
        cluster=a.ClusterSpec(servers=servers, service=heavy_service(ns)),
        scenario=a.ScenarioSpec.from_scenario(scripted(ns, servers, 100.0)),
        workload=a.WorkloadSpec(class_rates=(1.0, 1.0),
                                classes=two_classes(ns, 3.0)),
        policy=a.PolicySpec(name="priority", aging_rate=0.001),
        autoscale=a.AutoscaleSpec(
            policy="slo-admission", template=template(ns),
            params={"slo": 1.5, "inner": {"policy": "queue-gradient",
                                          "params": {"depth_threshold": 2}}},
            interval=4.0, cooldown=8.0, warmup_lag=6.0, max_servers=8),
        seed=3)


def spec_group_slowdown(ns):
    """Straggler drift, a correlated failure and a recovery."""
    a, servers = ns.api, cluster(ns, 8)
    sc = (ns.core.Scenario(horizon=60.0).slowdown(10.0, "s1", 3.0)
          .fail_group(20.0, ["s2", "s4"]).add(35.0, servers[2]))
    return a.ExperimentSpec(
        cluster=a.ClusterSpec(servers=servers, service=service(ns)),
        scenario=a.ScenarioSpec.from_scenario(sc),
        workload=a.WorkloadSpec(base_rate=3.0), seed=4)


MOCK_SPECS = {
    "fail-recover": spec_fail_recover,
    "multitenant": spec_multitenant,
    "warmup": spec_warmup,
    "autoscale-predictive": spec_autoscale_predictive,
    "autoscale-target-util": spec_autoscale_target_util,
    "autoscale-slo-admission": spec_autoscale_slo_admission,
    "fail-group-slowdown": spec_group_slowdown,
}


def comparable(report) -> dict:
    """``RunReport.to_dict()`` without the live handles."""
    d = report.to_dict()
    for handle in ("orchestrator", "controller"):
        d["extras"].pop(handle, None)
    return d


# ---------------------------------------------------------------------------
# (a) specs load across packages
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("source", ["jax", "torch"])
def test_specs_load_in_the_other_package(ref, source):
    """40 randomized specs and every named spec of this file, built in one
    package and loaded into the other through JSON: equal dicts and JSON,
    and the same spec as building it in the other package directly."""
    pk = packages(ref)
    src, dst = pk[source], pk["torch" if source == "jax" else "jax"]
    rng_src, rng_dst = random.Random(7), random.Random(7)
    built = [(random_spec(src, rng_src), random_spec(dst, rng_dst))
             for _ in range(40)]
    built += [(fn(src), fn(dst)) for fn in MOCK_SPECS.values()]
    for spec, twin in built:
        loaded = dst.api.ExperimentSpec.from_json(spec.to_json())
        assert loaded.to_dict() == spec.to_dict() == twin.to_dict()
        assert loaded == twin
        assert loaded.to_json() == spec.to_json()
        json.dumps(spec.to_dict())


def test_port_spec_rejects_regions(ref):
    """A multi-region spec of the JAX package does not load in the port:
    the field names the ROADMAP item, not a parse error."""
    servers = cluster(ref, 4)
    spec = ref.api.ExperimentSpec(
        cluster=ref.api.ClusterSpec(
            servers=servers, service=service(ref),
            regions=ref.api.RegionSpec(names=("a", "b"),
                                       latency=((0.0, 0.05), (0.05, 0.0)))),
        scenario=ref.api.ScenarioSpec(horizon=50.0),
        workload=ref.api.WorkloadSpec(base_rate=2.0))
    with pytest.raises(api.SpecError, match="cluster.regions.*ROADMAP"):
        api.ExperimentSpec.from_json(spec.to_json())
    with pytest.raises(api.SpecError, match="cluster.regions"):
        api.ClusterSpec(servers=cluster(PORT, 4), service=service(PORT),
                        regions=object())


def _bad_event_kind(ns):
    d = spec_fail_recover(ns).to_dict()
    d["scenario"]["events"][0]["kind"] = "explode"
    return ns.api.ExperimentSpec.from_dict(d)


def _bad_key(ns):
    d = spec_fail_recover(ns).to_dict()
    d["workload"]["bogus"] = 1
    return ns.api.ExperimentSpec.from_dict(d)


def _precomposed_events(ns):
    a = ns.api
    return a.ExperimentSpec(
        cluster=a.ClusterSpec(job_servers=((1.0, 4), (0.5, 8))),
        scenario=a.ScenarioSpec.from_scenario(scripted(ns, cluster(ns))),
        workload=a.WorkloadSpec(base_rate=1.0))


def _precomposed_autoscale(ns):
    a = ns.api
    return a.ExperimentSpec(
        cluster=a.ClusterSpec(job_servers=((1.0, 4),)),
        scenario=a.ScenarioSpec(horizon=100.0),
        workload=a.WorkloadSpec(base_rate=1.0),
        autoscale=a.AutoscaleSpec(policy="predictive", template=template(ns)))


def _region_event(ns):
    a = ns.api
    return a.ExperimentSpec(
        cluster=a.ClusterSpec(servers=cluster(ns), service=service(ns)),
        scenario=a.ScenarioSpec(horizon=50.0, events=(
            ns.core.ScenarioEvent(10.0, "region_evacuate", sid="eu"),)),
        workload=a.WorkloadSpec(base_rate=1.0))


SPEC_ERRORS = {
    "policy": lambda ns: ns.api.PolicySpec(name="nosuch"),
    "tuner": lambda ns: ns.api.ClusterSpec(servers=cluster(ns),
                                           service=service(ns), tuner="warp"),
    "engine": lambda ns: ns.api.ClusterSpec(servers=cluster(ns),
                                            service=service(ns), engine="warp"),
    "generator": lambda ns: ns.api.WorkloadSpec(generator="nope", base_rate=1.0),
    "scaler": lambda ns: ns.api.AutoscaleSpec(policy="nope",
                                              template=template(ns)),
    "no-template": lambda ns: ns.api.AutoscaleSpec(policy="predictive"),
    "event-kind": _bad_event_kind,
    "dict-key": _bad_key,
    "empty-cluster": lambda ns: ns.api.ClusterSpec(),
    "no-service": lambda ns: ns.api.ClusterSpec(servers=cluster(ns)),
    "rho-bar": lambda ns: ns.api.ClusterSpec(servers=cluster(ns),
                                             service=service(ns), rho_bar=1.5),
    "missing-rate": lambda ns: ns.api.ExperimentSpec(
        cluster=ns.api.ClusterSpec(servers=cluster(ns), service=service(ns)),
        scenario=ns.api.ScenarioSpec(horizon=10.0),
        workload=ns.api.WorkloadSpec()),
    "class-rates": lambda ns: ns.api.WorkloadSpec(
        class_rates=(1.0,), classes=two_classes(ns)),
    "service-model": lambda ns: ns.api.WorkloadSpec(base_rate=1.0,
                                                    service_model="joules"),
    "horizon": lambda ns: ns.api.ScenarioSpec(horizon=0.0),
    "precomposed-events": _precomposed_events,
    "precomposed-autoscale": _precomposed_autoscale,
    "region-event": _region_event,
    "rng-scheme": lambda ns: spec_fail_recover(ns).replace(rng_scheme="dice"),
    "warmup": lambda ns: spec_fail_recover(ns).replace(warmup_fraction=1.0),
    "version": lambda ns: ns.api.ExperimentSpec.from_dict(
        dict(spec_fail_recover(ns).to_dict(), version=2)),
}


@pytest.mark.parametrize("case", list(SPEC_ERRORS))
def test_spec_errors_name_the_same_field(ref, case):
    fields = []
    for ns in packages(ref).values():
        with pytest.raises(ValueError) as err:
            SPEC_ERRORS[case](ns)
        assert isinstance(err.value, ns.api.SpecError), err.value
        fields.append(err.value.field)
    assert fields[0] == fields[1]


# ---------------------------------------------------------------------------
# Arrival traces: bit-identical
# ---------------------------------------------------------------------------

def _workload_spec(ns, generator):
    a = ns.api
    sc = (ns.core.Scenario(horizon=80.0).burst(20.0, 10.0, 3.0)
          .tenant_burst(40.0, 10.0, 4.0, cls=1))
    workload = {
        "scenario": a.WorkloadSpec(base_rate=3.0),
        "scenario-classed": a.WorkloadSpec(class_rates=(1.0, 2.0),
                                           classes=two_classes(ns)),
        "poisson": a.WorkloadSpec(generator="poisson", base_rate=2.0,
                                  params={"n": 300}),
        "diurnal": a.WorkloadSpec(generator="diurnal", base_rate=4.0,
                                  params={"amplitude": 0.5, "n_segments": 12}),
        "classed-mix": a.WorkloadSpec(generator="classed-mix",
                                      class_rates=(1.5, 0.5),
                                      classes=two_classes(ns)),
        "azure-trace": a.WorkloadSpec(generator="azure-trace", base_rate=2.0,
                                      service_model="tokens",
                                      params={"n": 400, "rate_scale": 0.5}),
        "classed-azure-trace": a.WorkloadSpec(
            generator="classed-azure-trace", base_rate=2.0,
            classes=two_classes(ns), params={"n": 400, "weights": [0.7, 0.3]}),
    }[generator]
    return a.ExperimentSpec(
        cluster=a.ClusterSpec(servers=cluster(ns, 3), service=service(ns)),
        scenario=a.ScenarioSpec.from_scenario(sc), workload=workload, seed=11)


def _trace(ns, spec, arrivals=None):
    scenario = spec.scenario.to_scenario()
    arr = ns.planes._resolve_workload(spec, scenario, arrivals)
    return ns.scenarios._resolve_arrivals(
        scenario, spec.workload.resolved_base_rate(), spec.workload_seed(),
        arr, spec.workload.service_model,
        spec.workload.trace_stats or ns.workload.AZURE_STATS,
        spec.workload.class_rates)


def _assert_same_columns(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        if x is None or y is None:
            assert x is None and y is None
            continue
        x, y = np.asarray(x), np.asarray(y)
        assert x.dtype == y.dtype and x.shape == y.shape
        assert np.array_equal(x, y)


@pytest.mark.parametrize("generator", [
    "scenario", "scenario-classed", "poisson", "diurnal", "classed-mix",
    "azure-trace", "classed-azure-trace"])
def test_arrival_traces_bit_identical(ref, generator):
    times = []
    for ns in packages(ref).values():
        times.append(_trace(ns, _workload_spec(ns, generator)))
    assert len(times[0][0]) > 10
    _assert_same_columns(times[0], times[1])


def test_arrival_overrides_coerce_identically(ref):
    rows = [(0.5, 1.0, 3, 4, 0), (1.0, 0.5, 5, 6, 1), (1.5, 2.0, 7, 8, 0)]
    for form in (rows, tuple(rows), rows[:2]):
        out = [ns.planes._coerce_arrivals(form)
               for ns in packages(ref).values()]
        _assert_same_columns(out[0], out[1])
    for ns in packages(ref).values():
        with pytest.raises(ns.api.SpecError, match="arrivals"):
            ns.planes._coerce_arrivals((0.5, 1.0))


WORKLOAD_FUNCTIONS = {
    "poisson_exponential": lambda w: w.poisson_exponential(1.7, 200, seed=3),
    "azure_like_trace": lambda w: w.azure_like_trace(200, seed=4,
                                                     rate_scale=2.0),
    "poisson_exponential_np": lambda w: w.poisson_exponential_np(
        1.7, 200, seed=3),
    "azure_like_trace_np": lambda w: w.azure_like_trace_np(200, seed=5),
    "phased_poisson": lambda w: w.phased_poisson(
        [(10.0, 20.0, 5.0), (0.0, 10.0, 1.0), (20.0, 25.0, 0.0)], seed=6),
    "classed_phased_poisson": lambda w: w.classed_phased_poisson(
        [[(0.0, 30.0, 1.0)], [(0.0, 10.0, 3.0), (10.0, 30.0, 0.5)]], seed=7),
    "label_classes": lambda w: w.label_classes(100, [0.2, 0.5, 0.3], seed=8),
    "diurnal_phases": lambda w: w.diurnal_phases(3.0, 100.0, n_segments=8),
    "trace_replay_phases": lambda w: w.trace_replay_phases(
        w.azure_like_trace_np(300, seed=9)[0], bin_width=5.0, rate_scale=0.5),
    "token_work": lambda w: w.token_work(np.array([10, 2048, 4000]),
                                         np.array([1, 28, 90])),
    "interarrival_std_ratio": lambda w: w.interarrival_std_ratio(
        w.azure_like_trace(300, seed=10)),
    "interactive_batch_mix": lambda w: w.interactive_batch_mix(1.0, 5.0),
}


@pytest.mark.parametrize("fn", list(WORKLOAD_FUNCTIONS))
def test_workload_functions_match_reference(ref, fn):
    a = WORKLOAD_FUNCTIONS[fn](ref.workload)
    b = WORKLOAD_FUNCTIONS[fn](t_workload)
    if fn == "interactive_batch_mix":
        assert [vars(c) for c in a] == [vars(c) for c in b]
    elif isinstance(a, tuple):
        _assert_same_columns(a, b)
    else:
        assert np.array_equal(np.asarray(a), np.asarray(b))


# ---------------------------------------------------------------------------
# (b) the mock plane: equal reports
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", list(MOCK_SPECS))
def test_mock_plane_reports_equal(ref, name):
    """The same spec (loaded into the port from the JAX package's JSON) on
    both packages' mock planes: equal ``RunReport.to_dict()``, which holds
    the event log, the quantiles, the per-class stats, the cost report and
    the scaling records."""
    spec = MOCK_SPECS[name](ref)
    port_spec = api.ExperimentSpec.from_json(spec.to_json())
    want = ref.api.run(spec, plane=ref.api.LivePlane(dt=0.5))
    got = api.run(port_spec, plane=api.LivePlane(dt=0.5))
    assert comparable(got) == comparable(want)
    assert got.plane == "live" and got.n_jobs > 20
    if spec.autoscale is not None:
        assert got.cost == want.cost and got.cost["policy"] == \
            spec.autoscale.policy
    if name in ("autoscale-target-util", "autoscale-slo-admission"):
        actions = {r["action"] for r in got.extras["scaling_records"]}
        assert {"add", "remove"} <= actions, actions
    if spec.scenario.events:
        assert got.events == want.events and got.events
    if name == "multitenant":
        assert set(got.per_class) == {0, 1}
        assert got.per_class[0]["name"] == "interactive"
        assert got.n_completed + got.n_rejected + got.n_failed == got.n_jobs


def test_warmup_fraction_trims_the_front():
    """tests/test_api.py:626 on the port."""
    full = api.run(spec_warmup(PORT, 0.0), plane=api.LivePlane(dt=0.5))
    trimmed = api.run(spec_warmup(PORT, 0.5), plane=api.LivePlane(dt=0.5))
    assert trimmed.completed_all
    assert trimmed.n_jobs == full.n_jobs
    assert trimmed.n_completed == full.n_completed - int(full.n_completed * 0.5)
    assert trimmed.response["mean"] != full.response["mean"]


def test_report_serialises_and_rebuilds():
    rep = api.run(spec_fail_recover(PORT), plane=api.LivePlane(dt=0.5))
    d = json.loads(json.dumps(rep.to_dict()))
    back = api.RunReport.from_dict(d)
    assert back.diff(rep) == {}
    assert "orchestrator" in d["extras"]       # as its repr
    assert rep.summary_line().startswith("[live] both-planes: ")


def _drive_build(ns, hook=False):
    orch = ns.mock_orchestrator(
        [ns.core.Server(f"b{i}", 16.0, 0.05, 0.08) for i in range(3)],
        service(ns), arrival_rate=1.0)
    if hook:
        orch.step_hooks.append(lambda o, now: None)
    reqs = [(0.5 * i, ns.Request(rid=i, prompt=np.ones(4, np.int32),
                                 max_new_tokens=5, arrival_time=0.5 * i))
            for i in range(20)]
    reqs.append((200.0, ns.Request(rid=20, prompt=np.ones(4, np.int32),
                                   max_new_tokens=4, arrival_time=200.0)))
    sc = (ns.core.Scenario(horizon=250.0).fail(5.0, "b0")
          .recover(10.0, ns.core.Server("b0", 16.0, 0.05, 0.08)))
    return orch, reqs, sc


@pytest.mark.parametrize("hook", [False, True], ids=["fast-forward", "spin"])
def test_drive_orchestrator_and_shim_match_reference(ref, hook):
    """The drive loop (with and without idle fast-forward) and the
    orchestrator's deprecated ``run_scenario`` shim against the JAX
    package's ``drive_orchestrator``: equal summaries and outputs."""
    j_orch, j_reqs, j_sc = _drive_build(ref, hook)
    want = ref.api.drive_orchestrator(j_orch, j_sc, j_reqs, dt=0.5)
    orch, reqs, sc = _drive_build(PORT, hook)
    got = api.drive_orchestrator(orch, sc, reqs, dt=0.5)
    assert got == want
    assert (got["idle_skipped"] > 300) != hook
    assert [r.output for _, r in reqs] == [r.output for _, r in j_reqs]
    orch, reqs, sc = _drive_build(PORT, hook)
    with pytest.warns(DeprecationWarning, match="drive_orchestrator"):
        assert orch.run_scenario(sc, reqs, dt=0.5) == want


# ---------------------------------------------------------------------------
# Autoscale and metrics copies
# ---------------------------------------------------------------------------

def test_controller_sim_hooks_match_reference(ref):
    """The sim-plane half of the port's controller (``control_tick``,
    ``take_ready``, ``pick_victims``, ``needs_retune``), injected into the
    JAX package's sim plane: the same run and scaling records as the JAX
    package's own controller."""
    spec = spec_autoscale_target_util(ref).replace(
        workload=ref.api.WorkloadSpec(base_rate=4.0))
    want = ref.api.run(spec, plane="sim")
    ctl = api.ExperimentSpec.from_json(spec.to_json()).autoscale \
        .build_controller()
    got = ref.api.run(spec, plane="sim", controller=ctl)
    assert got.extras["scaling_records"] == want.extras["scaling_records"]
    actions = {r["action"] for r in got.extras["scaling_records"]}
    assert {"add", "remove"} <= actions, actions
    assert np.array_equal(got.raw.result.response_times,
                          want.raw.result.response_times)
    assert got.cost == want.cost


def test_sample_simulator_matches_reference(ref):
    """Both packages' telemetry fed tick by tick from one paused JAX-package
    simulator give the same estimates."""
    times, works = ref.workload.poisson_exponential_np(3.0, 400, seed=2)
    sim = ref.make_engine("vector", [1.0, 0.6], [3, 2], policy="jffc", seed=1)
    sim.add_arrivals(times, works, None)
    tels = [ref.autoscale.Telemetry(ref.autoscale.TelemetryConfig(window=10.0)),
            t_autoscale.Telemetry(t_autoscale.TelemetryConfig(window=10.0))]
    feeders = [ref.autoscale.sample_simulator, t_autoscale.sample_simulator]
    cursors = [(0, 0.0), (0, 0.0)]
    for t in np.arange(2.0, 120.0, 2.0):
        sim.run_until(float(t))
        cursors = [feed(tel, sim, float(t), 2, cur)
                   for feed, tel, cur in zip(feeders, tels, cursors)]
        est = [(tel.arrival_rate(), tel.rate_trend(), tel.queue_depth(),
                tel.queue_gradient(), tel.utilization(),
                tel.response_quantile(99.0), tel.completions_in_window())
               for tel in tels]
        np.testing.assert_equal(est[0], est[1])
    assert cursors[0] == cursors[1]


def test_telemetry_histogram_fallback_matches_reference(ref):
    """Past ``max_completions`` the quantiles come from the rotating log
    histograms; both packages give the same numbers."""
    rng = np.random.default_rng(0)
    tels = [ref.autoscale.Telemetry(ref.autoscale.TelemetryConfig(
                window=5.0, max_completions=50)),
            t_autoscale.Telemetry(t_autoscale.TelemetryConfig(
                window=5.0, max_completions=50))]
    for i in range(600):
        t, rt, c = 0.02 * i, float(rng.lognormal()), int(rng.integers(2))
        for tel in tels:
            tel.record_completion(t, rt, cls=c)
            if i % 25 == 0:
                tel.record_sample(t, i % 7, 3, 8, 2)
    for q in (50.0, 90.0, 99.0):
        for cls in (None, 0, 1):
            assert tels[0].response_quantile(q, cls) == \
                tels[1].response_quantile(q, cls)


def test_metrics_match_reference(ref):
    rng = np.random.default_rng(1)
    xs = np.concatenate([rng.lognormal(size=500), [0.0, 1e-9, 5e6, np.nan]])
    regs = [ref.obs.MetricsRegistry(), MetricsRegistry()]
    for reg in regs:
        reg.counter("a.count").inc(3)
        reg.gauge("a.level").set(0.25)
        h = reg.histogram("a.resp")
        h.record_many(xs[:300])
        for x in xs[300:]:
            h.record(x)
        other = type(h)(per_decade=40)
        other.record_many(xs[::3])
        h.merge(other)
    snaps = [reg.snapshot() for reg in regs]
    assert snaps[0].as_dict() == snaps[1].as_dict()
    assert snaps[1].diff(snaps[1]) == {}
    with pytest.raises(TypeError, match="already registered"):
        regs[1].gauge("a.count")
    with pytest.raises(ValueError, match="different buckets"):
        LogHistogram().merge(LogHistogram(per_decade=10))


@pytest.mark.parametrize("policy", ["jffc", "priority", "jsq", "sa-jsq", "sed",
                                    "jiq", "jffs", "random"])
def test_dispatch_policies_match_reference(ref, policy):
    """Each of the port's dispatch policies, driven by the JAX package's
    scalar event simulator, makes the reference policy's decisions."""
    from repro.core.simulator import simulate
    from repro_torch.core.load_balance import POLICIES

    rng = random.Random(5)
    arrivals = ref.workload.poisson_exponential(2.4, 400, seed=6)
    arrivals = [a + (rng.randrange(2),) for a in arrivals]
    rates, caps = [1.0, 0.7, 0.4], [2, 2, 3]
    kw = dict(classes=two_classes(PORT), aging_rate=0.01) \
        if policy == "priority" else {}
    results = []
    for table, k in ((ref.core.POLICIES, dict(kw, classes=two_classes(ref))
                      if kw else {}), (POLICIES, kw)):
        pol = table[policy](rates, caps, random.Random(9), **k)
        results.append(simulate(pol, arrivals, warmup_fraction=0.0))
    a, b = results
    assert np.array_equal(a.response_times, b.response_times)
    assert np.array_equal(a.class_ids, b.class_ids)


def test_sim_plane_helpers_match_reference(ref):
    """The composition and membership helpers and result types the port
    keeps for the sim plane: ``compose_or_degrade`` (feasible and degraded
    load), ``_apply_membership`` / ``_effective`` over an event sequence,
    and ``SimResult`` / ``ScenarioResult`` summaries."""
    for lam in (2.0, 400.0):
        out = [ns.scenarios.compose_or_degrade(cluster(ns, 6), service(ns),
                                               lam, 0.7)
               for ns in packages(ref).values()]
        assert out[0] == out[1]
    assert out[1][3], "the 400/s load must degrade"
    views = []
    for ns in packages(ref).values():
        servers = cluster(ns, 6)
        members = {sv.sid: sv for sv in servers}
        tau = {sid: 1.0 for sid in members}
        sc = (ns.core.Scenario(horizon=50.0).slowdown(1.0, "s1", 2.5)
              .fail_group(2.0, ["s2", "s4"]).fail(3.0, "s5")
              .add(4.0, servers[2]))
        shown = [ns.scenarios._apply_membership(members, tau, ev)
                 for ev in sc.cluster_events()]
        views.append((shown, [vars(sv) for sv in
                              ns.scenarios._effective(members, tau)]))
        with pytest.raises(ValueError, match="not a cluster event"):
            ns.scenarios._apply_membership(members, tau, ns.core.ScenarioEvent(
                0.0, "burst", scale=2.0, duration=1.0))
    assert views[0] == views[1]
    rng = np.random.default_rng(3)
    rt, wt = rng.exponential(size=50), rng.exponential(size=50)
    cls = rng.integers(2, size=50)
    summaries = []
    for Result, ScenarioResult in (
            (ref.core.SimResult, ref.scenarios.ScenarioResult),
            (SimResult, t_scenarios.ScenarioResult)):
        res = Result(rt, wt, rt - wt, 50, 60.0, class_ids=cls,
                        n_rejected=3, rejected_class_ids=np.array([1, 1, 0]))
        sres = ScenarioResult(res, [], 53, True, 0, 0, n_rejected=3)
        summaries.append((res.summary(), res.per_class(), sres.p99(),
                          res.mean_occupancy_via_little))
    np.testing.assert_equal(summaries[0], summaries[1])


# ---------------------------------------------------------------------------
# (d) the plane's knobs, and what is not ported
# ---------------------------------------------------------------------------

# tests/test_jax_plane.py:96-122 and tests/test_pipeline.py:293-338
KNOB_ERRORS = {
    "kv-layout": (dict(kv_layout="interleaved"), "plane.kv_layout"),
    "page-size-pow2": (dict(kv_layout="paged", page_size=24), "plane.page_size"),
    "page-size-divides": (dict(kv_layout="paged", page_size=16, max_seq=200),
                          "plane.page_size"),
    "oversubscribe": (dict(kv_layout="paged", oversubscribe=0.5),
                      "plane.oversubscribe"),
    "parallelism": (dict(parallelism="ring"), "plane.parallelism"),
    "microbatches": (dict(parallelism="pipeline", microbatches=0),
                     "plane.microbatches"),
    "pipeline-stages": (dict(parallelism="pipeline", pipeline_stages=0),
                        "plane.pipeline_stages"),
    "single-microbatches": (dict(microbatches=4), "plane.parallelism"),
    "single-stages": (dict(pipeline_stages=2), "plane.parallelism"),
}


@pytest.mark.parametrize("case", list(KNOB_ERRORS))
def test_live_plane_knobs_validate_like_reference(ref, case):
    kw, field = KNOB_ERRORS[case]
    for ns in packages(ref).values():
        with pytest.raises(ns.api.SpecError) as err:
            ns.api.LivePlane(**kw)
        assert err.value.field == field


@pytest.mark.parametrize("kw", [
    {}, dict(kv_layout="paged", page_size=32, oversubscribe=2.0),
    dict(parallelism="pipeline", pipeline_stages=2, microbatches=4)],
    ids=["default", "paged", "pipeline"])
def test_live_plane_store_key_and_round_trip(ref, kw):
    plane = api.LivePlane(**kw)
    assert plane.store_key() == ref.api.LivePlane(**kw).store_key()
    assert plane.to_dict() == ref.api.LivePlane(**kw).to_dict()
    back = api.LivePlane.from_dict(json.loads(json.dumps(plane.to_dict())))
    assert back.to_dict() == plane.to_dict()
    assert back.store_key() == plane.store_key()
    assert plane.store_key() != api.LivePlane(dt=0.25, **kw).store_key()
    with pytest.raises(api.SpecError, match="unknown"):
        api.LivePlane.from_dict({"plane": "live", "kv_format": "paged"})


def test_torch_engine_needs_model_and_params():
    with pytest.raises(ValueError, match="model"):
        api.LivePlane(engine="torch")
    with pytest.raises(ValueError, match="'mock' or 'torch'"):
        api.LivePlane(engine="jax")
    plane = api.LivePlane(engine="torch", model=object(), params={})
    assert plane.store_key() is None
    assert plane.to_dict()["engine"] == "torch"


def test_pipeline_needs_the_torch_engine():
    with pytest.raises(api.SpecError, match="engine='torch'"):
        api.run(spec_fail_recover(PORT),
                plane=api.LivePlane(parallelism="pipeline"))


def test_live_plane_rejects_unimplemented_policies():
    spec = spec_fail_recover(PORT).replace(policy=api.PolicySpec(name="sed"))
    with pytest.raises(api.SpecError, match="policy.name"):
        api.run(spec, plane=api.LivePlane())


@pytest.mark.parametrize("call, error, match", [
    (lambda s: api.run(s), api.SpecError, "sim plane.*ROADMAP"),
    (lambda s: api.run(s, plane="sim"), api.SpecError, "sim plane.*ROADMAP"),
    (lambda s: api.run(s, plane="live", store=object()), api.SpecError,
     "results store.*ROADMAP"),
    (lambda s: api.run(s, plane=api.LivePlane(), trace=True),
     NotImplementedError, "flight recorder.*ROADMAP"),
    (lambda s: api.run(s.to_dict(), plane="live"), api.SpecError,
     "ExperimentSpec"),
    (lambda s: api.run(s, plane="nope"), api.UnknownNameError, "live"),
    (lambda s: api.run(s, plane=3), api.SpecError, "plane"),
], ids=["default-plane", "sim", "store", "trace", "not-a-spec",
        "unknown-plane", "not-a-plane"])
def test_what_is_not_ported_raises(call, error, match):
    with pytest.raises(error, match=match):
        call(spec_fail_recover(PORT))


def test_registries_write_through_to_core():
    from repro_torch.core.load_balance import POLICIES
    from repro_torch.core.tuning import TUNERS

    api.DISPATCH_POLICIES.register("jffc-copy", POLICIES["jffc"])
    api.TUNERS.register("bound-copy", TUNERS["bound-lower"])
    try:
        assert POLICIES["jffc-copy"] is POLICIES["jffc"]
        spec = spec_fail_recover(PORT).replace(
            cluster=api.ClusterSpec(servers=cluster(PORT, 6),
                                    service=service(PORT), tuner="bound-copy"))
        assert api.run(spec, plane="live").completed_all
    finally:
        del POLICIES["jffc-copy"], TUNERS["bound-copy"]
        api.DISPATCH_POLICIES._entries.pop("jffc-copy")
        api.TUNERS._entries.pop("bound-copy")
    assert api.PLANES.names() == ("live",)

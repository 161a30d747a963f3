"""The port's pipeline-parallel chain engine, on the CPU at float32.

Held inside the port (pipeline streams equal the monolithic engines' at
every stage count and microbatch count; stage views share the accounting;
the per-stage s_c grants sum exactly) and against the JAX package (stage
plans, stage devices, ``LayerSlice`` hidden states, pipeline engine and
orchestrator streams), on a 4-layer reduced stablelm-1.6b with vocab 128
and a 2-hop chain ``(2, 2)``, weights from the JAX ``Model.init`` through
``params_from_jax``.

JAX is imported by a fixture, so the ``gpu``-marked case (the dense decode
kernel's ``rows`` addressing against the kernel on gathered rows) also
collects on a machine that has the card but no JAX.
"""
import itertools
import types
from functools import partial

import numpy as np
import pytest
import torch

from repro_torch.configs import get
from repro_torch.core import Chain, Server
from repro_torch.distributed import stage_devices
from repro_torch.kernels import ops, ref
from repro_torch.launch import serve
from repro_torch.models import Model, params_from_jax
from repro_torch.serving import (
    ChainEngine,
    Orchestrator,
    OrchestratorConfig,
    PageAccounting,
    PagedCache,
    PagedChainEngine,
    PipelineChainEngine,
    Request,
    SlotCache,
    State,
    plan_stages,
    service_spec_for,
)

OVERRIDES = dict(num_layers=4, vocab_size=128, attn_chunk_threshold=1 << 30,
                 dtype="float32")
HIDDEN_TOL = dict(rtol=1e-4, atol=1e-4)       # tests/test_torch_models.py
# (kv_layout, num_stages, microbatches): one stage per hop, hops merged,
# and hops split inside
CONFIGS = [("paged", None, 1), ("paged", 2, 4), ("slotted", 4, 2)]


@pytest.fixture(scope="module")
def jx():
    jax = pytest.importorskip("jax")
    from repro.configs import get as jget
    from repro.core import Server as JServer
    from repro.core.chains import Chain as JChain
    from repro.distributed import stage_devices as j_stage_devices
    from repro.models import Model as JModel
    from repro.serving import (
        Orchestrator as JOrchestrator,
        OrchestratorConfig as JOrchestratorConfig,
        PipelineChainEngine as JPipelineChainEngine,
        Request as JRequest,
        plan_stages as j_plan_stages,
        service_spec_for as j_service_spec_for,
    )
    from repro.serving.kv_cache import PageAccounting as JPageAccounting
    return types.SimpleNamespace(
        jax=jax, jnp=jax.numpy, get=jget, Server=JServer, Chain=JChain,
        stage_devices=j_stage_devices, Model=JModel,
        Orchestrator=JOrchestrator, OrchestratorConfig=JOrchestratorConfig,
        Pipeline=JPipelineChainEngine, Request=JRequest,
        plan_stages=j_plan_stages, service_spec_for=j_service_spec_for,
        PageAccounting=JPageAccounting)


@pytest.fixture(scope="module")
def tiny4(jx):
    """4-layer reduced model in both packages with the same weights, and a
    2-hop chain (2 blocks per hop)."""
    torch.backends.cuda.matmul.allow_tf32 = False    # float32 parity
    torch.backends.cudnn.allow_tf32 = False
    jcfg = jx.get("stablelm-1.6b").reduced(**OVERRIDES)
    cfg = get("stablelm-1.6b").reduced(**OVERRIDES)
    jmodel = jx.Model(jcfg)
    jparams = jmodel.init(jx.jax.random.PRNGKey(0))
    model = Model(cfg, device="cpu")
    params = params_from_jax(jx.jax.tree.map(np.asarray, jparams), cfg, "cpu")
    return types.SimpleNamespace(
        cfg=cfg, model=model, params=params, jmodel=jmodel, jparams=jparams,
        chain=Chain(("s0", "s1"), (2, 2), 1.0),
        jchain=jx.Chain(("s0", "s1"), (2, 2), 1.0))


def _prompt(rid, prompt_len, seed=0):
    rng = np.random.default_rng(seed + rid)
    return rng.integers(1, 100, prompt_len).astype(np.int32)


def _reqs(cls=Request, seed=0, n=5):
    # mixed non-pow2 prompts (boundary fixup) + enough decode to cross a
    # page boundary; more requests than capacity staggers admissions
    return [cls(rid=i, prompt=_prompt(i, 5 + 7 * i, seed),
                max_new_tokens=12 + 4 * (i % 3)) for i in range(n)]


def _drain(eng, reqs):
    pending = list(reqs)
    while pending or eng.requests:
        while pending and eng.has_free_slot and eng.admit(pending[0]):
            pending.pop(0)
        eng.step()
    return [list(r.output) for r in reqs]


def _mono(t, layout, capacity=4, max_seq=128, **kw):
    cls = ChainEngine if layout == "slotted" else PagedChainEngine
    return cls(t.model, t.params, t.chain, capacity, max_seq, **kw)


def _pipe(t, layout, stages=None, micro=1, capacity=4, max_seq=128, **kw):
    return PipelineChainEngine(t.model, t.params, t.chain, capacity, max_seq,
                               kv_layout=layout, num_stages=stages,
                               microbatches=micro, **kw)


# ---------------------------------------------------------------------------
# Planning and devices
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("hops", [1, 2, 3, 4])
def test_plan_stages_matches_reference(jx, hops):
    """Every block list of ``hops`` hops with 1-6 blocks each, at 1-10
    stages: the same ranges and hop sets as the JAX plan."""
    for blocks in itertools.product(range(1, 7), repeat=hops):
        for S in range(1, 11):
            got = [(s.index, s.lo, s.hi, s.hops) for s in plan_stages(blocks, S)]
            want = [(s.index, s.lo, s.hi, s.hops)
                    for s in jx.plan_stages(blocks, S)]
            assert got == want, (blocks, S)
    with pytest.raises(ValueError, match="positive"):
        plan_stages([2, 0], 2)


def test_stage_devices_round_robin_matches_reference(jx):
    devs = ["d0", "d1", "d2"]
    for n in range(1, 8):
        assert stage_devices(n, devs) == jx.stage_devices(n, devs)
    assert stage_devices(3, ["d0"]) == ["d0"] * 3
    # a model on the CPU places every stage on the CPU
    assert stage_devices(3, model_device="cpu") == [torch.device("cpu")] * 3
    with pytest.raises(ValueError, match="num_stages"):
        stage_devices(0, devs)


@pytest.mark.parametrize("blocks", [(2, 2), (31, 5), (12, 12, 12), (36,)])
def test_stage_grants_conserve_s_c_exactly(jx, blocks):
    """The per-stage grants of PageAccounting.split over each stage plan
    sum to the paper's s_c bit for bit, and equal the JAX split."""
    spec = service_spec_for(get("qwen3-8b"), max_seq=1024)
    acct = PageAccounting.from_spec(spec, max_seq=1024)
    jacct = jx.PageAccounting.from_spec(
        jx.service_spec_for(jx.get("qwen3-8b"), max_seq=1024), max_seq=1024)
    for S in range(1, 7):
        counts = [sp.num_layers for sp in plan_stages(blocks, S)]
        grants = [g.slot_gb for g in acct.split(counts)]
        assert grants == [g.slot_gb for g in jacct.split(counts)]
        total = 0.0
        for g in grants:
            total += g
        assert total == acct.slot_gb


# ---------------------------------------------------------------------------
# Layer slices and stage caches
# ---------------------------------------------------------------------------

CUTS = [(0, 4), (0, 1, 4), (0, 2, 4), (0, 3, 4), (0, 1, 2, 3, 4)]


@pytest.mark.parametrize("cuts", CUTS, ids=lambda c: "-".join(map(str, c)))
def test_slices_compose_to_model_bitwise(tiny4, cuts):
    """embed -> LayerSlices -> logits equals Model.prefill, decode_step and
    decode_step_paged bit for bit, caches included."""
    model, params = tiny4.model, tiny4.params
    slices = [model.layer_slice(lo, hi) for lo, hi in zip(cuts, cuts[1:])]
    sparams = [sl.slice_params(params) for sl in slices]
    rng = np.random.default_rng(1)
    toks = torch.from_numpy(rng.integers(1, 128, (2, 13)).astype(np.int32))
    tok = torch.tensor([5, 9], dtype=torch.int32)
    lengths = torch.tensor([13, 13], dtype=torch.int32)

    cache = model.init_cache(2, 32)
    want_last, _ = model.prefill(params, cache, {"tokens": toks})
    want_dec, _ = model.decode_step(params, cache, tok, lengths)
    caches = [sl.init_cache(2, 32) for sl in slices]
    x = model.embed_inputs(params, {"tokens": toks})
    for sl, p, c in zip(slices, sparams, caches):
        x = sl.seq_blocks(p, c, x)
    assert torch.equal(model.logits(params, x[:, -1]), want_last)
    x = model.embed_tokens(params, tok)
    for sl, p, c in zip(slices, sparams, caches):
        x = sl.decode_blocks(p, c, x, lengths)
    assert torch.equal(model.logits(params, x), want_dec)
    for name in ("k", "v"):
        assert torch.equal(torch.cat([c[0][name] for c in caches]), cache[0][name])

    # paged: row b's first 32 positions laid out on pages 2b and 2b + 1
    def to_pages(dense, pools):
        for stage, pool in zip(dense, pools):
            for name, leaf in pool.items():
                src = stage[name][:, :, :32]
                leaf[:, :4] = src.reshape(src.shape[0], 4, 16, *src.shape[3:])
        return pools

    pools = to_pages(cache, model.init_cache(5, 16))
    stage_pools = [to_pages(c, sl.init_cache(5, 16))
                   for c, sl in zip(caches, slices)]
    table = torch.tensor([[0, 1], [2, 3]], dtype=torch.int32)
    wp, wo = torch.tensor([0, 2]), torch.tensor([14, 14])
    ln = torch.tensor([14, 14], dtype=torch.int32)
    want = model.decode_step_paged(params, pools, tok, ln, table, wp, wo)
    x = model.embed_tokens(params, tok)
    for sl, p, c in zip(slices, sparams, stage_pools):
        x = sl.decode_blocks_paged(p, c, x, ln, table, wp, wo)
    assert torch.equal(model.logits(params, x), want)


def test_slice_params_share_the_model_tensors(tiny4):
    sl = tiny4.model.layer_slice(1, 3)
    p = sl.slice_params(tiny4.params)
    assert len(p["layers"]) == 2
    assert p["layers"][0]["wq"] is tiny4.params["layers"][1]["wq"]
    assert p["embed"] is tiny4.params["embed"]
    assert sl.slice_params(tiny4.params, "cpu")["embed"] is tiny4.params["embed"]
    with pytest.raises(ValueError, match="outside"):
        tiny4.model.layer_slice(2, 5)


@pytest.mark.parametrize("lo,hi", [(0, 4), (0, 2), (1, 3), (3, 4)])
def test_layer_slice_hidden_states_match_reference(jx, tiny4, lo, hi):
    """seq_blocks and decode_blocks hidden states of the port's LayerSlice
    against the JAX LayerSlice's on the same inputs."""
    jnp = jx.jnp
    rng = np.random.default_rng(2)
    D = tiny4.cfg.d_model
    x = rng.standard_normal((2, 11, D)).astype(np.float32)
    xt = rng.standard_normal((2, D)).astype(np.float32)
    lengths = np.array([11, 7], np.int32)

    jsl = tiny4.jmodel.layer_slice(lo, hi)
    jp = jsl.slice_params(tiny4.jparams)
    jy, jcache = jsl.seq_blocks(jp, jsl.init_cache(2, 16), jnp.asarray(x))
    jd, _ = jsl.decode_blocks(jp, jcache, jnp.asarray(xt), jnp.asarray(lengths))

    sl = tiny4.model.layer_slice(lo, hi)
    p = sl.slice_params(tiny4.params)
    cache = sl.init_cache(2, 16)
    y = sl.seq_blocks(p, cache, torch.from_numpy(x))
    d = sl.decode_blocks(p, cache, torch.from_numpy(xt), torch.from_numpy(lengths))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **HIDDEN_TOL)
    np.testing.assert_allclose(d.numpy(), np.asarray(jd), **HIDDEN_TOL)


@pytest.mark.parametrize("layout", ["slotted", "paged"])
def test_leaf_range_views_share_accounting(tiny4, layout):
    """Stage views hold only their layers' leaves (bytes summing to the
    monolithic cache's) and share the master's accounting by reference."""
    model = tiny4.model
    cuts = [(0, 1), (1, 4)]
    if layout == "slotted":
        full = SlotCache(model, 3, 32)
        master = SlotCache(model, 3, 32, materialize=False)
        assert master.cache is None
    else:
        full = PagedCache(model, 3, 32, page_size=16, total_pages=5)
        master = PagedCache(model, 3, 32, page_size=16, total_pages=5,
                            materialize=False)
        assert master.pools is None
    views = [master.leaf_range(model.layer_slice(lo, hi), device="cpu")
             for lo, hi in cuts]
    leaves = lambda c: c.cache if layout == "slotted" else c.pools  # noqa: E731
    for view, (lo, hi) in zip(views, cuts):
        assert view.free is master.free and view._active is master._active
        assert view.lengths is master.lengths
        if layout == "paged":
            assert view.block_table is master.block_table
            assert view.pages_used is master.pages_used
            assert view._free_pages is master._free_pages
        assert all(leaf.shape[0] == hi - lo
                   for stage in leaves(view) for leaf in stage.values())
    nbytes = lambda c: sum(leaf.numel() * leaf.element_size()  # noqa: E731
                           for stage in leaves(c) for leaf in stage.values())
    assert sum(nbytes(v) for v in views) == nbytes(full)
    slot = master.acquire() if layout == "slotted" else master.acquire(20)
    master.lengths[slot] = 20
    assert all(v.lengths[slot] == 20 and slot not in v.free for v in views)
    if layout == "paged":
        assert views[1].free_pages == 3 and views[1].block_table[slot, 1] >= 0
    views[0].release(slot)
    assert slot in master.free and master.lengths[slot] == 0


# ---------------------------------------------------------------------------
# Engines, inside the port
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("layout", ["slotted", "paged"])
def test_single_stage_matches_monolithic(tiny4, layout):
    pipe = _pipe(tiny4, layout, stages=1)
    assert pipe.num_stages == 1
    assert _drain(_mono(tiny4, layout), _reqs()) == _drain(pipe, _reqs())


@pytest.mark.parametrize("layout,stages,micro", CONFIGS)
def test_multistage_matches_monolithic(tiny4, layout, stages, micro):
    """Cutting the stack at hidden-state boundaries and regrouping rows
    into microbatches never changes the greedy streams, which equal both
    monolithic engines'."""
    pipe = _pipe(tiny4, layout, stages, micro)
    assert pipe.num_stages == (len(tiny4.chain.blocks) if stages is None
                               else stages)
    want = _drain(_mono(tiny4, layout), _reqs(seed=3))
    other = "paged" if layout == "slotted" else "slotted"
    assert _drain(_mono(tiny4, other), _reqs(seed=3)) == want
    assert _drain(pipe, _reqs(seed=3)) == want


@pytest.mark.parametrize("layout", ["slotted", "paged"])
def test_microbatch_count_is_stream_invariant(tiny4, layout):
    outs = [_drain(_pipe(tiny4, layout, micro=m), _reqs(seed=7)) for m in (1, 4)]
    assert outs[0] == outs[1]


def test_pipeline_preemption_parity(tiny4):
    """Page exhaustion preempts the same victims in the same order as
    PagedChainEngine, and resubmission completes with identical streams."""
    def run(eng):
        reqs = [Request(rid=i, prompt=_prompt(i, 30), max_new_tokens=40)
                for i in range(3)]
        for r in reqs:
            assert eng.admit(r)
        preempted = []
        while eng.requests:
            eng.step()
            preempted += eng.take_preempted()
        order = [r.rid for r in preempted]
        for r in preempted:
            assert r.state == State.QUEUED and r.retries == 1
            eng.admit(r)
            while eng.requests:
                eng.step()
        return order, [list(r.output) for r in reqs]

    mono = run(_mono(tiny4, "paged", capacity=1, oversubscribe=3.0))
    pipe = run(_pipe(tiny4, "paged", micro=2, capacity=1, oversubscribe=3.0))
    assert mono == pipe
    assert mono[0], "pool pressure must preempt"


def test_pipeline_free_pages_surface(tiny4):
    """Paged pipelines report the shared pool; slotted ones raise
    AttributeError so the orchestrator's hasattr() gauge filter skips
    them.  evict_all returns every page."""
    paged = _pipe(tiny4, "paged", capacity=2, max_seq=64)
    total = paged.free_pages
    r = Request(rid=0, prompt=_prompt(0, 20), max_new_tokens=50)
    assert paged.admit(r)
    assert paged.free_pages < total
    assert [q.rid for q in paged.evict_all()] == [0]
    assert paged.free_pages == total
    assert not hasattr(_pipe(tiny4, "slotted", capacity=2, max_seq=64),
                       "free_pages")


def test_wavefront_schedule_and_stage_placement(tiny4):
    """trace_schedule records the 1F wavefront (stage k runs microbatch
    t - k); a CPU model places every stage on the CPU; kv_bytes sums the
    stages' leaves."""
    pipe = _pipe(tiny4, "slotted", stages=2, micro=2, trace_schedule=True)
    assert pipe.devices == [torch.device("cpu")] * 2
    assert pipe.kv_bytes == SlotCache(tiny4.model, 4, 128).cache[0]["k"].numel() * 8
    _drain(pipe, _reqs(n=4))
    assert pipe.stage_schedule
    assert all(e["ubatch"] == e["tick"] - e["stage"] for e in pipe.stage_schedule)
    assert {e["n_ticks"] for e in pipe.stage_schedule} <= {2, 3}


# ---------------------------------------------------------------------------
# Engines and orchestrator, against the JAX package
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("layout,stages,micro", CONFIGS)
def test_multistage_matches_reference(jx, tiny4, layout, stages, micro):
    """The port's pipeline streams equal the JAX PipelineChainEngine's for
    the same weights and requests."""
    jpipe = jx.Pipeline(tiny4.jmodel, tiny4.jparams, tiny4.jchain, 2, 64,
                        kv_layout=layout, num_stages=stages, microbatches=micro)
    pipe = _pipe(tiny4, layout, stages, micro, capacity=2, max_seq=64)
    want = _drain(jpipe, _reqs(jx.Request, seed=5, n=3))
    assert _drain(pipe, _reqs(Request, seed=5, n=3)) == want


def test_orchestrator_failover_matches_reference(jx, tiny4):
    """Pipeline engine factories behind both packages' orchestrators, with
    a server failed mid-run: equal per-request outputs, retries, chains
    and simulated finish times."""
    cfg = tiny4.cfg
    spec = service_spec_for(cfg, max_seq=64)
    mem = spec.block_size_gb * 2 + spec.cache_size_gb * 2 * 4
    coeffs = [(f"s{i}", mem, 0.05, 0.02 * (1 + i % 2)) for i in range(4)]
    port = Orchestrator(
        [Server(*c) for c in coeffs], spec, tiny4.model, tiny4.params, 0.5,
        OrchestratorConfig(max_seq=64, engine_factory=partial(
            PipelineChainEngine, kv_layout="paged", microbatches=2)))
    ref_orch = jx.Orchestrator(
        [jx.Server(*c) for c in coeffs],
        jx.service_spec_for(tiny4.jmodel.cfg, max_seq=64),
        tiny4.jmodel, tiny4.jparams, 0.5,
        jx.OrchestratorConfig(max_seq=64, engine_factory=partial(
            jx.Pipeline, kv_layout="paged", microbatches=2)))
    layout = lambda o: [(list(e.chain.servers), list(e.chain.blocks), e.capacity)  # noqa: E731
                        for e in o.engines]
    assert layout(port) == layout(ref_orch)
    assert any(len(e.chain.blocks) > 1 for e in port.engines)
    runs = []
    for orch, cls in ((port, Request), (ref_orch, jx.Request)):
        reqs = [cls(rid=i, prompt=_prompt(i, 6 + 5 * (i % 3)), max_new_tokens=6)
                for i in range(6)]
        for r in reqs:
            orch.submit(r)
        orch.step()
        orch.step()
        requeued = orch.fail_server(orch.engines[0].chain.servers[0])
        chains = layout(orch)
        orch.drain()
        assert all(r.state.value == "done" for r in reqs)
        runs.append((requeued, chains, [r.output for r in reqs],
                     [r.retries for r in reqs], [r.finish_time for r in reqs]))
    assert runs[0] == runs[1]
    assert runs[0][0] > 0, "the failed server must carry requests"


@pytest.mark.parametrize("extra", [
    ["--kv-layout", "slotted", "--pipeline-stages", "4", "--microbatches", "2"],
    ["--kv-layout", "paged", "--microbatches", "2", "--fail-after", "3"],
], ids=["slotted-4-stages", "paged-fail-after"])
def test_serve_entry_point_runs_pipeline(capsys, extra):
    summary = serve.main(["--reduced", "--device", "cpu", "--parallelism",
                          "pipeline", "--requests", "4", "--max-new", "4",
                          "--prompt-len", "8", "--prompt-len-max", "20",
                          "--max-seq", "64", "--rate", "4"] + extra)
    assert summary["finished"] == summary["requests"] == 4
    assert summary["generated_tokens"] == 16
    out = capsys.readouterr().out
    assert "stages=[0," in out
    if "--fail-after" in extra:
        assert summary["failed_at_round"] == 3
        assert "re-queued, recomposed to" in out


def test_pipeline_options_need_pipeline_parallelism():
    with pytest.raises(ValueError, match="parallelism"):
        serve.engine_factory("slotted", "single", microbatches=2)
    with pytest.raises(ValueError, match="parallelism"):
        serve.engine_factory("slotted", "ring")
    factory = serve.engine_factory("paged", "pipeline", 3, 2)
    assert factory.func is PipelineChainEngine
    assert factory.keywords == dict(kv_layout="paged", num_stages=3,
                                    microbatches=2)


# ---------------------------------------------------------------------------
# The rows addressing of the dense decode
# ---------------------------------------------------------------------------

def _rows_inputs(seed, dtype, device="cpu"):
    rng = np.random.default_rng(seed)
    R, B, S, H, KV, hd = 7, 5, 300, 8, 2, 64
    q = rng.standard_normal((B, H, hd), np.float32)
    k = rng.standard_normal((R, S, KV, hd), np.float32)
    v = rng.standard_normal((R, S, KV, hd), np.float32)
    rows = np.array([4, 0, 6, 4, 2], np.int32)          # a repeat, as pad rows
    lengths = np.array([300, 1, 129, 300, 77], np.int32)
    t = lambda a: torch.from_numpy(a).to(device)  # noqa: E731
    return (t(q).to(dtype), t(k).to(dtype), t(v).to(dtype), t(lengths), t(rows))


def test_decode_ref_rows_equals_gathered_rows():
    q, k, v, lengths, rows = _rows_inputs(0, torch.float32)
    got = ref.decode_attention_ref(q, k, v, lengths, rows)
    idx = rows.long()
    assert torch.equal(got, ref.decode_attention_ref(q, k[idx], v[idx], lengths))
    assert torch.equal(ops.decode_attention(q, k, v, lengths, rows), got)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_decode_rows_bit_equal_gathered(dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    q, k, v, lengths, rows = _rows_inputs(1, dtype, "cuda")
    before = ops.LAUNCHES["decode_attention"]
    got = ops.decode_attention(q, k, v, lengths, rows)
    idx = rows.long()
    want = ops.decode_attention(q, k[idx].contiguous(), v[idx].contiguous(), lengths)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["decode_attention"] == before + 2
    assert torch.equal(got, want)

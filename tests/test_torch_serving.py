"""The port's serving path against the JAX package's, on the CPU at float32.

The same weights (JAX ``Model.init`` through ``params_from_jax``) and the
same requests go through both packages' KV caches, chain engines and
orchestrators; greedy token streams must be equal, and equal to the
re-run-everything greedy oracle.
"""
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get as jget
from repro.core.chains import Chain as JChain
from repro.core import Server as JServer
from repro.models import Model as JModel
from repro.serving import (
    ChainEngine as JChainEngine,
    Orchestrator as JOrchestrator,
    OrchestratorConfig as JOrchestratorConfig,
    PagedChainEngine as JPagedChainEngine,
    Request as JRequest,
    service_spec_for as j_service_spec_for,
)
from repro.serving.kv_cache import PageAccounting as JPageAccounting
from repro.serving.kv_cache import PagedCache as JPagedCache
from repro_torch.configs import get
from repro_torch.core import Chain, Server
from repro_torch.models import Model, params_from_jax
from repro_torch.serving import (
    ChainEngine,
    Orchestrator,
    OrchestratorConfig,
    PageAccounting,
    PagedCache,
    PagedChainEngine,
    Request,
    State,
    service_spec_for,
)

OVERRIDES = dict(num_layers=2, vocab_size=128, attn_chunk_threshold=1 << 30,
                 dtype="float32")


@pytest.fixture(scope="module")
def tiny():
    torch.backends.cuda.matmul.allow_tf32 = False    # float32 parity
    torch.backends.cudnn.allow_tf32 = False
    jcfg = jget("stablelm-1.6b").reduced(**OVERRIDES)
    cfg = get("stablelm-1.6b").reduced(**OVERRIDES)
    jmodel = JModel(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    model = Model(cfg, device="cpu")
    params = params_from_jax(jax.tree.map(np.asarray, jparams), cfg, "cpu")
    return cfg, model, params, jmodel, jparams


def greedy_rollout(model, params, prompt, n_new):
    """Oracle: re-run the full forward for every generated token."""
    toks = list(prompt)
    for _ in range(n_new):
        logits = model.forward_train(params, {"tokens": torch.tensor([toks])})
        toks.append(int(torch.argmax(logits[0, -1])))
    return toks[len(prompt):]


def jax_greedy_rollout(model, params, prompt, n_new):
    """The JAX package's oracle (tests/test_serving.py), on its own model."""
    toks = list(prompt)
    for _ in range(n_new):
        logits = model.forward_train(params, {"tokens": jnp.asarray([toks])})
        toks.append(int(jnp.argmax(logits[0, -1])))
    return toks[len(prompt):]


def _prompt(rid, prompt_len, seed=0):
    rng = np.random.default_rng(seed + rid)
    return rng.integers(1, 100, prompt_len).astype(np.int32)


def _reqs(cls, specs, seed=0):
    return [cls(rid=i, prompt=_prompt(i, plen, seed), max_new_tokens=n)
            for i, (plen, n) in enumerate(specs)]


def _engines(tiny, kind, capacity, max_seq, **kw):
    cfg, model, params, jmodel, jparams = tiny
    chain = (cfg.num_layers,)
    port = {"slotted": ChainEngine, "paged": PagedChainEngine}[kind]
    ref = {"slotted": JChainEngine, "paged": JPagedChainEngine}[kind]
    return (port(model, params, Chain(("s0",), chain, 1.0), capacity, max_seq, **kw),
            ref(jmodel, jparams, JChain(("s0",), chain, 1.0), capacity, max_seq, **kw))


def test_page_accounting_matches_reference():
    """pages <-> s_c is exact, and the port's floats are the reference's."""
    spec = service_spec_for(get("qwen3-8b"), max_seq=4096)
    jspec = j_service_spec_for(jget("qwen3-8b"), max_seq=4096)
    assert (spec.num_blocks, spec.block_size_gb, spec.cache_size_gb) == \
        (jspec.num_blocks, jspec.block_size_gb, jspec.cache_size_gb)
    acct = PageAccounting.from_spec(spec, max_seq=4096)
    jacct = JPageAccounting.from_spec(jspec, max_seq=4096)
    assert acct.gb_for_pages(acct.pages_per_slot) == spec.cache_size_gb
    for pages in (1, 7, acct.pages_per_slot, acct.pages_for_slots(3)):
        assert acct.gb_for_pages(pages) == jacct.gb_for_pages(pages)
    for counts in ([12, 12, 12], [5, 31], [1, 2, 3, 30]):
        grants = [g.slot_gb for g in acct.split(counts)]
        assert grants == [g.slot_gb for g in jacct.split(counts)]
        total = 0.0
        for g in grants:
            total += g
        assert total == acct.slot_gb


def test_paged_cache_accounting_matches_reference(tiny):
    """The same admit / decode-write / release sequence leaves the same
    block tables, page counts, lengths and free stacks."""
    cfg, model, params, jmodel, jparams = tiny
    port = PagedCache(model, num_slots=4, max_seq=64, page_size=16,
                      total_pages=10)
    ref = JPagedCache(jmodel, num_slots=4, max_seq=64, page_size=16,
                      total_pages=10)
    script = [("acquire", 20), ("acquire", 33), ("write", 0), ("acquire", 5),
              ("release", 1), ("acquire", 40), ("write", 1), ("release", 0),
              ("acquire", 15), ("write", 2)]
    slots = []
    for op, arg in script:
        if op == "acquire":
            a, b = port.acquire(arg), ref.acquire(arg)
            assert a == b
            if a is not None:
                port.lengths[a] = ref.lengths[b] = arg
                slots.append(a)
        elif op == "write":
            s = slots[arg]
            port.lengths[s] = ref.lengths[s] = (port.lengths[s] // 16 + 1) * 16
            assert port.ensure_decode_write(s) == ref.ensure_decode_write(s)
        else:
            port.release(slots[arg])
            ref.release(slots[arg])
        np.testing.assert_array_equal(port.block_table, ref.block_table)
        np.testing.assert_array_equal(port.pages_used, ref.pages_used)
        np.testing.assert_array_equal(port.lengths, ref.lengths)
        assert port._free_pages == ref._free_pages
        assert port.free == ref.free


@pytest.mark.parametrize("kind", ["slotted", "paged"])
def test_engine_streams_match_reference_and_oracle(tiny, kind):
    """Non-power-of-two prompts exercise the boundary fixup; 40 new tokens
    cross page boundaries (page 16) during decode."""
    cfg, model, params, jmodel, jparams = tiny
    port, ref = _engines(tiny, kind, capacity=3, max_seq=128)
    specs = [(8 + 3 * i, 40) for i in range(3)]
    outs = []
    for eng, cls in ((port, Request), (ref, JRequest)):
        reqs = _reqs(cls, specs)
        for r in reqs:
            assert eng.admit(r)
        while eng.requests:
            eng.step()
        outs.append([r.output for r in reqs])
    assert outs[0] == outs[1]
    for (plen, n), out, rid in zip(specs, outs[0], range(3)):
        assert out == greedy_rollout(model, params, _prompt(rid, plen), n)


def test_slotted_equals_paged_in_port(tiny):
    """Staggered admissions: the paged engine batches different shapes
    round to round, yet its streams equal the slotted engine's."""
    cfg, model, params, _, _ = tiny
    chain = Chain(("s0",), (cfg.num_layers,), 1.0)
    outs = {}
    for name, factory in (("slotted", ChainEngine), ("paged", PagedChainEngine)):
        eng = factory(model, params, chain, 4, 128)
        reqs = _reqs(Request, [(5 + 7 * i, 25) for i in range(7)], seed=3)
        pending = list(reqs)
        while pending or eng.requests:
            while pending and eng.has_free_slot and eng.admit(pending[0]):
                pending.pop(0)
            eng.step()
        outs[name] = [r.output for r in reqs]
    assert outs["slotted"] == outs["paged"]


def test_preemption_picks_reference_victims(tiny):
    """Page exhaustion during decode preempts the youngest request, in the
    reference's order; resubmitted, every stream equals the oracle's."""
    cfg, model, params, _, _ = tiny
    port, ref = _engines(tiny, "paged", capacity=1, max_seq=128,
                         oversubscribe=3.0)
    victims, outs = [], []
    for eng, cls in ((port, Request), (ref, JRequest)):
        reqs = _reqs(cls, [(30, 40)] * 3)
        for r in reqs:
            assert eng.admit(r)
        order = []
        while eng.requests:
            eng.step()
            order += [r.rid for r in eng.take_preempted()]
        assert order and 0 not in order           # the oldest is never the victim
        for rid in order:
            eng.admit(reqs[rid])
            while eng.requests:
                eng.step()
        victims.append(order)
        outs.append([r.output for r in reqs])
    assert victims[0] == victims[1]
    assert outs[0] == outs[1]
    for rid, out in enumerate(outs[0]):
        assert out == greedy_rollout(model, params, _prompt(rid, 30), 40)


def test_pool_exhaustion_defers_admission_at_float32(tiny):
    """Oversubscribed slots + a drained page pool: admit refuses instead of
    corrupting; released pages make the request admissible.  (The JAX
    package's bfloat16 version of this test trips on an exact tie in its
    oracle's logits; at float32 the streams are well separated.)"""
    cfg, model, params, _, _ = tiny
    port, _ = _engines(tiny, "paged", capacity=2, max_seq=128, oversubscribe=3.0)
    # budget: 2 slots * 8 pages = 16 pages over 6 slots; each 50-token
    # prompt takes 4 pages, so the 5th admission finds slots but no pages
    reqs = _reqs(Request, [(50, 2)] * 5)
    assert [port.admit(r) for r in reqs] == [True, True, True, True, False]
    assert port.has_free_slot
    assert reqs[4].state == State.QUEUED
    while port.requests:
        port.step()
    assert port.admit(reqs[4])
    while port.requests:
        port.step()
    for rid, r in enumerate(reqs):
        assert r.output == greedy_rollout(model, params, _prompt(rid, 50), 2)


@pytest.mark.parametrize("kind", ["slotted", "paged"])
def test_orchestrator_matches_reference(tiny, kind):
    """Same servers, same max_seq, same requests: equal per-request outputs,
    completion counts and simulated finish times."""
    cfg, model, params, jmodel, jparams = tiny
    spec = service_spec_for(cfg, max_seq=128)
    mem = spec.block_size_gb * cfg.num_layers + spec.cache_size_gb * cfg.num_layers * 6
    coeffs = [(f"s{i}", mem, 0.05, 0.02 * (1 + i % 2)) for i in range(4)]
    port = Orchestrator(
        [Server(*c) for c in coeffs], spec, model, params, 0.5,
        OrchestratorConfig(max_seq=128, engine_factory=(
            ChainEngine if kind == "slotted" else PagedChainEngine)))
    ref = JOrchestrator(
        [JServer(*c) for c in coeffs], j_service_spec_for(jmodel.cfg, max_seq=128),
        jmodel, jparams, 0.5,
        JOrchestratorConfig(max_seq=128, engine_factory=(
            JChainEngine if kind == "slotted" else partial(JPagedChainEngine))))
    assert [(list(e.chain.servers), e.capacity) for e in port.engines] == \
        [(list(e.chain.servers), e.capacity) for e in ref.engines]
    runs = []
    for orch, cls in ((port, Request), (ref, JRequest)):
        reqs = _reqs(cls, [(8 + 5 * (i % 3), 6) for i in range(10)])
        for r in reqs:
            orch.submit(r)
        orch.drain()
        assert all(r.state.value == "done" for r in reqs)
        runs.append(([r.output for r in reqs], [r.finish_time for r in reqs],
                     [r.chain_idx for r in reqs], orch.stats()["finished"]))
    assert runs[0] == runs[1]
    assert runs[0][0][0] == jax_greedy_rollout(jmodel, jparams, _prompt(0, 8), 6)

"""Pipeline-parallel chain execution: the paper's placement, run as stages.
Translated from the JAX package's ``serving/pipeline.py``.

A chain is the GBP-CR placement (the paper's ``x``) made concrete: hop
``h`` puts ``chain.blocks[h]`` consecutive model blocks on one server.  The
monolithic engines (engine.py) keep that structure only in accounting: the
whole block stack runs as one program.  Here each hop becomes a *pipeline
stage*: :func:`plan_stages` maps the per-hop block counts to contiguous
layer ranges, and each range runs on its own device
(:func:`repro_torch.distributed.stage_devices`) with only its layers'
parameters (:meth:`Model.layer_slice`) and, through
:meth:`PagedCache.leaf_range` / :meth:`SlotCache.leaf_range`, only its
layers' KV leaves.  Slot and page accounting stay shared by reference, and
the per-stage grants of :meth:`PageAccounting.split` sum to the paper's
``s_c`` bit for bit.

Decode rounds run a microbatched 1F schedule: the active slots split into
``M`` microbatches, and at tick ``t`` stage ``k`` runs microbatch ``t - k``
(``S + M - 1`` ticks a round).  Batch size and page count are bucketed per
microbatch.  Hidden states hand off between stages with ``x.to(device)``,
a no-op when stages share a card.

Every stage runs the port's kernels: flash at admission, and per decode
round either the paged decode through the shared block table over the
stage's pools, or the dense decode with a row map (``rows``) that reads
and writes the microbatch's slots of the stage's slot buffer in place.
Neither layout gathers cache rows or pages.

A single stage composes the same code as the monolithic engines
(``Model.prefill`` / ``decode_step`` / ``decode_step_paged`` are the
full-range slice), and microbatching only regroups the rows of a
row-independent batched decode, so every stage count and every ``M`` give
the monolithic engines' greedy streams.

PyTorch runs eagerly, so the JAX package's trace-cache guards have nothing
to clear; ``prefill_bucket_count`` still reports the distinct prefill
buckets seen.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.chains import Chain
from repro_torch.distributed.mesh import stage_devices
from .engine import _bucket, _nbytes, _pow2
from .kv_cache import PAGE_SIZE, PagedCache, SlotCache
from .request import Request, State


@dataclasses.dataclass(frozen=True)
class StageSpec:
    """One pipeline stage: a contiguous global layer range ``[lo, hi)`` and
    the chain hops (placement entries) whose blocks it executes."""

    index: int
    lo: int
    hi: int
    hops: Tuple[int, ...]

    @property
    def num_layers(self) -> int:
        return self.hi - self.lo


def plan_stages(blocks: Sequence[int], num_stages: int) -> List[StageSpec]:
    """Map the chain's per-hop block counts (one GBP-CR placement row) to
    ``num_stages`` contiguous layer ranges.

    Cuts prefer hop boundaries — a hop's blocks live on one server, and
    splitting inside a hop models slicing a server, which only happens when
    there are more stages than hops.  With fewer stages than hops,
    contiguous hops merge greedily toward equal layer counts; with more,
    ideal equal-layer cuts subdivide hops.  ``num_stages`` clamps to
    ``[1, total layers]``.
    """
    counts = [int(b) for b in blocks]
    if not counts or any(b <= 0 for b in counts):
        raise ValueError(f"hop block counts must be positive, got {blocks}")
    H = len(counts)
    L = sum(counts)
    S = max(1, min(int(num_stages), L))
    bounds = [0]
    for b in counts:
        bounds.append(bounds[-1] + b)
    specs: List[StageSpec] = []
    if S <= H:
        start = 0
        for k in range(S):
            stages_left = S - k
            max_end = H - (stages_left - 1)
            end = start + 1
            target = (L - bounds[start]) / stages_left
            while end < max_end:
                cur = bounds[end] - bounds[start]
                nxt = bounds[end + 1] - bounds[start]
                if abs(nxt - target) <= abs(cur - target):
                    end += 1
                else:
                    break
            specs.append(StageSpec(k, bounds[start], bounds[end],
                                   tuple(range(start, end))))
            start = end
    else:
        cuts = [0]
        for i in range(1, S):
            c = round(i * L / S)
            c = max(c, cuts[-1] + 1)
            cuts.append(min(c, L - (S - i)))
        cuts.append(L)
        for k in range(S):
            lo, hi = cuts[k], cuts[k + 1]
            hops = tuple(h for h in range(H)
                         if bounds[h] < hi and bounds[h + 1] > lo)
            specs.append(StageSpec(k, lo, hi, hops))
    return specs


def _on(device: torch.device):
    """Make ``device`` current while a stage runs, so its kernels launch on
    that card's stream."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


class PipelineChainEngine:
    """Chain engine executing the hop placement as pipeline stages.

    Drop-in for ``ChainEngine`` / ``PagedChainEngine``: the same factory
    signature ``(model, params, chain, capacity, max_seq)`` plus keyword
    knobs, the same orchestrator surface (``admit`` / ``step`` /
    ``evict_all`` / ``take_preempted`` / ``free_pages`` /
    ``prefill_bucket_count`` / ``kv_bytes`` / ``device``), and the same
    greedy token streams.

    ``kv_layout`` picks the per-stage cache: ``"paged"`` shares one page
    accounting across stage-local pools (preemption on exhaustion, as in
    ``PagedChainEngine``); ``"slotted"`` shares the slot free list across
    stage-local slot buffers.  ``num_stages=None`` means one stage per
    chain hop.  ``microbatches`` bounds the decode-round split (clamped to
    the active-slot count each round).  ``devices`` defaults to every
    visible card (the model's device when it is on the CPU), assigned
    round-robin.
    """

    def __init__(self, model, params, chain: Chain, capacity: int,
                 max_seq: int, *, kv_layout: str = "paged",
                 page_size: int = PAGE_SIZE, oversubscribe: float = 1.0,
                 num_stages: Optional[int] = None, microbatches: int = 1,
                 devices: Optional[Sequence] = None,
                 trace_schedule: bool = False):
        if kv_layout not in ("slotted", "paged"):
            raise ValueError(f"unknown kv_layout {kv_layout!r}")
        if microbatches < 1:
            raise ValueError(f"microbatches must be >= 1, got {microbatches}")
        self.model = model
        self.chain = chain
        self.capacity = capacity
        self.max_seq = max_seq
        self.kv_layout = kv_layout
        self.page_size = page_size
        self.microbatches = int(microbatches)
        self.plan = plan_stages(
            chain.blocks, len(chain.blocks) if num_stages is None
            else int(num_stages))
        self.num_stages = len(self.plan)
        self.devices = [torch.device(d) for d in
                        stage_devices(self.num_stages, devices, model.device)]
        self.device = self.devices[0]
        self.trace_schedule = trace_schedule
        self.stage_schedule: List[dict] = []

        self.slices = [model.layer_slice(sp.lo, sp.hi) for sp in self.plan]
        self.stage_params = [sl.slice_params(params, dev)
                             for sl, dev in zip(self.slices, self.devices)]
        if kv_layout == "paged":
            num_slots = max(1, int(capacity * oversubscribe))
            pages_per_slot = -(-max_seq // page_size)
            self.cache = PagedCache(model, num_slots, max_seq,
                                    page_size=page_size,
                                    total_pages=capacity * pages_per_slot,
                                    materialize=False)
        else:
            self.cache = SlotCache(model, capacity, max_seq, materialize=False)
        self.stage_caches = [self.cache.leaf_range(sl, device=dev)
                             for sl, dev in zip(self.slices, self.devices)]

        self.requests: Dict[int, Request] = {}      # slot -> request
        self.preempted: List[Request] = []
        self._admit_seq: Dict[int, int] = {}
        self._seq = 0
        self._round = 0
        self._prefill_shapes: set = set()

    # -- surface -----------------------------------------------------------------
    @property
    def prefill_bucket_count(self) -> int:
        return len(self._prefill_shapes)

    @property
    def kv_bytes(self) -> int:
        """Device bytes of the KV leaves of every stage."""
        return sum(_nbytes(v.pools if self.kv_layout == "paged" else v.cache)
                   for v in self.stage_caches)

    @property
    def has_free_slot(self) -> bool:
        return bool(self.cache.free)

    @property
    def num_active(self) -> int:
        return len(self.requests)

    @property
    def free_pages(self) -> int:
        if self.kv_layout != "paged":
            # slotted engines have no page pool; AttributeError keeps the
            # orchestrator's hasattr() gauge filter honest
            raise AttributeError("free_pages")
        return self.cache.free_pages

    def _ints(self, values, k: int) -> torch.Tensor:
        return torch.as_tensor(np.asarray(values, np.int32),
                               device=self.devices[k])

    # -- stage programs ------------------------------------------------------------
    # Composed over all stages these are the monolithic engines' calls
    # (embed -> blocks -> logits), split at hidden-state boundaries.

    def _prefill_stage(self, k: int, cache, x: torch.Tensor) -> torch.Tensor:
        p = self.stage_params[k]
        if k == 0:
            x = self.model.embed_inputs(p, {"tokens": x})
        x = self.slices[k].seq_blocks(p, cache, x)
        if k == self.num_stages - 1:
            return self.model.logits(p, x[:, -1])
        return x

    def _decode_stage(self, k: int, cache, x: torch.Tensor,
                      meta: Dict[str, torch.Tensor]) -> torch.Tensor:
        """One decode step of stage ``k``: through the block table of its
        pools when ``meta`` has ``page_ids``, else over its slot buffer at
        cache rows ``meta["rows"]`` (``None``: row b)."""
        p = self.stage_params[k]
        if k == 0:
            x = self.model.embed_tokens(p, x)
        if "page_ids" in meta:
            x = self.slices[k].decode_blocks_paged(
                p, cache, x, meta["lengths"], meta["page_ids"],
                meta["write_page"], meta["write_off"])
        else:
            x = self.slices[k].decode_blocks(p, cache, x, meta["lengths"],
                                             meta.get("rows"))
        if k == self.num_stages - 1:
            return self.model.logits(p, x)
        return x

    # -- admission --------------------------------------------------------------
    def admit(self, req: Request, now: float = 0.0) -> bool:
        tokens = req.context_tokens
        true_len = len(tokens)
        if self.kv_layout == "paged":
            slot = self.cache.acquire(true_len)
            if slot is None:
                return False             # no slot, or page budget exhausted
            pad_to = min(max(_bucket(true_len), self.page_size), self.max_seq)
        else:
            slot = self.cache.acquire()
            if slot is None:
                return False
            pad_to = min(_bucket(true_len), self.max_seq)
        padded = np.zeros((1, pad_to), np.int32)
        padded[0, :true_len] = tokens
        self._prefill_shapes.add(padded.shape)
        # Prefill flows through the stages in order at batch 1: the slotted
        # layout writes each stage's slot in place, the paged one fills a
        # right-sized buffer per stage and copies it into the pages.
        if self.kv_layout == "paged":
            bufs = [self.stage_caches[k].prefill_buffer(pad_to)
                    for k in range(self.num_stages)]
        else:
            bufs = [view.slot_view(slot) for view in self.stage_caches]
        x = self._ints(padded, 0)
        for k in range(self.num_stages):
            with _on(self.devices[k]):
                x = self._prefill_stage(k, bufs[k], x.to(self.devices[k]))
        if true_len != pad_to:
            # boundary fixup as in the monolithic engines: re-feed the true
            # last token at its own position through every stage (identical
            # k/v rewritten, correct boundary logits)
            x = self._ints([tokens[-1]], 0)
            for k in range(self.num_stages):
                with _on(self.devices[k]):
                    x = self._decode_stage(
                        k, bufs[k], x.to(self.devices[k]),
                        {"lengths": self._ints([true_len - 1], k)})
        next_tok = int(torch.argmax(x[0]))
        if self.kv_layout == "paged":
            for view, buf in zip(self.stage_caches, bufs):
                view.write_prefill(slot, buf, true_len)
        else:
            self.cache.lengths[slot] = true_len
        req.slot = slot
        req.state = State.RUNNING
        if req.start_time is None:
            req.start_time = now
        self.requests[slot] = req
        self._admit_seq[slot] = self._seq
        self._seq += 1
        req.output.append(next_tok)
        if req.done:
            req.state = State.DONE
            req.finish_time = now
            self._release(slot)
        return True

    def _release(self, slot: int) -> None:
        self.requests.pop(slot, None)
        self._admit_seq.pop(slot, None)
        self.cache.release(slot)

    def _preempt(self, slot: int) -> None:
        req = self.requests[slot]
        req.state = State.QUEUED
        req.slot = None
        req.chain_idx = None
        req.retries += 1
        self.preempted.append(req)
        self._release(slot)

    def take_preempted(self) -> List[Request]:
        """Drain requests preempted by page exhaustion (the orchestrator
        resubmits them; generated tokens ride along in context_tokens)."""
        out, self.preempted = self.preempted, []
        return out

    # -- decode ----------------------------------------------------------------
    def _microbatch(self, group: List[int]) -> Tuple[np.ndarray, dict]:
        """Tokens and host-side index arrays of one microbatch, padded to a
        power of two (pad rows mirror row 0, whose writes are identical)."""
        n = len(group)
        nb = _pow2(n)
        tokens = np.zeros((nb,), np.int32)
        for i, slot in enumerate(group):
            tokens[i] = self.requests[slot].output[-1]
        tokens[n:] = tokens[0]
        if self.kv_layout == "paged":
            npg = _pow2(max(int(self.cache.pages_used[s]) for s in group))
            view = self.cache.decode_view(group, nb, npg)
            meta = {key: view[key] for key in
                    ("lengths", "page_ids", "write_page", "write_off")}
        else:
            rows = np.asarray(group + [group[0]] * (nb - n), np.int32)
            meta = {"rows": rows, "lengths": self.cache.lengths[rows]}
        return tokens, meta

    def _run_stage(self, k: int, meta: Dict[str, torch.Tensor],
                   x: torch.Tensor) -> torch.Tensor:
        view = self.stage_caches[k]
        with _on(self.devices[k]):
            return self._decode_stage(
                k, view.pools if self.kv_layout == "paged" else view.cache,
                x.to(self.devices[k]), meta)

    def _on_devices(self, meta: dict) -> Dict[torch.device, dict]:
        """A microbatch's index arrays as tensors on each stage device."""
        out = {}
        for k, dev in enumerate(self.devices):
            if dev not in out:
                m = {key: self._ints(a, k) for key, a in meta.items()}
                if "write_page" in m:
                    m["write_page"] = m["write_page"].long()
                    m["write_off"] = m["write_off"].long()
                out[dev] = m
        return out

    def step(self, now: float = 0.0) -> List[Request]:
        """One decode round: split the active slots into microbatches, run
        the 1F wavefront over the stages, then collect completions in
        ascending slot order (the monolithic engines' order)."""
        if not self.requests:
            return []
        if self.kv_layout == "paged":
            # guarantee a write page per active row, preempting the
            # youngest on exhaustion, as PagedChainEngine does
            alive = sorted(self.requests, key=lambda s: self._admit_seq[s])
            for slot in list(alive):
                if slot not in alive:
                    continue
                while slot in alive \
                        and not self.cache.ensure_decode_write(slot):
                    self._preempt(alive.pop())
            if not alive:
                return []
        else:
            alive = list(self.requests)
        active = sorted(alive)
        M = min(self.microbatches, len(active))
        groups = [list(map(int, g)) for g in
                  np.array_split(np.asarray(active, np.int64), M)]
        S = self.num_stages
        # every microbatch reads the round-start accounting; each slot is in
        # exactly one microbatch, so writes are disjoint
        metas, xs = [], []
        for g in groups:
            tokens, meta = self._microbatch(g)
            metas.append(self._on_devices(meta))
            xs.append(self._ints(tokens, 0))
        # 1F wavefront: tick t runs microbatch t-k on stage k (k descending,
        # so a microbatch advances at most one stage per tick)
        for t in range(S + M - 1):
            for k in range(S - 1, -1, -1):
                j = t - k
                if 0 <= j < M:
                    xs[j] = self._run_stage(k, metas[j][self.devices[k]],
                                            xs[j])
                    if self.trace_schedule:
                        self.stage_schedule.append({
                            "now": now, "round": self._round, "tick": t,
                            "n_ticks": S + M - 1, "stage": k, "ubatch": j,
                            "rows": len(groups[j])})
        self._round += 1
        finished = []
        for j, g in enumerate(groups):
            nxt = torch.argmax(xs[j][:len(g)], dim=-1).cpu().numpy()
            for i, slot in enumerate(g):
                self.cache.lengths[slot] += 1
                req = self.requests[slot]
                req.output.append(int(nxt[i]))
                if req.done:
                    req.state = State.DONE
                    req.finish_time = now
                    finished.append(req)
                    self._release(slot)
        return finished

    # -- failover ----------------------------------------------------------------
    def evict_all(self) -> List[Request]:
        """All in-flight requests (for re-queue), including any preempted
        ones not yet drained, and clear state (and pages)."""
        out = []
        for slot, req in list(self.requests.items()):
            req.state = State.QUEUED
            req.slot = None
            req.chain_idx = None
            req.retries += 1
            out.append(req)
            self.cache.release(slot)
        self.requests.clear()
        self._admit_seq.clear()
        out.extend(self.take_preempted())
        return out

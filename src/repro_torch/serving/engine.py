"""Chain engine: the data plane of one composed server chain, translated
from the JAX package's ``serving/engine.py``.

The whole model executes on one device while the chain structure —
capacity, per-hop block counts, service-time accounting — is preserved, so
the control plane (the paper's contribution) is exercised end to end.

``ChainEngine`` keeps a :class:`SlotCache`: prefill lengths are bucketed to
powers of two, and decode runs one batched step over all capacity slots
(idle slots decode harmlessly at length 0) through the dense decode kernel.

``PagedChainEngine`` is the continuously-batched variant over a
:class:`PagedCache`: admission copies O(prompt) pages, decode batches only
the active slots (batch size and page count bucketed to powers of two) and
attends through the block table with the paged decode kernel — no dense
gather — and page exhaustion preempts the youngest request.  Its greedy
token streams equal ``ChainEngine``'s: masked cache positions contribute
exact zeros and decode rows are independent.

PyTorch runs eagerly, so the JAX package's trace-cache limits have nothing
to clear; ``prefill_bucket_count`` still reports the distinct prefill
buckets seen, which the orchestrator gauges.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from repro_torch.core.chains import Chain
from .kv_cache import PAGE_SIZE, PagedCache, SlotCache
from .request import Request, State


def _bucket(n: int) -> int:
    return max(16, 1 << (n - 1).bit_length())


def _pow2(n: int) -> int:
    return max(1, 1 << (n - 1).bit_length())


def _nbytes(stages) -> int:
    return sum(leaf.numel() * leaf.element_size()
               for stage in stages for leaf in stage.values())


class ChainEngine:
    def __init__(self, model, params, chain: Chain, capacity: int,
                 max_seq: int):
        self.model = model
        self.params = params
        self.chain = chain
        self.capacity = capacity
        self.max_seq = max_seq
        self.device = model.device
        self.slots = SlotCache(model, capacity, max_seq)
        self.requests: Dict[int, Request] = {}      # slot -> request
        self._prefill_shapes: set = set()

    def _ints(self, values) -> torch.Tensor:
        return torch.as_tensor(np.asarray(values, np.int32), device=self.device)

    @property
    def kv_bytes(self) -> int:
        """Device bytes of this engine's KV cache."""
        return _nbytes(self.slots.cache)

    @property
    def prefill_bucket_count(self) -> int:
        """Distinct prefill lengths seen (gauged by the orchestrator)."""
        return len(self._prefill_shapes)

    def _prefill(self, cache_one, padded: np.ndarray) -> torch.Tensor:
        self._prefill_shapes.add(padded.shape)
        logits, _ = self.model.prefill(self.params, cache_one,
                                       {"tokens": self._ints(padded)})
        return logits

    # -- admission --------------------------------------------------------------
    @property
    def has_free_slot(self) -> bool:
        return bool(self.slots.free)

    @property
    def num_active(self) -> int:
        return self.capacity - len(self.slots.free)

    def admit(self, req: Request, now: float = 0.0) -> bool:
        slot = self.slots.acquire()
        if slot is None:
            return False
        tokens = req.context_tokens
        true_len = len(tokens)
        # Right-pad to a power-of-two bucket; positions beyond true_len hold
        # garbage keys but decode masks by length, and each future decode
        # overwrites its position before attending.
        pad_to = min(_bucket(true_len), self.max_seq)
        padded = np.zeros((1, pad_to), np.int32)
        padded[0, :true_len] = tokens
        logits = self._prefill(self.slots.slot_view(slot), padded)
        self.slots.lengths[slot] = true_len
        req.slot = slot
        req.state = State.RUNNING
        if req.start_time is None:
            req.start_time = now
        self.requests[slot] = req
        if true_len == pad_to:
            next_tok = int(torch.argmax(logits[0]))
        else:
            # Prefill's last-position logits sit at a padded position; re-feed
            # the true last token at its own position (identical k/v rewritten)
            # to get the correct boundary distribution.
            d_logits, _ = self.model.decode_step(
                self.params, self.slots.slot_view(slot),
                self._ints([tokens[-1]]), self._ints([true_len - 1]))
            next_tok = int(torch.argmax(d_logits[0]))
        req.output.append(next_tok)
        if req.done:                                  # e.g. max_new_tokens == 1
            req.state = State.DONE
            req.finish_time = now
            del self.requests[slot]
            self.slots.release(slot)
        return True

    # -- decode ----------------------------------------------------------------
    def step(self, now: float = 0.0) -> List[Request]:
        """One batched decode step; returns requests that completed."""
        if not self.requests:
            return []
        tokens = np.zeros((self.capacity,), np.int32)
        lengths = np.zeros((self.capacity,), np.int32)
        for slot, req in self.requests.items():
            tokens[slot] = req.output[-1]
            # slots.lengths[slot] == positions already in the cache; this
            # step writes the pending token there and advances it.
            lengths[slot] = self.slots.lengths[slot]
        logits, _ = self.model.decode_step(self.params, self.slots.cache,
                                           self._ints(tokens), self._ints(lengths))
        for slot in self.requests:
            self.slots.lengths[slot] += 1
        next_tokens = torch.argmax(logits, dim=-1).cpu().numpy()
        finished = []
        for slot, req in list(self.requests.items()):
            req.output.append(int(next_tokens[slot]))
            if req.done:
                req.state = State.DONE
                req.finish_time = now
                finished.append(req)
                del self.requests[slot]
                self.slots.release(slot)
        return finished

    # -- failover ----------------------------------------------------------------
    def evict_all(self) -> List[Request]:
        """Return all in-flight requests (for re-queue) and clear state."""
        out = []
        for slot, req in list(self.requests.items()):
            req.state = State.QUEUED
            req.slot = None
            req.chain_idx = None
            req.retries += 1
            out.append(req)
            self.slots.release(slot)
        self.requests.clear()
        return out


class PagedChainEngine(ChainEngine):
    """Chain engine over a :class:`PagedCache` with continuous batching.

    Differences from the slotted base:
      * ``admit`` prefills into a right-sized batch-1 buffer and copies
        O(prompt) pages into the pool;
      * ``step`` batches only the active slots — batch size and per-row page
        count bucketed to powers of two — writes one position per row into
        the pool and attends through the block table;
      * page exhaustion during decode preempts the youngest request (pages
        freed, request requeued with its generated tokens preserved — the
        orchestrator drains :meth:`take_preempted` each round); exhaustion
        at admission refuses the request.

    ``oversubscribe > 1`` grants more slots than the page budget can hold at
    full length; the budget stays ``capacity * pages_per_slot``, exactly the
    memory GCA allocated for ``capacity`` slots.
    """

    def __init__(self, model, params, chain: Chain, capacity: int,
                 max_seq: int, page_size: int = PAGE_SIZE,
                 oversubscribe: float = 1.0):
        self.model = model
        self.params = params
        self.chain = chain
        self.capacity = capacity
        self.max_seq = max_seq
        self.device = model.device
        self.page_size = page_size
        num_slots = max(1, int(capacity * oversubscribe))
        pages_per_slot = -(-max_seq // page_size)
        self.cache = PagedCache(model, num_slots, max_seq,
                                page_size=page_size,
                                total_pages=capacity * pages_per_slot)
        self.requests: Dict[int, Request] = {}      # slot -> request
        self.preempted: List[Request] = []
        self._admit_seq: Dict[int, int] = {}        # slot -> admission counter
        self._seq = 0
        self._prefill_shapes: set = set()

    # -- admission --------------------------------------------------------------
    @property
    def has_free_slot(self) -> bool:
        return bool(self.cache.free)

    @property
    def num_active(self) -> int:
        return len(self.requests)

    @property
    def free_pages(self) -> int:
        return self.cache.free_pages

    @property
    def kv_bytes(self) -> int:
        return _nbytes(self.cache.pools)

    def admit(self, req: Request, now: float = 0.0) -> bool:
        tokens = req.context_tokens
        true_len = len(tokens)
        slot = self.cache.acquire(true_len)
        if slot is None:
            return False                 # no slot, or page budget exhausted
        pad_to = min(max(_bucket(true_len), self.page_size), self.max_seq)
        padded = np.zeros((1, pad_to), np.int32)
        padded[0, :true_len] = tokens
        buf = self.cache.prefill_buffer(pad_to)
        logits = self._prefill(buf, padded)
        if true_len == pad_to:
            next_tok = int(torch.argmax(logits[0]))
        else:
            # Bucketed-prefill boundary fixup, as in the slotted engine, on
            # the small batch-1 buffer.
            d_logits, _ = self.model.decode_step(
                self.params, buf, self._ints([tokens[-1]]),
                self._ints([true_len - 1]))
            next_tok = int(torch.argmax(d_logits[0]))
        self.cache.write_prefill(slot, buf, true_len)
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
    def step(self, now: float = 0.0) -> List[Request]:
        """One continuously-batched decode round; returns completions."""
        if not self.requests:
            return []
        # Guarantee a write page for every active row, preempting the
        # youngest request when the pool runs dry (its pages free the rest).
        alive = sorted(self.requests, key=lambda s: self._admit_seq[s])
        for slot in list(alive):
            if slot not in alive:
                continue
            while slot in alive and not self.cache.ensure_decode_write(slot):
                self._preempt(alive.pop())
        if not alive:
            return []
        active = sorted(alive)
        n = len(active)
        nb = _pow2(n)
        npg = _pow2(max(int(self.cache.pages_used[s]) for s in active))
        view = self.cache.decode_view(active, nb, npg)
        tokens = np.zeros((nb,), np.int32)
        for i, slot in enumerate(active):
            tokens[i] = self.requests[slot].output[-1]
        tokens[n:] = tokens[0]                     # pad rows mirror row 0
        logits = self.model.decode_step_paged(
            self.params, self.cache.pools, self._ints(tokens),
            self._ints(view["lengths"]), self._ints(view["page_ids"]),
            self._ints(view["write_page"]).long(),
            self._ints(view["write_off"]).long())
        next_tokens = torch.argmax(logits[:n], dim=-1).cpu().numpy()
        finished = []
        for i, slot in enumerate(active):
            self.cache.lengths[slot] += 1
            req = self.requests[slot]
            req.output.append(int(next_tokens[i]))
            if req.done:
                req.state = State.DONE
                req.finish_time = now
                finished.append(req)
                self._release(slot)
        return finished

    # -- failover ----------------------------------------------------------------
    def evict_all(self) -> List[Request]:
        """All in-flight requests (for re-queue), including any preempted
        ones not yet drained, and clear state + pages."""
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

"""Bridge between model configs and the paper's (s_m, s_c) service spec,
plus the two KV-cache layouts of the chain engines: slotted and paged.
Translated from the JAX package's ``serving/kv_cache.py``.

The paper's memory model:  server memory = s_m * (#blocks) + s_c * (cache
slots in use).  For a transformer served at max sequence length S_max with
TP degree t:  s_m = per-layer weight bytes / t;  s_c = per-layer KV bytes
per token * S_max / t (static allocation, Section 2.1.2).

``SlotCache`` takes that allocation literally: one ``(layers, capacity,
S_max, KV, hd)`` buffer per cache leaf, slot i owned by request i for its
whole lifetime.  ``PagedCache`` keeps the accounting and drops the
allocation granularity: each leaf becomes one pool of ``page_size``-token
pages ``(layers, total_pages + 1, page_size, KV, hd)`` and a per-slot block
table maps logical positions to pages.  A slot's ``s_c`` gigabytes shard
into ``pages_per_slot`` pages exactly (:class:`PageAccounting`).

In the port all cache writes are in place (the JAX package rebuilt its
buffers with ``.at[].set`` under donation).  This slice holds dense
full-attention caches only, so every leaf is paged; recurrent state and
sliding-window rings wait for the model families that need them.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.servers import ServiceSpec

GIB = 1024.0 ** 3


def recurrent_state_bytes(cfg: ModelConfig, bytes_per_el: int = 4) -> float:
    """Per-request per-layer recurrent-state bytes (mLSTM/sLSTM/SSM)."""
    if cfg.family == "ssm":
        H, hd = cfg.num_heads, cfg.hd
        mlstm = (H * hd * hd + H * hd) * bytes_per_el
        slstm = 4 * cfg.d_model * bytes_per_el
        return max(mlstm, slstm)
    if cfg.family == "hybrid":
        d_inner = cfg.ssm.expand * cfg.d_model
        return d_inner * cfg.ssm.state_dim * bytes_per_el
    return 0.0


def service_spec_for(
    cfg: ModelConfig, max_seq: int, tp_degree: int = 1, bytes_per_el: int = 2,
) -> ServiceSpec:
    """The paper's (L, s_m, s_c) for serving ``cfg`` at ``max_seq``."""
    s_m = cfg.block_bytes(bytes_per_el) / tp_degree / GIB
    kv = cfg.kv_bytes_per_token_per_layer(bytes_per_el) * max_seq
    if cfg.family == "hybrid":
        # SWA layers cache only the window; global layers the full context.
        n_glob = len(cfg.global_attn_layers)
        frac = (n_glob + (cfg.num_layers - n_glob)
                * min(cfg.window, max_seq) / max_seq) / cfg.num_layers
        kv = kv * frac
    if cfg.family == "ssm":
        kv = 0.0
    kv += recurrent_state_bytes(cfg)
    s_c = max(kv, 1.0) / tp_degree / GIB
    return ServiceSpec(num_blocks=cfg.num_layers, block_size_gb=s_m,
                       cache_size_gb=max(s_c, 1e-9))


# ---------------------------------------------------------------------------
# Slotted batched cache
# ---------------------------------------------------------------------------

class SlotCache:
    """Capacity-``c`` batched cache for one chain engine.  Slot i of every
    cache leaf (axis 1, after the per-stage layer axis) belongs to request i.

    ``model`` is a ``Model`` or a ``LayerSlice``; the leaves go on
    ``device`` (the model's by default).  ``materialize=False`` keeps the
    slot accounting without leaves: a pipeline's master cache, whose leaves
    live in the per-stage :meth:`leaf_range` views.
    """

    def __init__(self, model, capacity: int, max_seq: int, device=None,
                 materialize: bool = True):
        self.model = model
        self.capacity = capacity
        self.max_seq = max_seq
        self.device = model.device if device is None else torch.device(device)
        self.cache = (model.init_cache(capacity, max_seq, self.device)
                      if materialize else None)
        self.free: List[int] = list(range(capacity))
        self._active: set = set()
        self.lengths = np.zeros((capacity,), np.int32)

    def leaf_range(self, model_slice, device=None) -> "SlotCache":
        """A pipeline-stage view: its own cache leaves for ``model_slice``'s
        layers, on ``device``, sharing this cache's slot accounting (free
        list, active set, lengths) by reference, so an acquire or release
        on any view or the master is seen by all."""
        view = SlotCache(model_slice, self.capacity, self.max_seq,
                         device=device)
        view.free = self.free
        view._active = self._active
        view.lengths = self.lengths
        return view

    def acquire(self) -> Optional[int]:
        if not self.free:
            return None
        slot = self.free.pop()
        self._active.add(slot)
        return slot

    def release(self, slot: int) -> None:
        self.lengths[slot] = 0
        self._active.discard(slot)
        self.free.append(slot)

    def slot_view(self, slot: int) -> List[Dict[str, torch.Tensor]]:
        """A batch-1 cache aliasing slot ``slot``: prefill and decode on it
        write the slot in place (where the JAX package prefilled a fresh
        buffer and copied it in)."""
        return [{name: leaf[:, slot:slot + 1] for name, leaf in stage.items()}
                for stage in self.cache]

    @property
    def active_slots(self) -> List[int]:
        return sorted(self._active)


# ---------------------------------------------------------------------------
# Paged cache
# ---------------------------------------------------------------------------

PAGE_SIZE = 16


@dataclasses.dataclass(frozen=True)
class PageAccounting:
    """Pages <-> s_c: the paper's cache-slot grant expressed in page units.

    One slot's ``s_c`` gigabytes shard into ``pages_per_slot`` pages, so
    ``gb_for_pages(pages_per_slot) == slot_gb`` *exactly* (the round-trip is
    ``slot_gb * (p / pages_per_slot)``, and ``p / pages_per_slot == 1.0`` is
    exact for ``p == pages_per_slot``).
    """

    slot_gb: float            # the paper's s_c for one slot at S_max
    max_seq: int
    page_size: int = PAGE_SIZE

    @classmethod
    def from_spec(cls, spec: ServiceSpec, max_seq: int,
                  page_size: int = PAGE_SIZE) -> "PageAccounting":
        return cls(slot_gb=spec.cache_size_gb, max_seq=max_seq,
                   page_size=page_size)

    @property
    def pages_per_slot(self) -> int:
        return -(-self.max_seq // self.page_size)

    @property
    def page_gb(self) -> float:
        return self.slot_gb / self.pages_per_slot

    def pages_for_tokens(self, n_tokens: int) -> int:
        return -(-max(n_tokens, 0) // self.page_size)

    def pages_for_slots(self, slots: int) -> int:
        return slots * self.pages_per_slot

    def gb_for_pages(self, pages: int) -> float:
        return self.slot_gb * (pages / self.pages_per_slot)

    def split(self, layer_counts: Sequence[int]) -> Tuple["PageAccounting", ...]:
        """Per-pipeline-stage grants: a stage serving ``n_k`` of the range's
        ``L`` layers holds ``slot_gb * n_k / L`` of the slot's cache bytes.
        The last stage takes the residual (nudged by ulps against float
        double-rounding), so the grants sum left-to-right to ``s_c``
        bit-for-bit."""
        counts = [int(c) for c in layer_counts]
        if not counts or any(c <= 0 for c in counts):
            raise ValueError(f"layer counts must be positive, got {layer_counts}")
        L = sum(counts)
        grants: List[float] = [self.slot_gb * (c / L) for c in counts[:-1]]
        acc = 0.0
        for g in grants:
            acc += g
        last = self.slot_gb - acc
        for _ in range(4):          # double-rounding guard (at most 1-2 ulps)
            total = acc + last
            if total == self.slot_gb:
                break
            last = math.nextafter(
                last, -math.inf if total > self.slot_gb else math.inf)
        if acc + last != self.slot_gb:
            raise AssertionError("stage grant residual failed to close")
        grants.append(last)
        return tuple(dataclasses.replace(self, slot_gb=g) for g in grants)


class PagedCache:
    """Paged KV cache: pooled fixed-size token pages + per-slot block tables.

    Every cache leaf is one pool ``(layers, total_pages + 1, page_size, KV,
    hd)`` on ``device`` (the model's by default); the final page is
    write-only scratch that absorbs bucketed-prefill padding.
    ``materialize=False`` keeps the accounting without pools (a pipeline's
    master; see :meth:`leaf_range`).  Host-side state (numpy): a
    ``(num_slots, pages_per_slot)`` block table, a LIFO free-page stack,
    per-slot lengths.  Writes go into the pools in place, so admission
    costs O(prompt) and a decode write O(active).  Freed pages are returned
    unzeroed: stale contents are masked by lengths and overwritten by the
    next prefill into the page.
    """

    def __init__(self, model, num_slots: int, max_seq: int,
                 page_size: int = PAGE_SIZE,
                 total_pages: Optional[int] = None, device=None,
                 materialize: bool = True):
        if page_size < 1 or (page_size & (page_size - 1)):
            raise ValueError(f"page_size must be a power of two, got {page_size}")
        if max_seq % page_size:
            raise ValueError(
                f"max_seq {max_seq} must be a multiple of page_size {page_size}")
        self.model = model
        self.num_slots = num_slots
        self.max_seq = max_seq
        self.page_size = page_size
        self.pages_per_slot = -(-max_seq // page_size)
        if total_pages is None:
            total_pages = num_slots * self.pages_per_slot
        if total_pages < self.pages_per_slot:
            raise ValueError(
                f"total_pages={total_pages} cannot hold one full sequence "
                f"({self.pages_per_slot} pages)")
        self.total_pages = total_pages
        self.scratch_page = total_pages          # index of the write-only page
        self.device = model.device if device is None else torch.device(device)
        # (layers, B=total_pages+1, S=page_size, KV, hd) is the pool layout;
        # an accounting-only master (materialize=False) holds no pools
        self.pools = (model.init_cache(total_pages + 1, page_size, self.device)
                      if materialize else None)

        self.block_table = np.full((num_slots, self.pages_per_slot), -1,
                                   np.int32)
        self.pages_used = np.zeros((num_slots,), np.int32)
        self.lengths = np.zeros((num_slots,), np.int32)
        self.free: List[int] = list(range(num_slots))
        self._active: set = set()
        self._free_pages: List[int] = list(range(total_pages))

    def leaf_range(self, model_slice, device=None) -> "PagedCache":
        """A pipeline-stage view: its own pools for ``model_slice``'s layers,
        on ``device``, sharing this cache's page accounting (block table,
        pages used, free-page stack, lengths, slot free list, active set)
        by reference.  Page ids are global, so one ``decode_view`` of the
        master indexes every stage's pools alike."""
        view = PagedCache(model_slice, self.num_slots, self.max_seq,
                          page_size=self.page_size,
                          total_pages=self.total_pages, device=device)
        view.block_table = self.block_table
        view.pages_used = self.pages_used
        view.lengths = self.lengths
        view.free = self.free
        view._active = self._active
        view._free_pages = self._free_pages
        return view

    # -- accounting ------------------------------------------------------------
    @property
    def free_pages(self) -> int:
        return len(self._free_pages)

    @property
    def active_slots(self) -> List[int]:
        return sorted(self._active)

    @property
    def num_active(self) -> int:
        return len(self._active)

    def pages_for(self, n_tokens: int) -> int:
        return -(-max(n_tokens, 0) // self.page_size)

    # -- slot lifecycle --------------------------------------------------------
    def can_admit(self, true_len: int) -> bool:
        """A free slot plus pages covering the prompt *and* its first decode
        write (``true_len + 1`` tokens)."""
        return bool(self.free) and \
            len(self._free_pages) >= self.pages_for(true_len + 1)

    def acquire(self, true_len: int) -> Optional[int]:
        if not self.can_admit(true_len):
            return None
        slot = self.free.pop()
        self._active.add(slot)
        need = self.pages_for(true_len)
        for i in range(need):
            self.block_table[slot, i] = self._free_pages.pop()
        self.pages_used[slot] = need
        self.lengths[slot] = 0
        return slot

    def release(self, slot: int) -> None:
        used = int(self.pages_used[slot])
        # reversed: the stack hands pages back out lowest-allocated-first,
        # keeping page reuse deterministic
        for i in reversed(range(used)):
            self._free_pages.append(int(self.block_table[slot, i]))
        self.block_table[slot, :used] = -1
        self.pages_used[slot] = 0
        self.lengths[slot] = 0
        self._active.discard(slot)
        self.free.append(slot)

    def ensure_decode_write(self, slot: int) -> bool:
        """Guarantee the page holding this slot's next write position exists,
        allocating on demand.  False = pool exhausted (caller preempts)."""
        pos = int(self.lengths[slot])
        pg = pos // self.page_size
        if pg < int(self.pages_used[slot]):
            return True
        if not self._free_pages:
            return False
        self.block_table[slot, pg] = self._free_pages.pop()
        self.pages_used[slot] = pg + 1
        return True

    # -- prefill ---------------------------------------------------------------
    def prefill_buffer(self, pad_len: int) -> List[Dict[str, torch.Tensor]]:
        """A zeroed batch-1 dense cache sized for a ``pad_len``-token
        prefill."""
        if pad_len % self.page_size:
            raise ValueError(
                f"pad_len {pad_len} must be a multiple of page_size "
                f"{self.page_size}")
        return self.model.init_cache(1, pad_len, self.device)

    def write_prefill(self, slot: int, cache_one: List[Dict[str, torch.Tensor]],
                      true_len: int) -> None:
        """Copy a batch-1 prefilled cache (from :meth:`prefill_buffer`) into
        this slot's pages, in place.  Chunks beyond the slot's allocated
        pages (bucketed-prefill padding) land in the scratch page.  Cost:
        O(pad_len), not O(pool)."""
        if len(cache_one) != len(self.pools):
            raise ValueError("cache_one structure does not match the model cache")
        pad = cache_one[0]["k"].shape[2]
        n_chunks = pad // self.page_size
        n_real = min(self.pages_for(true_len), n_chunks)
        ids = np.full((n_chunks,), self.scratch_page, np.int64)
        ids[:n_real] = self.block_table[slot, :n_real]
        index = torch.as_tensor(ids, device=self.pools[0]["k"].device)
        for pool, one in zip(self.pools, cache_one):
            for name, leaf in pool.items():
                src = one[name][:, 0].reshape(leaf.shape[0], n_chunks,
                                              self.page_size, *leaf.shape[3:])
                leaf.index_copy_(1, index, src)
        self.lengths[slot] = true_len

    # -- decode view -----------------------------------------------------------
    def decode_view(self, slots: List[int], nb: int, npg: int
                    ) -> Dict[str, np.ndarray]:
        """Host-side index arrays for a decode batch over ``slots``, padded
        to ``nb`` rows (duplicating row 0, whose writes are identical) and
        ``npg`` pages per row (padding with the row's own first page;
        garbage there is masked by lengths)."""
        pad = list(slots) + [slots[0]] * (nb - len(slots))
        page_ids = np.zeros((nb, npg), np.int32)
        slot_idx = np.zeros((nb,), np.int32)
        lengths = np.zeros((nb,), np.int32)
        write_page = np.zeros((nb,), np.int32)
        write_off = np.zeros((nb,), np.int32)
        for i, s in enumerate(pad):
            used = int(self.pages_used[s])
            row = self.block_table[s, :used]
            page_ids[i, :min(used, npg)] = row[:npg]
            page_ids[i, used:] = row[0]
            slot_idx[i] = s
            pos = int(self.lengths[s])
            lengths[i] = pos
            write_page[i] = self.block_table[s, pos // self.page_size]
            write_off[i] = pos % self.page_size
        return {"page_ids": page_ids, "slot_idx": slot_idx,
                "lengths": lengths, "write_page": write_page,
                "write_off": write_off}

"""The attention ops the model calls, dispatched by device.

A CPU tensor goes to the plain PyTorch version (``ref.py``); a CUDA tensor
goes to the hand-written kernel, which launches or raises — there is no
fallback.  Every CUDA launch adds one to that kernel's entry in
:data:`LAUNCHES`, so a run can show that its main path went through the
kernels (``chip_smoke.py`` zeroes the counts, serves, and reads them).
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from . import ref
from .decode_attention import decode_attention_cuda, paged_decode_attention_cuda
from .flash_attention import flash_attention_cuda

LAUNCHES: Dict[str, int] = {
    "decode_attention": 0,
    "paged_decode_attention": 0,
    "flash_attention": 0,
}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """q: (B, S, H, hd); k/v: (B, S, KV, hd) -> (B, S, H, hd)."""
    if q.device.type == "cpu":
        return ref.flash_attention_ref(q, k, v, causal=causal, window=window)
    out = flash_attention_cuda(q, k, v, causal=causal, window=window)
    LAUNCHES["flash_attention"] += 1
    return out


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, lengths: torch.Tensor,
                     rows: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q: (B, H, hd); caches: (R, S, KV, hd); lengths: (B,); rows: (B,)
    int32 cache row of each query row, ``None`` for row b -> (B, H, hd)."""
    if q.device.type == "cpu":
        return ref.decode_attention_ref(q, k_cache, v_cache, lengths, rows)
    out = decode_attention_cuda(q, k_cache, v_cache, lengths, rows)
    LAUNCHES["decode_attention"] += 1
    return out


def paged_decode_attention(q: torch.Tensor, k_pool: torch.Tensor,
                           v_pool: torch.Tensor, block_tables: torch.Tensor,
                           lengths: torch.Tensor) -> torch.Tensor:
    """q: (B, H, hd); pools: (P, page, KV, hd); block_tables: (B, PP) int32
    page ids (< 0 = unused); lengths: (B,) -> (B, H, hd)."""
    if q.device.type == "cpu":
        return ref.paged_decode_attention_ref(q, k_pool, v_pool, block_tables,
                                              lengths)
    out = paged_decode_attention_cuda(q, k_pool, v_pool, block_tables, lengths)
    LAUNCHES["paged_decode_attention"] += 1
    return out

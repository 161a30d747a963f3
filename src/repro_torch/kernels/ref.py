"""Plain PyTorch versions of the three attention kernels.

A translation of the JAX package's ``kernels/ref.py``: direct, unchunked
softmax attention, so each CUDA kernel is checked against an independent
formulation.  CPU tensors take these functions on the serving path;
``chip_smoke.py`` holds each kernel against them on the card.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

NEG_INF = -1e30


def flash_attention_ref(
    q: torch.Tensor,              # (B, S, H, hd)
    k: torch.Tensor,              # (B, S, KV, hd)
    v: torch.Tensor,              # (B, S, KV, hd)
    causal: bool = True,
    window: int = 0,
) -> torch.Tensor:
    B, Sq, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    G = H // KV
    kk = k.repeat_interleave(G, dim=2)            # (B, Sk, H, hd)
    vv = v.repeat_interleave(G, dim=2)
    s = torch.einsum("bqhd,bshd->bhqs", q.float(), kk.float())
    s = s / math.sqrt(hd)
    qpos = torch.arange(Sq, device=q.device)[:, None]
    kpos = torch.arange(Sk, device=q.device)[None, :]
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window:
        mask &= kpos > qpos - window
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhqs,bshd->bqhd", p, vv.float())
    return out.to(q.dtype)


def paged_decode_attention_ref(
    q: torch.Tensor,              # (B, H, hd)
    k_pool: torch.Tensor,         # (P, page, KV, hd)
    v_pool: torch.Tensor,         # (P, page, KV, hd)
    block_tables: torch.Tensor,   # (B, PP) int32 page ids (< 0 = unused)
    lengths: torch.Tensor,        # (B,)
) -> torch.Tensor:
    """Gather the paged K/V into dense (B, PP*page, KV, hd) caches, then run
    the dense version."""
    bt = block_tables.long().clamp(min=0)
    B, PP = bt.shape
    page, KV, hd = k_pool.shape[1], k_pool.shape[2], k_pool.shape[3]
    k = k_pool[bt].reshape(B, PP * page, KV, hd)
    v = v_pool[bt].reshape(B, PP * page, KV, hd)
    return decode_attention_ref(q, k, v, lengths)


def decode_attention_ref(
    q: torch.Tensor,              # (B, H, hd)
    k_cache: torch.Tensor,        # (R, S, KV, hd)
    v_cache: torch.Tensor,        # (R, S, KV, hd)
    lengths: torch.Tensor,        # (B,)
    rows: Optional[torch.Tensor] = None,   # (B,) cache row of each query row
) -> torch.Tensor:
    """``rows=None`` reads cache row b for query row b (R == B)."""
    if rows is not None:
        idx = rows.long().to(k_cache.device)
        k_cache, v_cache = k_cache[idx], v_cache[idx]
    B, H, hd = q.shape
    S, KV = k_cache.shape[1], k_cache.shape[2]
    G = H // KV
    kk = k_cache.repeat_interleave(G, dim=2)
    vv = v_cache.repeat_interleave(G, dim=2)
    s = torch.einsum("bhd,bshd->bhs", q.float(), kk.float())
    s = s / math.sqrt(hd)
    valid = torch.arange(S, device=q.device)[None, :] < lengths.to(q.device)[:, None]
    s = torch.where(valid[:, None, :], s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhs,bshd->bhd", p, vv.float())
    return out.to(q.dtype)

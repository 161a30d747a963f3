"""Wrappers of the CUDA decode kernels (``csrc/decode_attention.cu``).

``decode_attention_cuda`` attends one new query per sequence over a dense
cache; ``paged_decode_attention_cuda`` over a paged pool through a block
table.  They check device, dtype, shape, contiguity and alignment, allocate
the output and the split-KV scratch, and launch on PyTorch's current
stream (two CUDA kernels per call: one CTA per 128-position chunk, then
the log-sum-exp combine).  They take CUDA tensors
only; :mod:`repro_torch.kernels.ops` routes CPU tensors to the plain
versions.
"""
from __future__ import annotations

from typing import Optional

import torch

from .build import library

HEAD_DIMS = (32, 64, 128)
MAX_GROUP = 16
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# Positions per split-KV chunk; the kernel checks that it is its own kChunk.
CHUNK = 128


def check_cuda(name: str, *tensors: torch.Tensor) -> None:
    """Raise unless every tensor is a contiguous, 16-byte aligned CUDA tensor."""
    for t in tensors:
        if not t.is_cuda:
            raise ValueError(f"{name}: expected CUDA tensors, got {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: tensors must be 16-byte aligned")


def check_attention_dtype(name: str, q: torch.Tensor, *kv: torch.Tensor) -> int:
    if q.dtype not in DTYPE_CODES:
        raise ValueError(f"{name}: dtype {q.dtype} not supported "
                         f"(float32, bfloat16)")
    for t in kv:
        if t.dtype != q.dtype:
            raise ValueError(f"{name}: q is {q.dtype} but k/v is {t.dtype}")
    return DTYPE_CODES[q.dtype]


def check_heads(name: str, H: int, KV: int, hd: int) -> None:
    if hd not in HEAD_DIMS:
        raise ValueError(f"{name}: head_dim {hd} not in {HEAD_DIMS}")
    if KV <= 0 or H % KV or H // KV > MAX_GROUP:
        raise ValueError(f"{name}: {H} query heads over {KV} KV heads "
                         f"(group size must divide and be <= {MAX_GROUP})")


def current_stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def raise_on_error(name: str, rc: int) -> None:
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc} at launch")


def split_scratch(q: torch.Tensor, cap: int) -> torch.Tensor:
    """Float scratch for the partial (acc, m, l) of every chunk of a cache
    of ``cap`` positions."""
    B, H, hd = q.shape
    nchunks = -(-cap // CHUNK)
    return torch.empty(B * H * nchunks * (hd + 2), dtype=torch.float32,
                       device=q.device)


def decode_attention_cuda(q: torch.Tensor, k_cache: torch.Tensor,
                          v_cache: torch.Tensor, lengths: torch.Tensor,
                          rows: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q (B, H, hd); caches (R, S, KV, hd); lengths (B,) int32;
    rows (B,) int32, the cache row of each query row (``None``: row b reads
    cache row b, and R == B) -> (B, H, hd).  A row outside ``[0, R)`` reads
    row 0."""
    name = "decode_attention"
    B, H, hd = q.shape
    R, S, KV = k_cache.shape[0], k_cache.shape[1], k_cache.shape[2]
    if (rows is None and R != B) or k_cache.shape != (R, S, KV, hd) \
            or v_cache.shape != k_cache.shape:
        raise ValueError(f"{name}: cache shapes {tuple(k_cache.shape)}, "
                         f"{tuple(v_cache.shape)} do not match q {tuple(q.shape)}")
    if lengths.shape != (B,) or lengths.dtype != torch.int32:
        raise ValueError(f"{name}: lengths must be ({B},) int32")
    if rows is not None and (rows.shape != (B,) or rows.dtype != torch.int32):
        raise ValueError(f"{name}: rows must be ({B},) int32")
    check_heads(name, H, KV, hd)
    code = check_attention_dtype(name, q, k_cache, v_cache)
    check_cuda(name, q, k_cache, v_cache, lengths,
               *(() if rows is None else (rows,)))
    out = torch.empty_like(q)
    scratch = split_scratch(q, S)
    rc = library().repro_decode_attention(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
        None if rows is None else rows.data_ptr(), lengths.data_ptr(),
        out.data_ptr(), scratch.data_ptr(),
        B, H, KV, R, S, hd, CHUNK, code, current_stream())
    raise_on_error(name, rc)
    return out


def paged_decode_attention_cuda(q: torch.Tensor, k_pool: torch.Tensor,
                                v_pool: torch.Tensor,
                                block_tables: torch.Tensor,
                                lengths: torch.Tensor) -> torch.Tensor:
    """q (B, H, hd); pools (P, page, KV, hd); block_tables (B, PP) int32
    (< 0 = unused); lengths (B,) int32 -> (B, H, hd)."""
    name = "paged_decode_attention"
    B, H, hd = q.shape
    P, page, KV = k_pool.shape[0], k_pool.shape[1], k_pool.shape[2]
    if k_pool.shape != (P, page, KV, hd) or v_pool.shape != k_pool.shape:
        raise ValueError(f"{name}: pool shapes {tuple(k_pool.shape)}, "
                         f"{tuple(v_pool.shape)} do not match q {tuple(q.shape)}")
    if block_tables.dim() != 2 or block_tables.shape[0] != B \
            or block_tables.dtype != torch.int32:
        raise ValueError(f"{name}: block_tables must be ({B}, PP) int32")
    if lengths.shape != (B,) or lengths.dtype != torch.int32:
        raise ValueError(f"{name}: lengths must be ({B},) int32")
    check_heads(name, H, KV, hd)
    code = check_attention_dtype(name, q, k_pool, v_pool)
    check_cuda(name, q, k_pool, v_pool, block_tables, lengths)
    PP = block_tables.shape[1]
    out = torch.empty_like(q)
    scratch = split_scratch(q, PP * page)
    rc = library().repro_paged_decode_attention(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        block_tables.data_ptr(), lengths.data_ptr(), out.data_ptr(),
        scratch.data_ptr(), B, H, KV, page, PP, hd, CHUNK, code, current_stream())
    raise_on_error(name, rc)
    return out

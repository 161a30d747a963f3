"""Wrapper of the CUDA prefill kernel (``csrc/flash_attention.cu``):
causal / sliding-window GQA attention forward.  CUDA tensors only;
:mod:`repro_torch.kernels.ops` routes CPU tensors to the plain version."""
from __future__ import annotations

import torch

from .build import library
from .decode_attention import (
    check_attention_dtype,
    check_cuda,
    check_heads,
    current_stream,
    raise_on_error,
)


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         causal: bool = True, window: int = 0) -> torch.Tensor:
    """q (B, Sq, H, hd); k, v (B, Sk, KV, hd) -> (B, Sq, H, hd)."""
    name = "flash_attention"
    B, Sq, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    if k.shape != (B, Sk, KV, hd) or v.shape != k.shape:
        raise ValueError(f"{name}: k/v shapes {tuple(k.shape)}, {tuple(v.shape)} "
                         f"do not match q {tuple(q.shape)}")
    if window < 0:
        raise ValueError(f"{name}: window must be >= 0, got {window}")
    check_heads(name, H, KV, hd)
    code = check_attention_dtype(name, q, k, v)
    check_cuda(name, q, k, v)
    out = torch.empty_like(q)
    rc = library().repro_flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        B, Sq, Sk, H, KV, hd, int(bool(causal)), int(window), code, current_stream())
    raise_on_error(name, rc)
    return out

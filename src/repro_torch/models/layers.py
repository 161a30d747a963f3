"""Dense neural building blocks in PyTorch, translated from the JAX
package's ``models/layers.py``.

Conventions (kept from the JAX package so tests compare like with like):
  * activations: (B, S, D); attention heads as (B, S, H, hd);
  * GQA: H query heads grouped over KV heads via reshape (B, S, KV, G, hd);
  * params are nested dicts of tensors; weights are (in, out), applied as
    ``x @ w``.

``attention_full`` / ``attention_decode`` are the plain layer functions the
JAX model calls; the port's model calls the kernels in
:mod:`repro_torch.kernels.ops` in their place and the tests hold the two
against each other.
"""
from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F

Params = Dict[str, torch.Tensor]

NEG_INF = -1e30


# ---------------------------------------------------------------------------
# Norms / positional
# ---------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    # variance accumulated in float32, the scale cast back to x's dtype
    xf = x.float()
    var = (xf * xf).sum(-1) / x.shape[-1]
    scale = torch.rsqrt(var + eps).to(x.dtype)
    return x * scale[..., None] * w


def rope_freqs(hd: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, hd, 2, dtype=torch.float32, device=device) / hd
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (..., S, H, hd), positions: broadcastable to (..., S)."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)                   # (hd/2,)
    angles = positions[..., None].float() * freqs             # (..., S, hd/2)
    cos = torch.cos(angles)[..., None, :]                     # (..., S, 1, hd/2)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Attention (plain layer functions)
# ---------------------------------------------------------------------------

def attention_full(
    q: torch.Tensor,              # (B, Sq, H, hd)
    k: torch.Tensor,              # (B, Sk, KV, hd)
    v: torch.Tensor,              # (B, Sk, KV, hd)
    causal: bool = True,
    window: int = 0,
) -> torch.Tensor:
    B, Sq, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    vd = v.shape[3]
    G = H // KV
    qg = q.reshape(B, Sq, KV, G, hd)
    scale = 1.0 / math.sqrt(hd)
    scores = torch.einsum("bqkgd,bskd->bkgqs", qg, k).float() * scale
    qpos = torch.arange(Sq, device=q.device)
    kpos = torch.arange(Sk, device=q.device)
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos[None, :] <= qpos[:, None]
    if window:
        mask &= kpos[None, :] > qpos[:, None] - window
    scores = torch.where(mask, scores, torch.full_like(scores, NEG_INF))
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bkgqs,bskd->bqkgd", probs, v)
    return out.reshape(B, Sq, H, vd)


def attention_decode(
    q: torch.Tensor,              # (B, H, hd) — one new token per sequence
    k_cache: torch.Tensor,        # (B, Smax, KV, hd)
    v_cache: torch.Tensor,        # (B, Smax, KV, hd)
    length: torch.Tensor,         # (B,) — valid cache entries
) -> torch.Tensor:
    B, H, hd = q.shape
    KV = k_cache.shape[2]
    vd = v_cache.shape[3]
    G = H // KV
    scale = 1.0 / math.sqrt(hd)
    qg = q.reshape(B, KV, G, hd)
    s = torch.einsum("bkgd,bskd->bkgs", qg, k_cache).float() * scale
    valid = (torch.arange(k_cache.shape[1], device=q.device)[None, :]
             < length.reshape(-1, 1).to(q.device))
    s = torch.where(valid[:, None, None, :], s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1).to(v_cache.dtype)
    out = torch.einsum("bkgs,bskd->bkgd", p, v_cache)
    return out.reshape(B, H, vd)


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------

def mlp_apply(x: torch.Tensor, p: Params, mlp_type: str) -> torch.Tensor:
    if mlp_type == "swiglu":
        h = F.silu(x @ p["w_gate"]) * (x @ p["w_up"])
        return h @ p["w_down"]
    if mlp_type == "squared_relu":
        h = torch.square(torch.relu(x @ p["w_up"]))
        return h @ p["w_down"]
    if mlp_type == "gelu":
        h = F.gelu(x @ p["w_up"], approximate="tanh")
        return h @ p["w_down"]
    raise ValueError(mlp_type)


def normal(shape, scale: float, dtype: torch.dtype,
           generator: torch.Generator) -> torch.Tensor:
    """``N(0, scale^2)`` drawn in float32 on the generator's device, cast to
    ``dtype``."""
    x = torch.randn(shape, generator=generator, device=generator.device,
                    dtype=torch.float32)
    return (x * scale).to(dtype)


def mlp_init(generator: torch.Generator, d: int, d_ff: int, mlp_type: str,
             dtype: torch.dtype) -> Params:
    scale_in = 1.0 / math.sqrt(d)
    scale_out = 1.0 / math.sqrt(d_ff)
    p = {
        "w_up": normal((d, d_ff), scale_in, dtype, generator),
        "w_down": normal((d_ff, d), scale_out, dtype, generator),
    }
    if mlp_type == "swiglu":
        p["w_gate"] = normal((d, d_ff), scale_in, dtype, generator)
    return p

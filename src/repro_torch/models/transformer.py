"""Dense decoder blocks in PyTorch, translated from the JAX package's
``models/transformer.py``.

The stack is a sequence of *stages*: maximal runs of identically-structured
layers, as in the JAX package.  This slice ports the ``dense`` kind with
full (causal) attention; every other kind raises ``NotImplementedError``
naming the ROADMAP item that ports it.

Caches are written in place where the JAX package used ``.at[].set`` /
``dynamic_update_slice``: a layer's cache dict holds views into the
engine's buffers, and the blocks below write into them.  Attention runs
through :mod:`repro_torch.kernels.ops` — the CUDA kernels on the card, the
plain versions on the CPU.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from .layers import apply_rope, mlp_apply, mlp_init, normal, rms_norm

Params = Dict[str, Any]
Cache = Dict[str, torch.Tensor]

# ROADMAP ("Modules to port") item that ports each kind this slice lacks
PENDING = {
    "moe": "item 8 (MoE for dbrx and deepseek)",
    "mla": "item 8 (MLA for deepseek-v3)",
    "mlstm": "item 8 (recurrent blocks: mLSTM)",
    "slstm": "item 8 (recurrent blocks: sLSTM)",
    "hybrid_swa": "item 8 (recurrent blocks: hymba's hybrid SSM)",
    "hybrid_global": "item 8 (recurrent blocks: hymba's hybrid SSM)",
    "swa": "item 8 (sliding-window attention with its ring cache)",
    "frontend": "item 8 (frontends: patch_embeds / embeds)",
}


def not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to repro_torch yet: ROADMAP queue 1, {PENDING[what]}")


# ---------------------------------------------------------------------------
# Stage structure
# ---------------------------------------------------------------------------

def layer_kind(cfg: ModelConfig, l: int) -> str:
    if cfg.family == "ssm":
        every = cfg.ssm.slstm_every or 0
        return "slstm" if (every and l % every == 0) else "mlstm"
    if cfg.family == "hybrid":
        return "hybrid_global" if l in cfg.global_attn_layers else "hybrid_swa"
    if cfg.is_moe_layer(l):
        return "moe"
    return "dense"


@dataclasses.dataclass(frozen=True)
class Stage:
    kind: str
    count: int
    first_layer: int


def stages(cfg: ModelConfig) -> List[Stage]:
    out: List[Stage] = []
    for l in range(cfg.num_layers):
        k = layer_kind(cfg, l)
        if out and out[-1].kind == k:
            out[-1] = Stage(k, out[-1].count + 1, out[-1].first_layer)
        else:
            out.append(Stage(k, 1, l))
    return out


def check_supported(cfg: ModelConfig) -> None:
    """Raise unless every layer of ``cfg`` is a kind this slice ports."""
    for st in stages(cfg):
        if st.kind != "dense":
            raise not_ported(st.kind)
    if cfg.attn_type == "mla":
        raise not_ported("mla")
    if cfg.attn_type == "swa":
        raise not_ported("swa")
    if cfg.embed_frontend:
        raise not_ported("frontend")


# ---------------------------------------------------------------------------
# Block parameter init
# ---------------------------------------------------------------------------

def _dense_attn_init(cfg: ModelConfig, generator: torch.Generator,
                     dtype: torch.dtype) -> Params:
    D, H, KV, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.hd
    dev = generator.device
    s = 1.0 / math.sqrt(D)
    p: Params = {
        "ln1": torch.ones((D,), dtype=dtype, device=dev),
        "wq": normal((D, H * hd), s, dtype, generator),
        "wk": normal((D, KV * hd), s, dtype, generator),
        "wv": normal((D, KV * hd), s, dtype, generator),
        "wo": normal((H * hd, D), 1.0 / math.sqrt(H * hd), dtype, generator),
    }
    if cfg.qkv_bias:
        p["bq"] = torch.zeros((H * hd,), dtype=dtype, device=dev)
        p["bk"] = torch.zeros((KV * hd,), dtype=dtype, device=dev)
        p["bv"] = torch.zeros((KV * hd,), dtype=dtype, device=dev)
    if cfg.qk_norm:
        p["q_norm"] = torch.ones((hd,), dtype=dtype, device=dev)
        p["k_norm"] = torch.ones((hd,), dtype=dtype, device=dev)
    return p


def init_block(cfg: ModelConfig, kind: str, generator: torch.Generator) -> Params:
    """One layer's parameters, drawn from ``generator`` on its device."""
    if kind != "dense":
        raise not_ported(kind)
    dtype = getattr(torch, cfg.dtype)
    p = _dense_attn_init(cfg, generator, dtype)
    p["ln2"] = torch.ones((cfg.d_model,), dtype=dtype, device=generator.device)
    if cfg.d_ff > 0:
        p["mlp"] = mlp_init(generator, cfg.d_model, cfg.d_ff, cfg.mlp_type, dtype)
    return p


# ---------------------------------------------------------------------------
# Caches
# ---------------------------------------------------------------------------

def init_layer_cache(cfg: ModelConfig, kind: str, batch: int, max_seq: int,
                     device) -> Cache:
    """Zeroed K/V of one layer: ``(batch, max_seq, KV, hd)`` each."""
    if kind != "dense":
        raise not_ported(kind)
    if cfg.attn_type != "full":
        raise not_ported("swa" if cfg.attn_type == "swa" else "mla")
    shape = (batch, max_seq, cfg.num_kv_heads, cfg.hd)
    dtype = getattr(torch, cfg.dtype)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


# ---------------------------------------------------------------------------
# Sequence (train / prefill) block application
# ---------------------------------------------------------------------------

def _qkv(cfg: ModelConfig, p: Params, x: torch.Tensor):
    xn = rms_norm(x, p["ln1"])
    q = xn @ p["wq"]
    k = xn @ p["wk"]
    v = xn @ p["wv"]
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    return q, k, v


def dense_block_seq(cfg: ModelConfig, p: Params, x: torch.Tensor,
                    positions: torch.Tensor, cache: Optional[Cache]) -> torch.Tensor:
    """Attention half of a dense block over a sequence.  With ``cache``, the
    sequence's K/V are written into its first S positions in place."""
    B, S, D = x.shape
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.hd
    q, k, v = _qkv(cfg, p, x)
    q = q.reshape(B, S, H, hd)
    k = k.reshape(B, S, KV, hd)
    v = v.reshape(B, S, KV, hd)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"])
        k = rms_norm(k, p["k_norm"])
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    if cache is not None:
        cache["k"][:, :S] = k
        cache["v"][:, :S] = v
    attn = ops.flash_attention(q, k, v, causal=True)
    return attn.reshape(B, S, H * hd) @ p["wo"]


def _ffn(cfg: ModelConfig, p: Params, x: torch.Tensor) -> torch.Tensor:
    if "mlp" in p:
        x = x + mlp_apply(rms_norm(x, p["ln2"]), p["mlp"], cfg.mlp_type)
    return x


def block_seq(cfg: ModelConfig, kind: str, p: Params, x: torch.Tensor,
              positions: torch.Tensor, cache: Optional[Cache]) -> torch.Tensor:
    if kind != "dense":
        raise not_ported(kind)
    return _ffn(cfg, p, x + dense_block_seq(cfg, p, x, positions, cache))


# ---------------------------------------------------------------------------
# Decode block application (one token, cache read/update)
# ---------------------------------------------------------------------------

def _qkv_decode(cfg: ModelConfig, p: Params, x_t: torch.Tensor,
                lengths: torch.Tensor):
    B = x_t.shape[0]
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.hd
    q, k, v = _qkv(cfg, p, x_t)
    q = q.reshape(B, H, hd)
    k = k.reshape(B, KV, hd)
    v = v.reshape(B, KV, hd)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"])
        k = rms_norm(k, p["k_norm"])
    pos = lengths.reshape(B, 1)
    q = apply_rope(q[:, None], pos, cfg.rope_theta)[:, 0]
    k = apply_rope(k[:, None], pos, cfg.rope_theta)[:, 0]
    return q, k, v


def dense_block_decode(cfg: ModelConfig, p: Params, x_t: torch.Tensor,
                       lengths: torch.Tensor, cache: Cache,
                       rows: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One token per row over a dense cache ``(R, Smax, KV, hd)``: row b's
    new K/V are written at ``(rows[b], lengths[b])`` in place, then the
    decode kernel attends over ``lengths + 1`` positions of cache row
    ``rows[b]``.  ``rows=None`` means row b (R == B).  Rows are addressed
    in place: no cache row is gathered or scattered."""
    B = x_t.shape[0]
    q, k, v = _qkv_decode(cfg, p, x_t, lengths)
    idx = torch.arange(B, device=x_t.device) if rows is None else rows.long()
    pos = lengths.long()
    cache["k"][idx, pos] = k
    cache["v"][idx, pos] = v
    out = ops.decode_attention(q, cache["k"], cache["v"],
                               (lengths + 1).to(torch.int32), rows)
    return out.reshape(B, -1) @ p["wo"]


def dense_block_decode_paged(cfg: ModelConfig, p: Params, x_t: torch.Tensor,
                             lengths: torch.Tensor, pool: Cache,
                             block_tables: torch.Tensor,
                             write_page: torch.Tensor,
                             write_off: torch.Tensor) -> torch.Tensor:
    """One token per row over a paged pool ``(P+1, page, KV, hd)``: the new
    K/V are written at ``(write_page, write_off)`` in place, then the paged
    decode kernel attends through ``block_tables``.  No dense copy of the
    cache is made."""
    B = x_t.shape[0]
    q, k, v = _qkv_decode(cfg, p, x_t, lengths)
    pool["k"][write_page, write_off] = k
    pool["v"][write_page, write_off] = v
    out = ops.paged_decode_attention(q, pool["k"], pool["v"], block_tables,
                                     (lengths + 1).to(torch.int32))
    return out.reshape(B, -1) @ p["wo"]


def block_decode(cfg: ModelConfig, kind: str, p: Params, x_t: torch.Tensor,
                 lengths: torch.Tensor, cache: Cache,
                 rows: Optional[torch.Tensor] = None) -> torch.Tensor:
    if kind != "dense":
        raise not_ported(kind)
    x_t = x_t + dense_block_decode(cfg, p, x_t, lengths, cache, rows)
    return _ffn(cfg, p, x_t)


def block_decode_paged(cfg: ModelConfig, kind: str, p: Params,
                       x_t: torch.Tensor, lengths: torch.Tensor, pool: Cache,
                       block_tables: torch.Tensor, write_page: torch.Tensor,
                       write_off: torch.Tensor) -> torch.Tensor:
    if kind != "dense":
        raise not_ported(kind)
    x_t = x_t + dense_block_decode_paged(cfg, p, x_t, lengths, pool,
                                         block_tables, write_page, write_off)
    return _ffn(cfg, p, x_t)

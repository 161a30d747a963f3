"""Model configuration schema shared by all architectures.

A config fully determines parameter shapes, the layer-stage structure
(homogeneous stacks are scanned; heterogeneous stacks become explicit stage
sequences), and the serving-layer block metrics (s_m / s_c of the paper).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Sequence, Tuple


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    num_shared_experts: int = 0
    capacity_factor: float = 1.25
    # layers [0, first_k_dense) use a dense FFN (DeepSeek-V3 style)
    first_k_dense: int = 0
    router_dtype: str = "float32"


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    rope_head_dim: int = 64
    nope_head_dim: int = 128
    v_head_dim: int = 128


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    """Mamba-style selective SSM (hymba) / xLSTM settings."""
    state_dim: int = 16          # N per channel (mamba) — 0 if unused
    conv_width: int = 4
    # xLSTM: pattern of sLSTM blocks; every `slstm_every`-th layer is sLSTM
    slstm_every: int = 0
    # hymba: number of parallel SSM heads fused with attention heads
    parallel_ssm: bool = False
    expand: int = 1              # d_inner = expand * d_model


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | ssm | hybrid | vlm | audio | moe
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None
    # attention
    attn_type: str = "full"          # full | swa | mla
    window: int = 0                  # SWA window (attn_type == "swa")
    global_attn_layers: Tuple[int, ...] = ()   # full-attn layers in an SWA model
    qk_norm: bool = False
    qkv_bias: bool = False
    rope_theta: float = 1e4
    # ffn
    mlp_type: str = "swiglu"         # swiglu | squared_relu | gelu
    # sub-configs
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    ssm: Optional[SSMConfig] = None
    # frontend stub: inputs are precomputed embeddings instead of token ids
    embed_frontend: bool = False
    num_prefix_embeds: int = 0       # e.g. ViT patch embeddings prepended
    tie_embeddings: bool = False
    dtype: str = "bfloat16"
    # execution knobs (hillclimb surface; see EXPERIMENTS.md §Perf)
    attn_chunk_threshold: int = 8192   # use chunked attention for S >= this
    attn_q_chunk: int = 1024
    attn_k_chunk: int = 1024
    scan_layers: bool = True
    remat: str = "none"              # none | full | dots
    # layers recomputed together per checkpoint block: >1 shrinks the saved
    # carry stack (and XLA's hoisted f32 convert of it) proportionally.
    layers_per_remat_block: int = 1
    use_pallas: bool = False         # TPU path; CPU dry-run uses jnp reference

    # -- derived -------------------------------------------------------------
    @property
    def hd(self) -> int:
        if self.head_dim is not None:
            return self.head_dim
        return self.d_model // self.num_heads

    @property
    def q_groups(self) -> int:
        return self.num_heads // self.num_kv_heads

    # -- parameter accounting (drives the serving control plane + roofline) --
    def layer_param_count(self, layer_idx: int = 0) -> int:
        """Parameters in one decoder block (attention/mixer + FFN + norms)."""
        D, H, KV, hd, F = self.d_model, self.num_heads, self.num_kv_heads, self.hd, self.d_ff
        n = 2 * D                                     # two RMSNorms
        if self.attn_type == "mla":
            m = self.mla
            qh = m.nope_head_dim + m.rope_head_dim
            n += D * m.q_lora_rank + m.q_lora_rank * H * qh
            n += D * (m.kv_lora_rank + m.rope_head_dim)
            n += m.kv_lora_rank * H * (m.nope_head_dim + m.v_head_dim)
            n += H * m.v_head_dim * D
        else:
            n += D * H * hd + 2 * D * KV * hd + H * hd * D
            if self.qkv_bias:
                n += (H + 2 * KV) * hd
        if self.ssm is not None and (self.family in ("ssm", "hybrid")):
            d_in = self.ssm.expand * D
            if self.ssm.slstm_every:   # xlstm mLSTM block approximation
                n += 3 * D * d_in + d_in * D + 4 * d_in
            else:                      # mamba-style branch (hymba)
                N = self.ssm.state_dim
                n += D * d_in * 2 + d_in * self.ssm.conv_width
                n += d_in * (2 * N + 1) + d_in + d_in * D
        if self.is_moe_layer(layer_idx):
            mo = self.moe
            per_exp = 3 * D * F if self.mlp_type == "swiglu" else 2 * D * F
            n += (mo.num_experts + mo.num_shared_experts) * per_exp
            n += D * mo.num_experts   # router
        elif self.d_ff > 0:
            n += 3 * D * F if self.mlp_type == "swiglu" else 2 * D * F
        return n

    def is_moe_layer(self, layer_idx: int) -> bool:
        return self.moe is not None and layer_idx >= self.moe.first_k_dense

    def active_layer_param_count(self, layer_idx: int = 0) -> int:
        """Params touched per token (MoE: shared + top_k experts only)."""
        n = self.layer_param_count(layer_idx)
        if self.is_moe_layer(layer_idx):
            mo = self.moe
            D, F = self.d_model, self.d_ff
            per_exp = 3 * D * F if self.mlp_type == "swiglu" else 2 * D * F
            n -= (mo.num_experts - mo.top_k) * per_exp
        return n

    def total_param_count(self) -> int:
        n = self.vocab_size * self.d_model          # embedding
        if not self.tie_embeddings:
            n += self.vocab_size * self.d_model     # lm head
        n += self.d_model                           # final norm
        for i in range(self.num_layers):
            n += self.layer_param_count(i)
        return n

    def active_param_count(self) -> int:
        n = self.vocab_size * self.d_model
        if not self.tie_embeddings:
            n += self.vocab_size * self.d_model
        n += self.d_model
        for i in range(self.num_layers):
            n += self.active_layer_param_count(i)
        return n

    def kv_bytes_per_token_per_layer(self, bytes_per_el: int = 2) -> float:
        """s_c per token: decode-time cache bytes per token per layer."""
        if self.attn_type == "mla":
            m = self.mla
            return (m.kv_lora_rank + m.rope_head_dim) * bytes_per_el
        per_tok = 2 * self.num_kv_heads * self.hd * bytes_per_el
        return per_tok

    def block_bytes(self, bytes_per_el: int = 2, layer_idx: int = 0) -> float:
        """s_m: weight bytes of one block."""
        return self.layer_param_count(layer_idx) * bytes_per_el

    def reduced(self, **overrides) -> "ModelConfig":
        """A tiny same-family config for CPU smoke tests."""
        changes: Dict = dict(
            num_layers=min(self.num_layers, 4),
            d_model=128,
            num_heads=4,
            num_kv_heads=min(self.num_kv_heads, 2) if self.num_kv_heads < self.num_heads else 4,
            head_dim=32,
            d_ff=256 if self.d_ff else 0,
            vocab_size=512,
            window=min(self.window, 64) if self.window else 0,
            attn_chunk_threshold=64,
            attn_q_chunk=32,
            attn_k_chunk=32,
        )
        if self.global_attn_layers:
            changes["global_attn_layers"] = (0, changes["num_layers"] - 1)
        if self.moe is not None:
            # capacity_factor = E/k makes the reduced config drop-free, so
            # smoke tests can assert exact seq-vs-decode consistency.
            changes["moe"] = dataclasses.replace(
                self.moe,
                num_experts=4,
                top_k=2,
                first_k_dense=min(self.moe.first_k_dense, 1),
                capacity_factor=2.0,
            )
        if self.mla is not None:
            changes["mla"] = MLAConfig(
                q_lora_rank=64, kv_lora_rank=32, rope_head_dim=16,
                nope_head_dim=32, v_head_dim=32,
            )
        if self.ssm is not None:
            changes["ssm"] = dataclasses.replace(
                self.ssm,
                state_dim=min(self.ssm.state_dim, 8) or 0,
                slstm_every=min(self.ssm.slstm_every, 2) if self.ssm.slstm_every else 0,
            )
        changes.update(overrides)
        return dataclasses.replace(self, name=self.name + "-smoke", **changes)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str               # "train" | "prefill" | "decode"


SHAPES: Dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}


def supports_shape(cfg: ModelConfig, shape: ShapeConfig) -> Tuple[bool, str]:
    """Whether (arch, shape) is a runnable cell; reason string if not.

    long_500k requires sub-quadratic attention: run for SSM/hybrid archs; as a
    documented bonus also for MLA (deepseek-v3) whose 576-element/token latent
    KV makes a 512k context feasible; skip for pure full-attention archs."""
    if shape.name == "long_500k":
        if cfg.family in ("ssm", "hybrid"):
            return True, ""
        if cfg.attn_type == "mla":
            return True, "bonus: MLA latent cache makes 512k feasible"
        return False, "pure full-attention arch: O(S^2)/O(S)-per-token at 512k is not servable"
    return True, ""

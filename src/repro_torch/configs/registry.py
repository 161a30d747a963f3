"""Architecture registry: all ten assigned configs + the paper's own model.

Sources are cited per entry (tier noted in the assignment):
  nemotron-4-15b   [arXiv:2402.16819]       qwen3-8b        [hf:Qwen/Qwen3-8B]
  stablelm-1.6b    [hf:stabilityai/...]     qwen2-7b        [arXiv:2407.10671]
  xlstm-350m       [arXiv:2405.04517]       hymba-1.5b      [arXiv:2411.13676]
  internvl2-76b    [arXiv:2404.16821]       musicgen-medium [arXiv:2306.05284]
  dbrx-132b        [hf:databricks/dbrx]     deepseek-v3-671b [arXiv:2412.19437]
  bloom-176b       [arXiv:2211.05100]       (paper's evaluation model, L=70)
"""
from __future__ import annotations

from typing import Dict

from .base import MLAConfig, ModelConfig, MoEConfig, SSMConfig

ARCHS: Dict[str, ModelConfig] = {}


def _register(cfg: ModelConfig) -> ModelConfig:
    ARCHS[cfg.name] = cfg
    return cfg


NEMOTRON_4_15B = _register(ModelConfig(
    name="nemotron-4-15b", family="dense",
    num_layers=32, d_model=6144, num_heads=48, num_kv_heads=8,
    d_ff=24576, vocab_size=256000, head_dim=128,
    mlp_type="squared_relu", rope_theta=1e4,
))

QWEN3_8B = _register(ModelConfig(
    name="qwen3-8b", family="dense",
    num_layers=36, d_model=4096, num_heads=32, num_kv_heads=8,
    d_ff=12288, vocab_size=151936, head_dim=128,
    qk_norm=True, mlp_type="swiglu", rope_theta=1e6,
))

STABLELM_1_6B = _register(ModelConfig(
    name="stablelm-1.6b", family="dense",
    num_layers=24, d_model=2048, num_heads=32, num_kv_heads=32,
    d_ff=5632, vocab_size=100352, head_dim=64,
    mlp_type="swiglu", rope_theta=1e4,
))

QWEN2_7B = _register(ModelConfig(
    name="qwen2-7b", family="dense",
    num_layers=28, d_model=3584, num_heads=28, num_kv_heads=4,
    d_ff=18944, vocab_size=152064, head_dim=128,
    qkv_bias=True, mlp_type="swiglu", rope_theta=1e6,
))

XLSTM_350M = _register(ModelConfig(
    name="xlstm-350m", family="ssm",
    num_layers=24, d_model=1024, num_heads=4, num_kv_heads=4,
    d_ff=0, vocab_size=50304, head_dim=256,
    mlp_type="gelu",
    ssm=SSMConfig(state_dim=0, slstm_every=6, expand=1),
))

HYMBA_1_5B = _register(ModelConfig(
    name="hymba-1.5b", family="hybrid",
    num_layers=32, d_model=1600, num_heads=25, num_kv_heads=5,
    d_ff=5504, vocab_size=32001, head_dim=64,
    attn_type="swa", window=1024, global_attn_layers=(0, 15, 31),
    mlp_type="swiglu",
    ssm=SSMConfig(state_dim=16, conv_width=4, parallel_ssm=True, expand=1),
))

INTERNVL2_76B = _register(ModelConfig(
    name="internvl2-76b", family="vlm",
    num_layers=80, d_model=8192, num_heads=64, num_kv_heads=8,
    d_ff=28672, vocab_size=128256, head_dim=128,
    mlp_type="swiglu", rope_theta=5e5,
    embed_frontend=True, num_prefix_embeds=256,   # InternViT patch embeds (stub)
))

MUSICGEN_MEDIUM = _register(ModelConfig(
    name="musicgen-medium", family="audio",
    num_layers=48, d_model=1536, num_heads=24, num_kv_heads=24,
    d_ff=6144, vocab_size=2048, head_dim=64,
    mlp_type="gelu",
    embed_frontend=True, num_prefix_embeds=0,     # EnCodec frame embeds (stub)
))

DBRX_132B = _register(ModelConfig(
    name="dbrx-132b", family="moe",
    num_layers=40, d_model=6144, num_heads=48, num_kv_heads=8,
    d_ff=10752, vocab_size=100352, head_dim=128,
    mlp_type="swiglu", rope_theta=5e5,
    moe=MoEConfig(num_experts=16, top_k=4),
))

DEEPSEEK_V3_671B = _register(ModelConfig(
    name="deepseek-v3-671b", family="moe",
    num_layers=61, d_model=7168, num_heads=128, num_kv_heads=128,
    d_ff=2048, vocab_size=129280, head_dim=128,
    attn_type="mla", mlp_type="swiglu", rope_theta=1e4,
    mla=MLAConfig(q_lora_rank=1536, kv_lora_rank=512,
                  rope_head_dim=64, nope_head_dim=128, v_head_dim=128),
    moe=MoEConfig(num_experts=256, top_k=8, num_shared_experts=1,
                  first_k_dense=3),
))

# The paper's own evaluation model (BLOOM-176B, L=70; Section 4.1.1).
BLOOM_176B = _register(ModelConfig(
    name="bloom-176b", family="dense",
    num_layers=70, d_model=14336, num_heads=112, num_kv_heads=112,
    d_ff=4 * 14336, vocab_size=250880, head_dim=128,
    mlp_type="gelu", tie_embeddings=True,
))

ASSIGNED = [
    "nemotron-4-15b", "qwen3-8b", "stablelm-1.6b", "qwen2-7b", "xlstm-350m",
    "hymba-1.5b", "internvl2-76b", "musicgen-medium", "dbrx-132b",
    "deepseek-v3-671b",
]


def get(name: str) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch '{name}'; available: {sorted(ARCHS)}")
    return ARCHS[name]

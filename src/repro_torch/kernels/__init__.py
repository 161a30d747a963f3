"""Hand-written CUDA kernels for the serving data plane's hot spots:

  * flash_attention — prefill attention (causal/SWA, GQA)
  * decode_attention — flash decoding over the slotted KV cache
  * paged_decode_attention — the same sweep through a block table over the
    paged pool

Each has a plain PyTorch version in ``ref.py``; ``ops.py`` dispatches by
device and counts launches.
"""
from .ops import LAUNCHES, decode_attention, flash_attention, paged_decode_attention

__all__ = ["LAUNCHES", "decode_attention", "flash_attention", "paged_decode_attention"]

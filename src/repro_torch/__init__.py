"""PyTorch port of the chain-serving data plane, for one NVIDIA H100.

The package mirrors the JAX package's layout (``configs``, ``core``,
``kernels``, ``models``, ``serving``, ``launch``) and imports nothing from
it: framework-free control-plane modules are copied.  The three Pallas
kernels of the serving path are hand-written CUDA kernels here
(``kernels/csrc``), each with a plain PyTorch version that CPU tensors use.
"""
from .device import resolve_device

__all__ = ["resolve_device"]

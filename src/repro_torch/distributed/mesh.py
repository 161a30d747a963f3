"""Stage placement for pipeline-parallel serving, translated from the JAX
package's ``distributed/mesh.py``.

The pipeline engine (serving/pipeline.py) runs each chain hop's layer range
as a stage on one device.  ``stage_devices`` assigns them round-robin over
a device list: every visible CUDA card in index order by default (the
counterpart of ``jax.local_devices()``), or the model's own device when the
model is on the CPU.  The JAX package's ``stage_mesh`` and
``ensure_host_device_flag`` set up XLA's virtual devices and have no
counterpart here (ROADMAP queue 1, item 11).
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import torch

from repro_torch.device import DeviceLike, resolve_device


def stage_devices(num_stages: int, devices: Optional[Sequence] = None,
                  model_device: DeviceLike = None) -> List:
    """One device per pipeline stage, cycling round-robin when there are
    fewer devices than stages (stages that share a device still pipeline
    correctly; they share its throughput).  ``devices=None`` means every
    visible card in index order for a model on the card (``model_device``,
    the card unless the CPU is named), and the CPU for a model on the CPU."""
    if num_stages < 1:
        raise ValueError(f"num_stages must be >= 1, got {num_stages}")
    if devices is None:
        home = resolve_device(model_device)
        devices = ([torch.device("cuda", i) for i in range(torch.cuda.device_count())]
                   if home.type == "cuda" else [home])
    devs = list(devices)
    if not devs:
        raise ValueError("no devices to place pipeline stages on")
    return [devs[k % len(devs)] for k in range(num_stages)]

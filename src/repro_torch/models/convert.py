"""Parameters between the JAX package's layout and the port's.

The JAX ``Model.init`` (models/model.py of the JAX package) returns
``{"embed", "final_norm", ["lm_head"], "stages": [stage, ...]}`` where each
stage is a nested dict of arrays stacked on a leading layer axis.  The port
keeps ``{"embed", "final_norm", ["lm_head"], "layers": [layer, ...]}`` with
one nested dict per layer.  Leaf names and per-layer shapes are the same.
This module is the only place that knows both layouts; it takes and gives
numpy arrays, so it needs no JAX.
"""
from __future__ import annotations

from typing import Any, Dict, List

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike, resolve_device
from .transformer import stages


def _tensor(a: np.ndarray, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    # bfloat16 numpy arrays (ml_dtypes) have no torch counterpart in numpy
    # interop; float32 holds every bfloat16 value exactly.
    arr = np.asarray(a)
    if arr.dtype.name == "bfloat16":
        arr = arr.astype(np.float32)
    return torch.tensor(arr).to(device=device, dtype=dtype)


def _map(tree: Any, fn) -> Any:
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    return fn(tree)


def params_from_jax(np_params: Dict[str, Any], cfg: ModelConfig,
                    device: DeviceLike = None) -> Dict[str, Any]:
    """The JAX parameter pytree (as numpy arrays) as the port's parameters,
    in ``cfg.dtype`` on ``device`` (the card unless ``"cpu"`` is asked for)."""
    dev = resolve_device(device)
    dtype = getattr(torch, cfg.dtype)
    out: Dict[str, Any] = {k: _tensor(v, dtype, dev)
                           for k, v in np_params.items() if k != "stages"}
    layers: List[Dict[str, Any]] = []
    sts = stages(cfg)
    if len(np_params["stages"]) != len(sts):
        raise ValueError(f"{len(np_params['stages'])} parameter stages, "
                         f"{cfg.name} has {len(sts)}")
    for st, sp in zip(sts, np_params["stages"]):
        for j in range(st.count):
            layers.append(_map(sp, lambda a, j=j: _tensor(np.asarray(a)[j], dtype, dev)))
    out["layers"] = layers
    return out


def params_to_jax(params: Dict[str, Any], cfg: ModelConfig) -> Dict[str, Any]:
    """The inverse: the port's parameters as the JAX pytree of float32
    numpy arrays (per-stage stacks on a leading layer axis)."""
    def host(t: torch.Tensor) -> np.ndarray:
        return t.detach().float().cpu().numpy()

    out: Dict[str, Any] = {k: host(v) for k, v in params.items() if k != "layers"}
    out["stages"] = [
        _stack(params["layers"][st.first_layer:st.first_layer + st.count], host)
        for st in stages(cfg)]
    return out


def _stack(layers: List[Dict[str, Any]], host) -> Dict[str, Any]:
    first = layers[0]
    return {k: (_stack([l[k] for l in layers], host) if isinstance(v, dict)
                else np.stack([host(l[k]) for l in layers]))
            for k, v in first.items()}

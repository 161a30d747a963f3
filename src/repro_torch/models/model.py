"""Model facade: init / forward / prefill / decode over the dense stack,
translated from the JAX package's ``models/model.py``.

Parameters are a plain dict: ``embed`` (V, D), ``final_norm`` (D,),
``lm_head`` (D, V) unless the embedding is tied, and ``layers``, a list
with one dict per layer (``convert.params_from_jax`` maps the JAX
package's per-stage stacks onto it).  Caches keep the JAX layout: one dict
per stage with ``k`` / ``v`` of shape ``(layers, B, S, KV, hd)``; paged
pools ``(layers, P+1, page, KV, hd)``.  Prefill and decode write the caches
in place.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Iterator, List, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike, resolve_device
from .layers import normal, rms_norm
from .transformer import (
    Cache,
    Params,
    Stage,
    block_decode,
    block_decode_paged,
    block_seq,
    check_supported,
    init_block,
    init_layer_cache,
    not_ported,
    stages,
)


class Model:
    """The dense decoder of ``cfg`` on one device (the card unless
    ``device="cpu"`` is asked for)."""

    def __init__(self, cfg: ModelConfig, device: DeviceLike = None):
        check_supported(cfg)
        self.cfg = cfg
        self.device = resolve_device(device)
        self.stages = stages(cfg)
        self.dtype = getattr(torch, cfg.dtype)
        self._all = LayerSlice(self, 0, cfg.num_layers)

    # -- parameters -----------------------------------------------------------
    def init(self, generator: torch.Generator) -> Params:
        """Random parameters drawn from ``generator``, on this model's
        device.  A generator on the same device avoids a host round trip."""
        cfg = self.cfg
        params: Params = {
            "embed": normal((cfg.vocab_size, cfg.d_model), 0.02, self.dtype,
                            generator),
            "final_norm": torch.ones((cfg.d_model,), dtype=self.dtype,
                                     device=generator.device),
        }
        if not cfg.tie_embeddings:
            params["lm_head"] = normal((cfg.d_model, cfg.vocab_size),
                                       1.0 / math.sqrt(cfg.d_model),
                                       self.dtype, generator)
        params["layers"] = [init_block(cfg, st.kind, generator)
                            for st in self.stages for _ in range(st.count)]
        return _to_device(params, self.device)

    # -- embedding / head ------------------------------------------------------
    def embed_inputs(self, params: Params, batch: Dict[str, Any]) -> torch.Tensor:
        if "patch_embeds" in batch or "embeds" in batch:
            raise not_ported("frontend")
        return params["embed"][batch["tokens"].long()]

    def logits(self, params: Params, x: torch.Tensor) -> torch.Tensor:
        x = rms_norm(x, params["final_norm"])
        head = params["embed"].T if self.cfg.tie_embeddings else params["lm_head"]
        return x @ head

    def embed_tokens(self, params: Params, token: torch.Tensor) -> torch.Tensor:
        """Embeddings of (B,) token ids, (B, D): the decode path's input."""
        return params["embed"][token.long()]

    # -- sequence forward (train / prefill) ------------------------------------
    @torch.no_grad()
    def forward_train(self, params: Params, batch: Dict[str, Any]) -> torch.Tensor:
        """Logits at every position, (B, S, V)."""
        x = self.embed_inputs(params, batch)
        return self.logits(params, self._all.seq_blocks(params, None, x))

    # -- prefill ----------------------------------------------------------------
    def init_cache(self, batch: int, max_seq: int,
                   device: DeviceLike = None) -> List[Cache]:
        return self._all.init_cache(batch, max_seq, device)

    @torch.no_grad()
    def prefill(self, params: Params, cache: List[Cache],
                batch: Dict[str, Any]) -> Tuple[torch.Tensor, List[Cache]]:
        """Run the prompt, write its K/V into ``cache`` in place, return
        the last position's logits."""
        x = self.embed_inputs(params, batch)
        x = self._all.seq_blocks(params, cache, x)
        return self.logits(params, x[:, -1]), cache

    # -- decode -------------------------------------------------------------------
    @torch.no_grad()
    def decode_step(self, params: Params, cache: List[Cache],
                    token: torch.Tensor, lengths: torch.Tensor
                    ) -> Tuple[torch.Tensor, List[Cache]]:
        """token: (B,) ids; lengths: (B,) current context lengths.  Writes
        each row's new K/V at position ``lengths`` in place."""
        x = self._all.decode_blocks(params, cache,
                                    self.embed_tokens(params, token), lengths)
        return self.logits(params, x), cache

    @torch.no_grad()
    def decode_step_paged(self, params: Params, pools: List[Cache],
                          token: torch.Tensor, lengths: torch.Tensor,
                          block_tables: torch.Tensor, write_page: torch.Tensor,
                          write_off: torch.Tensor) -> torch.Tensor:
        """Decode over paged pools ``(layers, P+1, page, KV, hd)``: each row
        writes its new K/V at ``(write_page, write_off)`` in place and
        attends through its ``block_tables`` row (int32 page ids) over
        ``lengths + 1`` positions.  Returns the logits."""
        x = self._all.decode_blocks_paged(
            params, pools, self.embed_tokens(params, token), lengths,
            block_tables, write_page, write_off)
        return self.logits(params, x)

    # -- layer slicing (pipeline stages) ------------------------------------------
    def layer_slice(self, lo: int, hi: int) -> "LayerSlice":
        """A view over the contiguous global layer range ``[lo, hi)``: the
        unit a pipeline stage executes (serving/pipeline.py)."""
        return LayerSlice(self, lo, hi)


class LayerSlice:
    """A contiguous global layer range ``[lo, hi)`` of a :class:`Model`.

    Holds what a pipeline stage runs: ``slice_params`` / ``init_cache``
    over just these layers, and block-only forwards (``seq_blocks``,
    ``decode_blocks``, ``decode_blocks_paged``) taking and giving hidden
    states.  ``Model.prefill``, ``decode_step`` and ``decode_step_paged``
    are the full-range slice composed with the embedding and the head, so
    a single-stage pipeline runs the monolithic engines' code by
    construction.

    The methods take the slice's own parameters (``slice_params``): layer
    ``lo + j`` is ``params["layers"][j]``.  Embedding, final norm and head
    ride along in every slice: the first stage embeds, the last applies
    the head.
    """

    def __init__(self, model: Model, lo: int, hi: int):
        L = model.cfg.num_layers
        if not (0 <= lo < hi <= L):
            raise ValueError(f"layer range [{lo}, {hi}) outside [0, {L}]")
        self.model = model
        self.cfg = model.cfg
        self.device = model.device
        self.lo = lo
        self.hi = hi
        self.stages: Tuple[Stage, ...] = tuple(
            Stage(st.kind, min(hi, st.first_layer + st.count) - max(lo, st.first_layer),
                  max(lo, st.first_layer))
            for st in model.stages
            if max(lo, st.first_layer) < min(hi, st.first_layer + st.count))

    @property
    def num_layers(self) -> int:
        return self.hi - self.lo

    def slice_params(self, params: Params, device: DeviceLike = None) -> Params:
        """The model's parameters with only this range's layers.  The
        tensors are the model's own, not copies, unless ``device`` names
        another device than the one they are on."""
        out = {k: v for k, v in params.items() if k != "layers"}
        out["layers"] = params["layers"][self.lo:self.hi]
        if device is not None and torch.device(device) != params["embed"].device:
            out = _to_device(out, torch.device(device))
        return out

    def init_cache(self, batch: int, max_seq: int,
                   device: DeviceLike = None) -> List[Cache]:
        """Zeroed caches for this range's layers: one dict per stage with
        leaves ``(layers, batch, max_seq, KV, hd)``, on ``device`` (the
        model's device by default)."""
        dev = self.device if device is None else torch.device(device)
        caches = []
        for st in self.stages:
            one = init_layer_cache(self.cfg, st.kind, batch, max_seq, "meta")
            caches.append({name: torch.zeros((st.count, *leaf.shape),
                                             dtype=leaf.dtype, device=dev)
                           for name, leaf in one.items()})
        return caches

    def _layers(self, params: Params, cache: Optional[List[Cache]]
                ) -> Iterator[Tuple[str, Params, Optional[Cache]]]:
        """(kind, layer params, layer cache view) in layer order."""
        for si, st in enumerate(self.stages):
            for j in range(st.count):
                lc = None if cache is None else {
                    name: leaf[j] for name, leaf in cache[si].items()}
                yield st.kind, params["layers"][st.first_layer - self.lo + j], lc

    @torch.no_grad()
    def seq_blocks(self, params: Params, cache: Optional[List[Cache]],
                   x: torch.Tensor) -> torch.Tensor:
        """Sequence forward (train with ``cache=None``, prefill otherwise)
        over this range's blocks; writes the prompt's K/V in place."""
        positions = torch.arange(x.shape[1], device=x.device)[None, :]
        for kind, lp, lc in self._layers(params, cache):
            x = block_seq(self.cfg, kind, lp, x, positions, lc)
        return x

    @torch.no_grad()
    def decode_blocks(self, params: Params, cache: List[Cache], x: torch.Tensor,
                      lengths: torch.Tensor,
                      rows: Optional[torch.Tensor] = None) -> torch.Tensor:
        """One decode step over this range's blocks, hidden (B, D) in and
        out.  Row b writes and reads cache row ``rows[b]`` (int32; ``None``
        for row b) in place."""
        for kind, lp, lc in self._layers(params, cache):
            x = block_decode(self.cfg, kind, lp, x, lengths, lc, rows)
        return x

    @torch.no_grad()
    def decode_blocks_paged(self, params: Params, pools: List[Cache],
                            x: torch.Tensor, lengths: torch.Tensor,
                            block_tables: torch.Tensor, write_page: torch.Tensor,
                            write_off: torch.Tensor) -> torch.Tensor:
        """One decode step over this range's blocks through the block
        table of its paged pools (see ``Model.decode_step_paged``)."""
        for kind, lp, lc in self._layers(params, pools):
            x = block_decode_paged(self.cfg, kind, lp, x, lengths, lc,
                                   block_tables, write_page, write_off)
        return x


def _to_device(tree, device: torch.device):
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_device(v, device) for v in tree]
    return tree.to(device)

"""Mock data plane: a model-free stand-in for ``ChainEngine``.

The orchestrator's control plane — composition, JFFC dispatch, failover,
warm-up, autoscaling hooks — is the paper's contribution; the model
underneath is interchangeable.  ``MockEngine`` implements the engine
interface (admit / step / evict_all / slot accounting) with a synthetic
token generator: one token per decode round, exactly like the real engine,
but with no model, no params and no device — so control-plane runs
(``LivePlane(engine="mock")``) take milliseconds on the host.

A copy of the JAX package's ``serving/mock.py``: the synthetic tokens and
the slot order are the same, so both packages' mock planes give the same
run for the same spec.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

from repro_torch.core.chains import Chain
from repro_torch.core.servers import ServiceSpec

from .orchestrator import Orchestrator, OrchestratorConfig
from .request import Request, State


class MockEngine:
    """Drop-in ``ChainEngine`` with a synthetic one-token-per-step model."""

    def __init__(self, model, params, chain: Chain, capacity: int,
                 max_seq: int):
        self.model = model
        self.params = params
        self.chain = chain
        self.capacity = capacity
        self.max_seq = max_seq
        self.requests: Dict[int, Request] = {}
        self._free: List[int] = list(range(capacity))

    @property
    def has_free_slot(self) -> bool:
        return bool(self._free)

    @property
    def num_active(self) -> int:
        return self.capacity - len(self._free)

    def admit(self, req: Request, now: float = 0.0) -> bool:
        if not self._free:
            return False
        slot = self._free.pop()
        req.slot = slot
        req.state = State.RUNNING
        if req.start_time is None:
            req.start_time = now
        # prefill emits the first token, as the real engine does
        req.output.append(self._next_token(req))
        if req.done:
            req.state = State.DONE
            req.finish_time = now
            self._free.append(slot)
            return True
        self.requests[slot] = req
        return True

    def step(self, now: float = 0.0) -> List[Request]:
        finished: List[Request] = []
        for slot, req in list(self.requests.items()):
            req.output.append(self._next_token(req))
            if req.done:
                req.state = State.DONE
                req.finish_time = now
                finished.append(req)
                del self.requests[slot]
                self._free.append(slot)
        return finished

    def evict_all(self) -> List[Request]:
        out = []
        for slot, req in list(self.requests.items()):
            req.state = State.QUEUED
            req.slot = None
            req.chain_idx = None
            req.retries += 1
            out.append(req)
            self._free.append(slot)
        self.requests.clear()
        return out

    @staticmethod
    def _next_token(req: Request) -> int:
        # deterministic, eos-avoiding synthetic token
        tok = (len(req.output) + 1) % 50_000
        if req.eos_token is not None and tok == req.eos_token:
            tok += 1
        return tok


def mock_orchestrator(
    servers,
    spec: ServiceSpec,
    arrival_rate: float,
    config: Optional[OrchestratorConfig] = None,
    classes=None,
    aging_rate: Optional[float] = None,
) -> Orchestrator:
    """An ``Orchestrator`` over the mock data plane (no model, no device).

    ``classes`` / ``aging_rate`` are conveniences for multi-tenant
    control-plane tests: they override the corresponding
    :class:`OrchestratorConfig` fields without constructing a config.
    """
    cfg = config if config is not None else OrchestratorConfig()
    if cfg.engine_factory is None:
        cfg = dataclasses.replace(cfg, engine_factory=MockEngine)
    if classes is not None:
        cfg = dataclasses.replace(cfg, classes=tuple(classes))
    if aging_rate is not None:
        cfg = dataclasses.replace(cfg, aging_rate=aging_rate)
    return Orchestrator(servers, spec, model=None, params=None,
                        arrival_rate=arrival_rate, config=cfg)

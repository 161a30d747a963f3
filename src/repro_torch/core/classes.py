"""Request SLO classes for the serving orchestrator.

A copy of ``RequestClass`` / ``DEFAULT_CLASS`` from the JAX package's
``core/workload.py``: the port keeps its own copy of every framework-free
module it needs instead of importing the JAX package.
"""
from __future__ import annotations

import dataclasses
import math


@dataclasses.dataclass(frozen=True)
class RequestClass:
    """One tenant / SLO class of the multiplexed request stream.

    ``priority`` is the scheduling tier (0 = most urgent; lower wins).
    ``slo_target`` is the response-time objective (seconds) the class is
    reported against.  ``deadline`` is the maximum queueing wait the class
    tolerates: a *finite* deadline marks the class as sheddable — the
    orchestrator's admission gate may defer an arrival whose estimated wait
    exceeds it.  ``float('inf')`` (the default) means never shed.
    """
    name: str = "default"
    tenant: str = "default"
    priority: int = 0
    slo_target: float = math.inf
    deadline: float = math.inf

    @property
    def sheddable(self) -> bool:
        return math.isfinite(self.deadline)


DEFAULT_CLASS = RequestClass()

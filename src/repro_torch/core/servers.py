"""Server / service abstractions from the paper's system model (Section 2.1).

A *service* is a chain of ``L`` identical blocks (transformer layers), each of
size ``s_m`` (GB).  Processing one job requires, at every server that
participates, ``s_c`` GB of cache per block processed there (the KV cache).

A *server* ``j`` has memory ``M_j`` and two latency coefficients: ``tau_c``
(mean communication time to participate in a job at all) and ``tau_p`` (mean
computation time per block per job).  Heterogeneity (MIG slices, TPU
generations, stragglers) is expressed purely through ``(M_j, tau_c, tau_p)``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Sequence

DUMMY_HEAD = "__j0__"
DUMMY_TAIL = "__jT__"


@dataclasses.dataclass(frozen=True)
class Server:
    sid: str
    memory_gb: float          # M_j
    tau_c: float              # mean communication time (seconds)
    tau_p: float              # mean per-block computation time (seconds)

    def __post_init__(self) -> None:
        if self.memory_gb < 0 or self.tau_c < 0 or self.tau_p < 0:
            raise ValueError(f"negative server parameter: {self}")


@dataclasses.dataclass(frozen=True)
class ServiceSpec:
    num_blocks: int           # L
    block_size_gb: float      # s_m
    cache_size_gb: float      # s_c (per block per concurrent job)

    def __post_init__(self) -> None:
        if self.num_blocks < 1:
            raise ValueError("need at least one block")
        if self.block_size_gb <= 0 or self.cache_size_gb <= 0:
            raise ValueError("block/cache sizes must be positive")


def max_blocks(server: Server, spec: ServiceSpec, c: int) -> int:
    """m_j(c), Eq. (8): blocks placeable at ``server`` while reserving ``c``
    cache slots per placed block."""
    if c < 0:
        raise ValueError("capacity must be non-negative")
    per_block = spec.block_size_gb + spec.cache_size_gb * c
    return min(int(math.floor(server.memory_gb / per_block)), spec.num_blocks)


def service_time(server: Server, spec: ServiceSpec, c: int) -> float:
    """t_j(c), Eq. (9): upper bound on the mean per-job time at ``server``."""
    return server.tau_c + server.tau_p * max_blocks(server, spec, c)


def amortized_time(server: Server, spec: ServiceSpec, c: int) -> float:
    """t~_j(c), Eq. (12): amortized mean service time per block."""
    m = max_blocks(server, spec, c)
    if m == 0:
        return math.inf
    return service_time(server, spec, c) / m


def cache_slots(server: Server, spec: ServiceSpec, placed_blocks: int) -> int:
    """M~_j, Eq. (3): cache slots remaining after hosting ``placed_blocks``."""
    residual = server.memory_gb - spec.block_size_gb * placed_blocks
    if residual < 0:
        raise ValueError(
            f"server {server.sid} cannot host {placed_blocks} blocks "
            f"({server.memory_gb} GB < {spec.block_size_gb * placed_blocks} GB)"
        )
    return int(math.floor(residual / spec.cache_size_gb))


def c_max(servers: Sequence[Server], spec: ServiceSpec) -> int:
    """Maximum concurrency supported by any single server hosting >=1 block."""
    best = 0
    for s in servers:
        best = max(best, int(math.floor((s.memory_gb - spec.block_size_gb) / spec.cache_size_gb)))
    return max(best, 1)

"""Block placement: GBP-CR (Algorithm 1) plus baselines.

A *placement* maps each server to a contiguous block range ``[a_j, a_j+m_j)``
(1-indexed, inclusive start).  GBP-CR reserves ``c`` cache slots per placed
block, sorts servers by amortized per-block service time, and concatenates
them into disjoint chains until the required (scaled) total service rate
``lam / (rho_bar * c)`` is reached (Eq. 10).
"""
from __future__ import annotations

import dataclasses
import random
from typing import Dict, List, Optional, Sequence, Tuple

from .servers import Server, ServiceSpec, amortized_time, max_blocks, service_time


@dataclasses.dataclass
class Placement:
    """Block placement (a, m) plus the disjoint chains GBP-CR formed."""
    spec: ServiceSpec
    # sid -> (a_j, m_j); servers with m_j == 0 are omitted.
    assignment: Dict[str, Tuple[int, int]]
    # Disjoint complete chains (ordered server ids covering blocks 1..L).
    chains: List[List[str]]
    # Scaled total service rate sum_k 1/T_k achieved by the complete chains.
    scaled_rate: float
    # Whether scaled_rate >= required rate at build time.
    feasible: bool
    # The capacity parameter the placement was built for (0 for baselines).
    reserved_capacity: int = 0

    def blocks_at(self, sid: str) -> Tuple[int, int]:
        return self.assignment.get(sid, (0, 0))

    def covered(self, sids: Sequence[str]) -> bool:
        """Do the servers in ``sids`` (in order) cover blocks 1..L in order?"""
        frontier = 1
        for sid in sids:
            a, m = self.assignment.get(sid, (0, 0))
            if m == 0 or a > frontier or a + m <= frontier:
                return False
            frontier = a + m
        return frontier >= self.spec.num_blocks + 1


def gbp_cr(
    servers: Sequence[Server],
    spec: ServiceSpec,
    c: int,
    arrival_rate: float,
    rho_bar: float,
    use_all_servers: bool = False,
) -> Placement:
    """Greedy Block Placement with Cache Reservation (Algorithm 1).

    Args:
      servers: physical servers.
      spec: the service (L blocks, sizes).
      c: required per-chain concurrency (cache slots reserved per block).
      arrival_rate: lambda.
      rho_bar: target maximum load in (0, 1).
      use_all_servers: if True keep forming chains after the rate requirement
        is met (used by the serving layer to exploit the whole cluster).

    Returns a :class:`Placement`; ``feasible`` is False when even using every
    server the scaled rate requirement is not met (callers, e.g. the tuner,
    skip such ``c``).
    """
    if c < 1:
        raise ValueError("GBP-CR requires c >= 1")
    if not 0 < rho_bar < 1:
        raise ValueError("rho_bar must be in (0, 1)")
    L = spec.num_blocks
    required = arrival_rate / (rho_bar * c)

    usable = [s for s in servers if max_blocks(s, spec, c) >= 1]
    order = sorted(usable, key=lambda s: (amortized_time(s, spec, c), s.sid))

    assignment: Dict[str, Tuple[int, int]] = {}
    chains: List[List[str]] = []
    current: List[str] = []
    a, v, t_sum = 1, 0.0, 0.0
    met = False
    for srv in order:
        m_j = max_blocks(srv, spec, c)
        a_j = min(a, L - m_j + 1)
        assignment[srv.sid] = (a_j, m_j)
        current.append(srv.sid)
        t_sum += service_time(srv, spec, c)
        a = min(a + m_j - 1, L) + 1
        if a > L:
            chains.append(current)
            v += 1.0 / t_sum
            if v >= required:
                met = True
                if not use_all_servers:
                    break
            a, t_sum, current = 1, 0.0, []
    # Trailing incomplete chain (if any) stays in the assignment but is not a
    # feasible chain; its servers still contribute via cross-chain links that
    # GCA may exploit.
    return Placement(
        spec=spec,
        assignment=assignment,
        chains=chains,
        scaled_rate=v,
        feasible=met,
        reserved_capacity=c,
    )


def random_placement(
    servers: Sequence[Server],
    spec: ServiceSpec,
    c: int,
    rng: random.Random,
) -> Placement:
    """Feasible-by-construction randomized placement used as the Fig. 3
    brute-force baseline: random server order, random chain cuts."""
    L = spec.num_blocks
    usable = [s for s in servers if max_blocks(s, spec, c) >= 1]
    order = list(usable)
    rng.shuffle(order)
    assignment: Dict[str, Tuple[int, int]] = {}
    chains: List[List[str]] = []
    current: List[str] = []
    a, v, t_sum = 1, 0.0, 0.0
    for srv in order:
        m_j = max_blocks(srv, spec, c)
        a_j = min(a, L - m_j + 1)
        assignment[srv.sid] = (a_j, m_j)
        current.append(srv.sid)
        t_sum += service_time(srv, spec, c)
        a = min(a + m_j - 1, L) + 1
        if a > L:
            chains.append(current)
            v += 1.0 / t_sum
            a, t_sum, current = 1, 0.0, []
    return Placement(spec, assignment, chains, v, True, c)


def chains_needed_from_servers(
    servers: Sequence[Server],
    spec: ServiceSpec,
    placement: Placement,
    arrival_rate: float,
    rho_bar: float,
) -> Optional[int]:
    """K(c), Eq. (13), computed against the server table."""
    by_id = {s.sid: s for s in servers}
    c = max(placement.reserved_capacity, 1)
    required = arrival_rate / (rho_bar * c)
    v = 0.0
    for idx, chain in enumerate(placement.chains):
        t_sum = sum(service_time(by_id[sid], spec, c) for sid in chain)
        v += 1.0 / t_sum
        if v >= required:
            return idx + 1
    return None

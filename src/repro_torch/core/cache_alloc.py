"""Cache allocation: GCA (Algorithm 2) + a conditional-optimal ILP solver.

GCA runs on the chain DAG of a given placement: repeatedly route the fastest
remaining chain (shortest path), grant it the largest capacity the residual
memory allows, deduct, and drop saturated links.  Theorem 3.5: the resulting
O(J^2) chains (with their capacities) are sufficient to realize JFFS/JFFC
dispatch under ANY placement.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple

from .chains import Chain, ChainGraph
from .placement import Placement
from .servers import DUMMY_HEAD, DUMMY_TAIL, Server, ServiceSpec, cache_slots


@dataclasses.dataclass
class Allocation:
    """Server chains with capacities: the composed 'job servers'."""
    chains: List[Chain]
    capacities: List[int]
    residual_slots: Dict[str, int]      # leftover cache slots per server

    @property
    def total_rate(self) -> float:
        """nu, Eq. (4): total service rate of the composed job servers."""
        return sum(c / ch.service_time for ch, c in zip(self.chains, self.capacities))

    def job_servers(self) -> List[Tuple[float, int]]:
        """(mu_k, c_k) sorted by descending rate — queueing-layer view."""
        pairs = [(ch.rate, c) for ch, c in zip(self.chains, self.capacities)]
        return sorted(pairs, key=lambda p: -p[0])

    def sorted_by_rate(self) -> List[Tuple[Chain, int]]:
        pairs = list(zip(self.chains, self.capacities))
        return sorted(pairs, key=lambda p: -p[0].rate)


def initial_slots(
    servers: Sequence[Server], spec: ServiceSpec, placement: Placement
) -> Dict[str, int]:
    """M~_j for every placed server (Eq. 3)."""
    slots: Dict[str, int] = {}
    for srv in servers:
        a, m = placement.assignment.get(srv.sid, (0, 0))
        if m > 0:
            slots[srv.sid] = cache_slots(srv, spec, m)
    return slots


def gca(
    servers: Sequence[Server],
    placement: Placement,
    slots: Optional[Dict[str, int]] = None,
    max_chains: Optional[int] = None,
) -> Allocation:
    """Greedy Cache Allocation (Algorithm 2)."""
    graph = ChainGraph(servers, placement)
    spec = placement.spec
    residual: Dict[str, int] = dict(
        slots if slots is not None else initial_slots(servers, spec, placement)
    )

    def slot_bound(i: str, j: str) -> int:
        if j == DUMMY_TAIL:
            return 1 << 62
        return residual.get(j, 0) // graph.edges[(i, j)]

    # E^(0): links whose tail can cache at least one job's worth of blocks.
    allowed = {e for e in graph.edges if slot_bound(*e) >= 1}
    chains: List[Chain] = []
    caps: List[int] = []
    while True:
        if max_chains is not None and len(chains) >= max_chains:
            break
        chain = graph.shortest_chain(allowed=allowed)
        if chain is None:
            break
        # Path hops including the dummy head for edge lookup.
        hops: List[Tuple[str, str]] = []
        prev = DUMMY_HEAD
        for sid in chain.servers:
            hops.append((prev, sid))
            prev = sid
        cap = min(slot_bound(i, j) for (i, j) in hops)
        if cap >= 1:
            chains.append(chain)
            caps.append(cap)
            for (i, j) in hops:
                residual[j] -= graph.edges[(i, j)] * cap
        # Drop saturated links anywhere in the graph (superset of the paper's
        # lines 10-12, removing zero-capacity edges up front so every loop
        # iteration removes at least one link and no 0-capacity chain is kept).
        for e in list(allowed):
            if slot_bound(*e) < 1:
                allowed.discard(e)
        # Note: at least the min-achieving hop of this chain is removed, so the
        # loop runs at most |E| = O(J^2) times.
    return Allocation(chains=chains, capacities=caps, residual_slots=residual)


def reserved_allocation(
    servers: Sequence[Server], placement: Placement
) -> Allocation:
    """The 'c * K(c)' baseline: only GBP-CR's disjoint chains, each with the
    reserved capacity c (no further cache optimization).  Upper-bound curve of
    Fig. 4."""
    from .chains import disjoint_chain_objects

    spec = placement.spec
    c = max(placement.reserved_capacity, 1)
    chains = disjoint_chain_objects(servers, placement)
    residual = initial_slots(servers, spec, placement)
    caps = []
    for ch in chains:
        caps.append(c)
        # account the reserved slots so residuals are consistent
        for sid, m_ij in ch.hops():
            residual[sid] = residual.get(sid, 0) - m_ij * c
    return Allocation(chains=chains, capacities=caps, residual_slots=residual)


# ---------------------------------------------------------------------------
# Conditional-optimal ILP (Fig. 4's 'Optimal ILP'): given the chain set K from
# GCA, solve   min sum_k c_k   s.t.  sum_k mu_k c_k >= R,  memory constraints.
# Exact via depth-first branch & bound (small instances only).
# ---------------------------------------------------------------------------

def optimal_ilp(
    servers: Sequence[Server],
    placement: Placement,
    chains: Sequence[Chain],
    required_rate: float,
    node_budget: int = 2_000_000,
) -> Optional[List[int]]:
    """Minimize total capacity subject to rate >= required_rate and per-server
    cache-slot constraints, over the given chain set.  Returns capacities (in
    the order of ``chains``) or None if infeasible / budget exhausted."""
    spec = placement.spec
    slots0 = initial_slots(servers, spec, placement)
    K = len(chains)
    # Per-chain per-server slot usage.
    usage: List[Dict[str, int]] = []
    for ch in chains:
        u: Dict[str, int] = {}
        for sid, m_ij in ch.hops():
            u[sid] = u.get(sid, 0) + m_ij
        usage.append(u)
    rates = [ch.rate for ch in chains]
    order = sorted(range(K), key=lambda k: -rates[k])     # fastest first

    best: List[Optional[List[int]]] = [None]
    best_total = [math.inf]
    nodes = [0]
    max_rate = max(rates) if rates else 0.0
    if max_rate <= 0:
        return None

    def ub_cap(k: int, slots: Dict[str, int]) -> int:
        return min(
            (slots[sid] // u for sid, u in usage[k].items()), default=0
        )

    def dfs(pos: int, total: int, rate: float, slots: Dict[str, int], acc: List[int]) -> None:
        nodes[0] += 1
        if nodes[0] > node_budget:
            return
        if rate >= required_rate:
            if total < best_total[0]:
                best_total[0] = total
                caps = [0] * K
                for k, c in zip(order[:pos], acc):
                    caps[k] = c
                best[0] = caps
            return
        if pos >= K:
            return
        # Bound: even adding capacity on the fastest remaining chain, we need
        # at least ceil(deficit / mu_max_remaining) more slots.
        mu_rem = rates[order[pos]]
        need = math.ceil((required_rate - rate) / mu_rem - 1e-12)
        if total + need >= best_total[0]:
            return
        k = order[pos]
        cap_max = ub_cap(k, slots)
        for c in range(cap_max, -1, -1):
            if total + c >= best_total[0]:
                continue
            new_slots = slots
            if c > 0:
                new_slots = dict(slots)
                for sid, u in usage[k].items():
                    new_slots[sid] -= u * c
            dfs(pos + 1, total + c, rate + rates[k] * c, new_slots, acc + [c])

    dfs(0, 0, 0.0, dict(slots0), [])
    return best[0]


def rate_lower_bound(chains: Sequence[Chain], required_rate: float) -> int:
    """Fig. 4's 'Lower Bound': ceil(R / mu_1)."""
    mu1 = max(ch.rate for ch in chains)
    return int(math.ceil(required_rate / mu1 - 1e-12))

"""Server-chain graph machinery (Section 2.1.1).

Under a placement ``(a, m)``, servers ``i -> j`` can be traversed
consecutively iff ``a_j <= a_i + m_i <= a_j + m_j - 1``; server ``j`` then
processes ``m_ij = a_j + m_j - a_i - m_i >= 1`` blocks.  Augmented with dummy
head/tail servers, every ``j0 -> jT`` path is a feasible chain covering all
``L`` blocks in order.  Edge cost ``tau_j^c + tau_j^p * m_ij`` makes shortest
paths equal fastest chains (Eq. 2).
"""
from __future__ import annotations

import dataclasses
import heapq
import math
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from .placement import Placement
from .servers import DUMMY_HEAD, DUMMY_TAIL, Server, ServiceSpec


@dataclasses.dataclass(frozen=True)
class Chain:
    """A feasible server chain: ordered real servers + per-hop block counts."""
    servers: Tuple[str, ...]          # real server ids, in traversal order
    blocks: Tuple[int, ...]           # m_ij processed at each server
    service_time: float               # T_k, Eq. (2)

    @property
    def rate(self) -> float:
        return 1.0 / self.service_time

    def hops(self) -> Iterable[Tuple[str, int]]:
        return zip(self.servers, self.blocks)

    def key(self) -> Tuple[Tuple[str, ...], Tuple[int, ...]]:
        return (self.servers, self.blocks)


class ChainGraph:
    """The logical routing DAG G_{a,m} = (J+, E_{a,m})."""

    def __init__(self, servers: Sequence[Server], placement: Placement):
        self.spec: ServiceSpec = placement.spec
        self.placement = placement
        self.by_id: Dict[str, Server] = {s.sid: s for s in servers}
        L = self.spec.num_blocks
        # frontier(i) = a_i + m_i, the first block NOT yet processed after i.
        self.frontier: Dict[str, int] = {DUMMY_HEAD: 1, DUMMY_TAIL: L + 2}
        self.start: Dict[str, int] = {DUMMY_HEAD: 0, DUMMY_TAIL: L + 1}
        self.width: Dict[str, int] = {DUMMY_HEAD: 1, DUMMY_TAIL: 1}
        for sid, (a, m) in placement.assignment.items():
            if m <= 0:
                continue
            self.start[sid] = a
            self.width[sid] = m
            self.frontier[sid] = a + m
        self.nodes: List[str] = [DUMMY_HEAD] + sorted(
            (sid for sid in self.start if sid not in (DUMMY_HEAD, DUMMY_TAIL)),
            key=lambda s: (self.start[s], s),
        ) + [DUMMY_TAIL]
        self.edges: Dict[Tuple[str, str], int] = {}     # (i, j) -> m_ij
        self.succ: Dict[str, List[str]] = {n: [] for n in self.nodes}
        for i in self.nodes:
            if i == DUMMY_TAIL:
                continue
            fi = self.frontier[i]
            for j in self.nodes:
                if j in (DUMMY_HEAD,) or j == i:
                    continue
                a_j, m_j = self.start[j], self.width[j]
                if a_j <= fi <= a_j + m_j - 1:
                    m_ij = a_j + m_j - fi
                    self.edges[(i, j)] = m_ij
                    self.succ[i].append(j)

    def edge_cost(self, i: str, j: str) -> float:
        """tau_j^c + tau_j^p * m_ij; 0 for the dummy tail."""
        if j == DUMMY_TAIL:
            return 0.0
        srv = self.by_id[j]
        return srv.tau_c + srv.tau_p * self.edges[(i, j)]

    def shortest_chain(
        self,
        edge_filter: Optional[Dict[Tuple[str, str], bool]] = None,
        allowed: Optional[set] = None,
    ) -> Optional[Chain]:
        """Dijkstra on the DAG from j0 to jT.  ``allowed`` (if given) is the
        current edge set E^(l) of GCA; edges absent from it are skipped."""
        dist: Dict[str, float] = {DUMMY_HEAD: 0.0}
        prev: Dict[str, str] = {}
        pq: List[Tuple[float, str]] = [(0.0, DUMMY_HEAD)]
        seen: set = set()
        while pq:
            d, u = heapq.heappop(pq)
            if u in seen:
                continue
            seen.add(u)
            if u == DUMMY_TAIL:
                break
            for v in self.succ[u]:
                if allowed is not None and (u, v) not in allowed:
                    continue
                nd = d + self.edge_cost(u, v)
                if nd < dist.get(v, math.inf) - 1e-18:
                    dist[v] = nd
                    prev[v] = u
                    heapq.heappush(pq, (nd, v))
        if DUMMY_TAIL not in dist:
            return None
        # Reconstruct path.
        path: List[str] = [DUMMY_TAIL]
        while path[-1] != DUMMY_HEAD:
            path.append(prev[path[-1]])
        path.reverse()
        return self.chain_from_path(path)

    def chain_from_path(self, path: Sequence[str]) -> Chain:
        """Build a Chain from a j0..jT node path, validating edges."""
        assert path[0] == DUMMY_HEAD and path[-1] == DUMMY_TAIL
        servers: List[str] = []
        blocks: List[int] = []
        total = 0.0
        for i, j in zip(path[:-1], path[1:]):
            if (i, j) not in self.edges:
                raise ValueError(f"invalid hop {i}->{j}")
            if j != DUMMY_TAIL:
                servers.append(j)
                blocks.append(self.edges[(i, j)])
                total += self.edge_cost(i, j)
        if sum(blocks) != self.spec.num_blocks:
            raise AssertionError(
                f"chain processes {sum(blocks)} blocks, expected {self.spec.num_blocks}"
            )
        return Chain(tuple(servers), tuple(blocks), total)

    def chain_from_servers(self, sids: Sequence[str]) -> Chain:
        """Chain for an explicit server order (e.g. a GBP-CR disjoint chain)."""
        return self.chain_from_path([DUMMY_HEAD, *sids, DUMMY_TAIL])


def disjoint_chain_objects(
    servers: Sequence[Server], placement: Placement
) -> List[Chain]:
    graph = ChainGraph(servers, placement)
    return [graph.chain_from_servers(c) for c in placement.chains]

"""Load-balancing policies over composed job servers (Section 3.2).

JFFC (Algorithm 3) is the paper's policy: a single central FIFO queue; an
arrival joins the fastest chain with free capacity, else queues; a completion
on chain k pulls the queue head onto chain k (faithful to Alg. 3 — NOT onto
the fastest free chain).

The benchmark policies (JSQ / JIQ / SED / SA-JSQ) use dedicated per-chain
queues, extended to parallel chains exactly as in Section 4.1.2.

Multi-tenant serving adds :class:`PriorityJFFC`: Algorithm 3's central
queue ordered by SLO class instead of FIFO — strict priority tiers with
optional linear aging so best-effort work cannot starve.  The aged
priority ``tier - aging_rate * (now - arrival)`` is order-equivalent to
the *static* key ``tier + aging_rate * arrival``, so one heap insertion
per queued job suffices and the queue never needs re-keying as time
passes.

A copy of the JAX package's ``core/load_balance.py``: ``POLICIES`` is the
name list ``PolicySpec`` validates against (through
``repro_torch.api.DISPATCH_POLICIES``).
"""
from __future__ import annotations

import heapq
import random
from collections import deque
from typing import Deque, List, Optional, Sequence, Tuple

from .workload import DEFAULT_CLASS, RequestClass


class Policy:
    """Strategy interface of the queueing simulator's dispatch.

    ``rates``/``caps`` describe the composed job servers (chain k can run
    ``caps[k]`` jobs concurrently at rate ``rates[k]`` each).
    """

    name = "base"

    def __init__(self, rates: Sequence[float], caps: Sequence[int],
                 rng: Optional[random.Random] = None):
        self.rates = list(rates)
        self.caps = list(caps)
        self.running = [0] * len(rates)
        self.rng = rng or random.Random(0)

    # -- hooks ---------------------------------------------------------------
    def on_arrival(self, job) -> Optional[int]:
        """Return the chain index to start ``job`` on now, or None if queued."""
        raise NotImplementedError

    def on_departure(self, k: int) -> Optional[object]:
        """Chain ``k`` freed one slot; return a queued job to start (on any
        chain — set ``job.assigned_chain``) or None."""
        raise NotImplementedError

    def queue_len(self) -> int:
        raise NotImplementedError

    # -- shared helpers --------------------------------------------------------
    def free_chains(self) -> List[int]:
        return [k for k in range(len(self.caps)) if self.running[k] < self.caps[k]]


class JFFC(Policy):
    """Join-the-Fastest-Free-Chain (Algorithm 3)."""

    name = "jffc"

    def __init__(self, rates, caps, rng=None):
        super().__init__(rates, caps, rng)
        self.queue: Deque = deque()

    def on_arrival(self, job):
        free = self.free_chains()
        if free:
            k = max(free, key=lambda i: self.rates[i])
            return k
        self.queue.append(job)
        return None

    def on_departure(self, k):
        if self.queue:
            job = self.queue.popleft()
            job.assigned_chain = k
            return job
        return None

    def queue_len(self):
        return len(self.queue)


class PriorityJFFC(Policy):
    """JFFC with a priority central queue (multi-tenant SLO classes).

    An arrival still joins the fastest free chain; when every slot is busy
    it queues with key ``tier + aging_rate * arrival`` (see module
    docstring), ties broken by arrival order.  A completion on chain k
    pulls the *highest-priority* queued job onto chain k — Algorithm 3
    with the FIFO pull replaced by a class-aware pull.  With a single
    default class (tier 0) the key degenerates to arrival order and the
    policy is exactly :class:`JFFC`.
    """

    name = "priority"

    def __init__(self, rates, caps, rng=None,
                 classes: Optional[Sequence[RequestClass]] = None,
                 aging_rate: float = 0.0):
        super().__init__(rates, caps, rng)
        self.classes = list(classes) if classes else [DEFAULT_CLASS]
        self.aging_rate = float(aging_rate)
        self.pq: List[Tuple[float, int, object]] = []   # (kappa, jid, job)

    def _kappa(self, job) -> float:
        tier = self.classes[getattr(job, "cls", 0)].priority
        return tier + self.aging_rate * job.arrival

    def on_arrival(self, job):
        free = self.free_chains()
        if free:
            return max(free, key=lambda i: self.rates[i])
        heapq.heappush(self.pq, (self._kappa(job), job.jid, job))
        return None

    def on_departure(self, k):
        if self.pq:
            job = heapq.heappop(self.pq)[2]
            job.assigned_chain = k
            return job
        return None

    def queue_len(self):
        return len(self.pq)


class _DedicatedQueuePolicy(Policy):
    """Base for policies with one FIFO queue per chain."""

    def __init__(self, rates, caps, rng=None):
        super().__init__(rates, caps, rng)
        self.queues: List[Deque] = [deque() for _ in rates]

    def choose(self, job) -> int:
        raise NotImplementedError

    def on_arrival(self, job):
        k = self.choose(job)
        if self.running[k] < self.caps[k]:
            return k
        job.assigned_chain = k
        self.queues[k].append(job)
        return None

    def on_departure(self, k):
        if self.queues[k]:
            job = self.queues[k].popleft()
            job.assigned_chain = k
            return job
        return None

    def queue_len(self):
        return sum(len(q) for q in self.queues)

    def in_system(self, k: int) -> int:
        return self.running[k] + len(self.queues[k])


class JSQ(_DedicatedQueuePolicy):
    """Join-the-Shortest-Queue, parallel-chain extension."""

    name = "jsq"

    def choose(self, job):
        n = min(self.in_system(k) for k in range(len(self.caps)))
        cands = [k for k in range(len(self.caps)) if self.in_system(k) == n]
        return self.rng.choice(cands)


class SAJSQ(_DedicatedQueuePolicy):
    """Speed-Aware JSQ [5]: shortest queue, ties to the fastest chain."""

    name = "sa-jsq"

    def choose(self, job):
        return min(
            range(len(self.caps)),
            key=lambda k: (self.in_system(k), -self.rates[k]),
        )


class SED(_DedicatedQueuePolicy):
    """Smallest-Expected-Delay for parallel chains (M/M/c-style estimate)."""

    name = "sed"

    def choose(self, job):
        def delay(k):
            n = self.in_system(k)
            mu, c = self.rates[k], self.caps[k]
            wait = max(0, n + 1 - c) / (c * mu)
            return wait + 1.0 / mu

        return min(range(len(self.caps)), key=delay)


class JIQ(_DedicatedQueuePolicy):
    """Join-the-Idle-Queue [17]: any chain with a free slot, else random."""

    name = "jiq"

    def choose(self, job):
        free = self.free_chains()
        if free:
            return self.rng.choice(free)
        return self.rng.randrange(len(self.caps))


class JFFS(_DedicatedQueuePolicy):
    """Join-the-Fastest-Free-Server dispatch (Theorem 3.5 narrative) extended
    with dedicated queues: an arrival joins the fastest free chain; when none
    is free it waits at the fastest chain overall.  Fully deterministic."""

    name = "jffs"

    def choose(self, job):
        free = self.free_chains()
        if free:
            return max(free, key=lambda k: self.rates[k])
        return max(range(len(self.caps)), key=lambda k: self.rates[k])


class RandomDispatch(_DedicatedQueuePolicy):
    """Uniform random chain per arrival, dedicated FIFO queues — the naive
    baseline the scenario regression tests compare JFFC against."""

    name = "random"

    def choose(self, job):
        return self.rng.randrange(len(self.caps))


POLICIES = {cls.name: cls for cls in (JFFC, PriorityJFFC, JSQ, SAJSQ, SED,
                                      JIQ, JFFS, RandomDispatch)}

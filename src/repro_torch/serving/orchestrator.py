"""Serving orchestrator: the paper's control plane running a live system.

Two time scales, exactly as in Section 2.2:
  * offline (seconds, on composition events): tune c (Thm 3.7 lower bound),
    GBP-CR placement, GCA cache allocation -> chain engines;
  * online (per request): JFFC dispatch (Alg. 3) with a central FIFO queue.

Fault tolerance / elasticity (DESIGN.md §7):
  * ``fail_server``   — retire chains traversing the dead server, re-queue
    their in-flight requests (context preserved — prompt + generated tokens
    re-prefill on the new chain), recompose on survivors.
  * ``fail_servers``  — correlated group failure (a rack): one eviction +
    recomposition pass for the whole set.
  * ``add_server``    — recompose including the newcomer; with a
    ``warmup_until`` deadline the server is *placed* (tracked, billed) but
    excluded from the composition — no dispatches — until it is warm.
  * ``report_tau``    — per-server EWMA latency feedback; when drift exceeds
    a threshold the next recomposition demotes stragglers (the paper's
    "fast with fast" principle applied online).

Autoscalers observe and actuate through hooks: ``submit_hooks`` fire on
every request submission (arrival telemetry), ``step_hooks`` after every
decode round (state sampling + control ticks).  The default data plane is
the port's ``ChainEngine``; ``OrchestratorConfig.engine_factory`` swaps in
another (``PagedChainEngine``, ``PipelineChainEngine``, or the model-free
``repro_torch.serving.mock.MockEngine`` for control-plane runs).

This is a copy of the JAX package's ``serving/orchestrator.py`` with the
port's engine as the default.  Scripted cluster events reach a live system
through :meth:`Orchestrator.apply_scenario_event`, which the port's live
plane (:func:`repro_torch.api.planes.drive_orchestrator`) calls.

Multi-tenant SLO classes: requests carry a class index into
``OrchestratorConfig.classes`` (:class:`repro_torch.core.RequestClass`).  The
central queue is ordered by aged class priority (tier + aging * arrival —
FIFO with a single default class), and submissions of sheddable classes
(finite deadline) pass an **admission gate**: when the estimated queueing
wait exceeds the class deadline (scaled by ``admission_level``, the
autoscaler's throttle), the request is *deferred* — parked without a slot
and readmitted once the backlog drains, so best-effort work yields to
interactive work instead of forcing a scale-out.
"""
from __future__ import annotations

import dataclasses
import heapq
import math
from collections import deque
from typing import Callable, Deque, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core import (
    Allocation,
    DEFAULT_CLASS,
    RequestClass,
    Server,
    ServiceSpec,
    compose_best_effort,
)
from .engine import ChainEngine
from .request import Request, State


@dataclasses.dataclass
class OrchestratorConfig:
    rho_bar: float = 0.7
    tuner: str = "bound-lower"
    max_seq: int = 256
    ewma_alpha: float = 0.2
    straggler_threshold: float = 1.5     # tau drift ratio triggering recompose
    max_retries: int = 3
    # data-plane constructor (model, params, chain, capacity, max_seq) ->
    # engine; None = the port's ChainEngine
    engine_factory: Optional[Callable] = None
    # multi-tenant SLO classes: request.cls indexes this list; None = the
    # single default class (class-blind FIFO behavior, bit-compatible)
    classes: Optional[Sequence[RequestClass]] = None
    aging_rate: float = 0.0              # priority aging (anti-starvation)


class _PriorityQueue:
    """Central request queue ordered by aged class priority.

    Key = ``(tier + aging * arrival, seq)`` — the static form of the aged
    priority ``tier - aging * waited`` (see ``core.load_balance``), with the
    push sequence as tie-break.  A single tier-0 class with no aging
    degenerates to exact FIFO, preserving the class-blind orchestrator's
    scheduling order.
    """

    def __init__(self, classes: Sequence[RequestClass], aging_rate: float):
        self._classes = list(classes)
        self._aging = float(aging_rate)
        self._heap: List[Tuple[float, int, Request]] = []
        self._seq = 0

    def _kappa(self, req: Request) -> float:
        tier = self._classes[req.cls].priority \
            if 0 <= req.cls < len(self._classes) else 0
        return tier + self._aging * req.arrival_time

    def push(self, req: Request) -> None:
        heapq.heappush(self._heap, (self._kappa(req), self._seq, req))
        self._seq += 1

    def pop(self) -> Request:
        return heapq.heappop(self._heap)[2]

    def peek(self) -> Request:
        return self._heap[0][2]

    def __len__(self) -> int:
        return len(self._heap)

    def __bool__(self) -> bool:
        return bool(self._heap)

    def __iter__(self):
        return (entry[2] for entry in sorted(self._heap, key=lambda e: e[:2]))


class Orchestrator:
    def __init__(
        self,
        servers: Sequence[Server],
        spec: ServiceSpec,
        model,
        params,
        arrival_rate: float,
        config: OrchestratorConfig = OrchestratorConfig(),
    ):
        self.spec = spec
        self.model = model
        self.params = params
        self.lam = arrival_rate
        self.cfg = config
        self.servers: Dict[str, Server] = {s.sid: s for s in servers}
        self.tau_scale: Dict[str, float] = {s.sid: 1.0 for s in servers}
        self.warming: Dict[str, float] = {}   # sid -> warm-at deadline
        self.classes: List[RequestClass] = (
            list(config.classes) if config.classes else [DEFAULT_CLASS])
        self.queue = _PriorityQueue(self.classes, config.aging_rate)
        self.deferred: Deque[Request] = deque()   # admission-gated parking
        self.admission_level = 1.0
        self.finished: List[Request] = []
        self.failed: List[Request] = []
        self.engines: List = []
        self.draining: List = []   # retired engines finishing committed work
        self.allocation: Optional[Allocation] = None
        self.c_star: int = 1
        self.recompositions = 0
        self.degraded = False                # last composition fell back to c=1
        # autoscale observation points: (req, now) on submit, (self, now)
        # after every decode round
        self.submit_hooks: List[Callable] = []
        self.step_hooks: List[Callable] = []
        # optional metrics registry (counter/gauge/histogram by name);
        # publication happens at round granularity in step(), never inside
        # the engines' decode loops
        self.metrics = None
        self._compose()

    # -- composition (offline time scale) ---------------------------------------
    def _engine_factory(self) -> Callable:
        if self.cfg.engine_factory is not None:
            return self.cfg.engine_factory
        return ChainEngine

    def _effective_servers(self) -> List[Server]:
        out = []
        for sid, s in self.servers.items():
            if sid in self.warming:        # placed, not serving yet
                continue
            scale = self.tau_scale[sid]
            out.append(Server(sid, s.memory_gb, s.tau_c * scale, s.tau_p * scale))
        return out

    def _compose(self) -> None:
        servers = self._effective_servers()
        if not servers:
            self.engines = []
            self.allocation = None
            return
        # both planes degrade through the same helper: largest feasible
        # load under overload, c=1 everything-chain as the last resort
        self.c_star, alloc, self.degraded = compose_best_effort(
            servers, self.spec, self.lam, self.cfg.rho_bar,
            tuner=self.cfg.tuner)
        self.allocation = alloc
        factory = self._engine_factory()
        pairs = alloc.sorted_by_rate()
        self.engines = [
            factory(self.model, self.params, chain, cap, self.cfg.max_seq)
            for chain, cap in pairs
        ]
        self.recompositions += 1

    # -- dispatch (online time scale; Alg. 3) -------------------------------------
    def set_admission_level(self, level: float) -> None:
        """Autoscaler throttle: scales every sheddable class's deadline
        (1.0 = nominal, 0.0 = defer all best-effort work that would queue)."""
        self.admission_level = max(0.0, float(level))

    def _should_defer(self, req: Request) -> bool:
        """Admission gate: defer a sheddable request whose estimated
        queueing wait exceeds its class deadline (scaled by the throttle).
        Never fires when a slot is free (work conservation) — callers try
        :meth:`_dispatch` first."""
        rc = self.classes[req.cls] if 0 <= req.cls < len(self.classes) \
            else DEFAULT_CLASS
        if not rc.sheddable:
            return False
        rate = self.allocation.total_rate if self.allocation is not None \
            else 0.0
        est = (len(self.queue) + 1) / rate if rate > 0 else math.inf
        return est > rc.deadline * self.admission_level

    def submit(self, req: Request, now: float = 0.0) -> None:
        for hook in self.submit_hooks:
            hook(req, now)
        if self._dispatch(req, now):
            return
        if self._should_defer(req):
            req.state = State.DEFERRED
            self.deferred.append(req)
            return
        self.queue.push(req)

    def _resubmit(self, req: Request, now: float) -> None:
        """Re-dispatch an evicted/requeued request WITHOUT firing the submit
        hooks or the admission gate — a requeue is not a new arrival
        (counting it as one would feed phantom load into the autoscaler's
        rate estimate right when the cluster is already recomposing), and
        work already admitted is never shed."""
        if not self._dispatch(req, now):
            self.queue.push(req)

    def _readmit_deferred(self, now: float) -> None:
        """Pull deferred best-effort work back in once the backlog drains
        below its admission threshold (oldest first).  Deferred work never
        jumps the queue: freed capacity goes to queued requests first —
        direct dispatch only when the queue is empty, otherwise readmission
        means joining the priority queue at the back of its tier."""
        while self.deferred:
            req = self.deferred[0]
            if not self.queue and self._dispatch(req, now):
                self.deferred.popleft()
                continue
            if not self._should_defer(req):
                req.state = State.QUEUED
                self.queue.push(self.deferred.popleft())
                continue
            break

    def _dispatch(self, req: Request, now: float) -> bool:
        # engines are sorted fastest-first; JFFC = first with a free slot.
        for idx, eng in enumerate(self.engines):
            if eng.has_free_slot:
                ok = eng.admit(req, now)
                if ok:
                    req.chain_idx = idx
                    if req.state == State.DONE:
                        self.finished.append(req)
                    return True
        return False

    def step(self, now: float = 0.0) -> List[Request]:
        """One decode round across all engines + queue pulls (Alg. 3 line 6)."""
        self._expire_warming(now)
        done: List[Request] = []
        for eng in self.engines:
            for req in eng.step(now):
                done.append(req)
                # a completion frees a slot on THIS chain; pull the
                # highest-priority queued request (FIFO with one class)
                if self.queue:
                    nxt = self.queue.peek()
                    if eng.admit(nxt, now):
                        self.queue.pop()
                        if nxt.state == State.DONE:
                            done.append(nxt)
        # retired engines finish their committed requests (no new admits)
        for eng in list(self.draining):
            done.extend(eng.step(now))
            if not eng.requests:
                self.draining.remove(eng)
        # paged engines may have preempted requests on page exhaustion;
        # resubmit them (context preserved — they re-prefill with their
        # generated tokens) unless they are out of retries
        for eng in list(self.engines) + list(self.draining):
            take = getattr(eng, "take_preempted", None)
            if take is None:
                continue
            for req in take():
                if req.retries > self.cfg.max_retries:
                    req.state = State.FAILED
                    self.failed.append(req)
                else:
                    self._resubmit(req, now)
        self.finished.extend(done)
        self._readmit_deferred(now)
        if self.metrics is not None:
            m = self.metrics
            m.counter("orch.rounds").inc()
            m.counter("orch.completions").inc(len(done))
            m.gauge("orch.queue_len").set(len(self.queue))
            m.gauge("orch.deferred").set(len(self.deferred))
            self._publish_engine_gauges()
            h = m.histogram("orch.response_s")
            for req in done:
                rt = req.response_time()
                if rt is not None:
                    h.record(rt)
        for hook in self.step_hooks:
            hook(self, now)
        return done

    def _publish_engine_gauges(self) -> None:
        """Data-plane gauges, round-granularity only (the zero-hot-loop
        contract): active slots, free pages across paged engines, per-engine
        batch occupancy, live prefill-jit specializations.  Called from
        :meth:`step` *and* from every eviction / preemption / recomposition
        path — a page freed by ``evict_all`` must show up in
        ``orch.free_pages`` without waiting for the next decode round, or
        traces read as phantom page leaks."""
        if self.metrics is None:
            return
        m = self.metrics
        m.gauge("orch.active_slots").set(
            sum(e.num_active for e in self.engines))
        pages = [e.free_pages for e in self.engines
                 if hasattr(e, "free_pages")]
        if pages:
            m.gauge("orch.free_pages").set(sum(pages))
        m.gauge("orch.prefill_buckets").set(
            sum(getattr(e, "prefill_bucket_count", 0)
                for e in self.engines))
        occ = m.histogram("orch.batch_occupancy")
        for e in self.engines:
            if e.capacity:
                occ.record(e.num_active / e.capacity)

    def drain(self, now_fn=None, max_rounds: int = 100_000) -> None:
        """Run decode rounds until queue + deferred + engines are empty."""
        rounds = 0
        t = 0.0
        while (self.queue or self.deferred or self.draining
               or any(e.requests for e in self.engines)) \
                and rounds < max_rounds:
            t = now_fn() if now_fn else t + 1.0
            self.step(t)
            # JFFC also admits from the queue whenever capacity is free
            while self.queue:
                req = self.queue.peek()
                if not self._dispatch(req, t):
                    break
                self.queue.pop()
            rounds += 1

    # -- fault tolerance / elasticity ---------------------------------------------
    def fail_server(self, sid: str, now: float = 0.0) -> int:
        """Remove a dead server; re-queue affected in-flight requests."""
        return self.fail_servers([sid], now)

    def fail_servers(self, sids: Sequence[str], now: float = 0.0) -> int:
        """Correlated failure (a rack, a power domain): remove the whole set
        with a single eviction + recomposition pass."""
        dead = set(sids)
        missing = dead - set(self.servers)
        if missing:
            raise KeyError(sorted(missing)[0])
        for sid in dead:
            del self.servers[sid]
            del self.tau_scale[sid]
            self.warming.pop(sid, None)
        requeued = 0
        survivors: List[Request] = []
        # draining engines die with their hardware too — a retired chain
        # that was gracefully finishing its work loses it when a server it
        # traverses actually fails
        doomed_draining = [e for e in self.draining
                           if dead & set(e.chain.servers)]
        for eng in doomed_draining:
            self.draining.remove(eng)
        for eng in list(self.engines) + doomed_draining:
            if dead & set(eng.chain.servers):
                for req in eng.evict_all():
                    if req.retries > self.cfg.max_retries:
                        req.state = State.FAILED
                        self.failed.append(req)
                    else:
                        survivors.append(req)
                        requeued += 1
        # Recompose on the surviving set.  Engines whose chains survive
        # verbatim keep caches + requests; engines displaced only by the new
        # composition (their servers are alive) drain gracefully — only the
        # dead servers' requests pay the re-prefill penalty.
        self._recompose_preserving(now, drain=True)
        for req in survivors:
            self._resubmit(req, now)
        self._publish_engine_gauges()
        return requeued

    def add_server(self, server: Server, now: float = 0.0,
                   warmup_until: Optional[float] = None) -> None:
        """Add a server; with ``warmup_until`` in the future it is *placed*
        (visible in ``servers``, billed by the autoscaler) but kept out of
        the composition — zero dispatches touch it — until the deadline
        passes (checked at each decode round)."""
        self.servers[server.sid] = server
        self.tau_scale[server.sid] = 1.0
        if warmup_until is not None and warmup_until > now:
            self.warming[server.sid] = float(warmup_until)
            return
        self._recompose_preserving(now, drain=True)

    def retire_servers(self, sids: Sequence[str], now: float = 0.0) -> int:
        """Graceful scale-in: the opposite of :meth:`fail_servers` — the
        servers leave the cluster but engines traversing them finish their
        committed requests before shutting down.  Returns the number of
        requests left draining."""
        gone = set(sids) & set(self.servers)
        for sid in gone:
            del self.servers[sid]
            del self.tau_scale[sid]
            self.warming.pop(sid, None)
        before = sum(len(e.requests) for e in self.draining)
        self._recompose_preserving(now, drain=True)
        self._publish_engine_gauges()
        return sum(len(e.requests) for e in self.draining) - before

    def _expire_warming(self, now: float) -> None:
        due = [sid for sid, t in self.warming.items() if t <= now]
        if due:
            for sid in due:
                del self.warming[sid]
            self._recompose_preserving(now, drain=True)

    def _recompose_preserving(self, now: float, drain: bool = False) -> None:
        """Recompose; engines whose (chain, capacity) survive keep their KV
        caches and in-flight requests.  Displaced engines either evict their
        requests to the queue (``drain=False`` — involuntary change, the
        requests re-prefill elsewhere) or keep serving them to completion
        without accepting new work (``drain=True`` — voluntary change:
        retune, scale-out, graceful scale-in; the old and new chain sets
        briefly coexist, as in a real engine rollout)."""
        old = {tuple(e.chain.servers): e for e in self.engines}
        evicted: List[Request] = []
        self._compose()
        new_engines: List = []
        for eng in self.engines:
            key = tuple(eng.chain.servers)
            prev = old.pop(key, None)
            if prev is not None and prev.capacity == eng.capacity:
                new_engines.append(prev)     # cache + requests preserved
            else:
                new_engines.append(eng)
                if prev is not None:
                    if drain and prev.requests:
                        self.draining.append(prev)
                    else:
                        evicted.extend(prev.evict_all())
        for leftover in old.values():
            if drain and leftover.requests:
                self.draining.append(leftover)
            else:
                evicted.extend(leftover.evict_all())
        self.engines = new_engines
        for req in evicted:
            self._resubmit(req, now)
        self._publish_engine_gauges()

    def report_tau(self, sid: str, observed_scale: float, now: float = 0.0) -> None:
        """EWMA straggler feedback: observed_scale = measured/nominal time."""
        if sid not in self.tau_scale:
            return
        a = self.cfg.ewma_alpha
        self.tau_scale[sid] = (1 - a) * self.tau_scale[sid] + a * observed_scale
        if self.tau_scale[sid] > self.cfg.straggler_threshold:
            self._recompose_preserving(now, drain=True)

    # -- scenario hooks (repro_torch.core.scenarios timelines on a live system) ----------
    def apply_scenario_event(self, ev, now: float = 0.0) -> dict:
        """Apply one ``repro_torch.core.scenarios.ScenarioEvent`` to the live
        system: ``fail`` -> :meth:`fail_server`, ``fail_group`` ->
        :meth:`fail_servers`, ``add`` -> :meth:`add_server`, ``slowdown`` ->
        :meth:`report_tau` (the scale is fed as the observed straggler
        ratio).  ``burst`` events shape the request arrival process, not the
        cluster, and are a no-op here."""
        out = {"time": ev.time, "kind": ev.kind, "requeued": 0}
        if ev.kind == "fail":
            if ev.sid in self.servers:
                out["requeued"] = self.fail_server(ev.sid, now)
        elif ev.kind == "fail_group":
            present = [sid for sid in ev.sids if sid in self.servers]
            if present:
                out["requeued"] = self.fail_servers(present, now)
        elif ev.kind == "add":
            self.add_server(ev.server, now)
        elif ev.kind == "slowdown":
            self.report_tau(ev.sid, ev.scale, now)
        out["chains"] = len(self.engines)
        return out

    def run_scenario(
        self,
        scenario,
        requests: Sequence,
        dt: float = 1.0,
        max_rounds: int = 100_000,
    ) -> dict:
        """Deprecated compatibility shim — the decode-round drive loop now
        lives in :func:`repro_torch.api.planes.drive_orchestrator` (the live
        plane's executor), which also fast-forwards idle stretches instead
        of spinning ``dt`` at a time.  Declarative runs should build a
        ``repro_torch.api.ExperimentSpec`` and call
        ``repro_torch.api.run(spec, plane="live")``; this method survives for
        callers holding a live orchestrator with their own ``Request``
        objects and returns the same summary dict as before.
        """
        import warnings

        warnings.warn(
            "Orchestrator.run_scenario is deprecated; use repro_torch.api.run("
            "spec, plane='live') or repro_torch.api.planes.drive_orchestrator",
            DeprecationWarning, stacklevel=2)
        from repro_torch.api.planes import drive_orchestrator

        return drive_orchestrator(self, scenario, requests, dt=dt,
                                  max_rounds=max_rounds)

    # -- introspection ---------------------------------------------------------------
    def stats(self) -> dict:
        rts = [r.response_time() for r in self.finished if r.response_time() is not None]
        out = {
            "finished": len(self.finished),
            "failed": len(self.failed),
            "queued": len(self.queue),
            "deferred": len(self.deferred),
            "active": sum(e.num_active for e in self.engines),
            "draining": sum(len(e.requests) for e in self.draining),
            "chains": [(list(e.chain.servers), e.capacity) for e in self.engines],
            "warming": sorted(self.warming),
            "c_star": self.c_star,
            "recompositions": self.recompositions,
            "mean_response": float(np.mean(rts)) if rts else math.nan,
        }
        if len(self.classes) > 1:
            out["per_class"] = self.per_class_stats()
        return out

    def per_class_stats(self) -> Dict[int, dict]:
        """Per-SLO-class completion counts and response quantiles."""
        out: Dict[int, dict] = {}
        for c, rc in enumerate(self.classes):
            rts = np.asarray([r.response_time() for r in self.finished
                              if r.cls == c and r.response_time() is not None])
            out[c] = {
                "name": rc.name,
                "finished": int(sum(1 for r in self.finished if r.cls == c)),
                "deferred": int(sum(1 for r in self.deferred if r.cls == c)),
                "mean_response": float(np.mean(rts)) if len(rts) else math.nan,
                "p99_response": float(np.percentile(rts, 99)) if len(rts)
                else math.nan,
                "slo_target": rc.slo_target,
            }
        return out

"""Scenario engine: scripted dynamic-cluster events over a serving system.

The paper's Section 4 experiments are static — fixed cluster, stationary
Poisson arrivals.  Serverless-scale serving is not: DeepServe
(arXiv:2501.14417) stresses bursty scale-out phases and FailSafe
(arXiv:2511.14116) mid-flight server failures as the regimes where
composition policies actually differentiate.  This module scripts those
regimes on top of the control-plane algorithms:

* a :class:`Scenario` is a timeline of :class:`ScenarioEvent`'s over a
  cluster — server **failure**, **add** (recovery / autoscale-in),
  **slowdown** (straggler drift, a tau multiplier), and **burst** phases
  (arrival-rate multipliers over a window);
* the **live plane** (:class:`repro_torch.api.planes.LivePlane`) exposes
  the timeline to a live ``repro_torch.serving.Orchestrator`` (decode
  rounds over the chain engines), which recomposes the cluster with the
  paper's full offline pipeline (tuned c -> GBP-CR -> GCA) at every
  cluster event.

Burst phases affect workload generation (piecewise-constant-rate Poisson via
:func:`repro_torch.core.workload.phased_poisson`); cluster events trigger
recomposition.  When a failure leaves the cluster infeasible for the target
load, composition degrades gracefully instead of raising — an overloaded
system keeps serving, slowly, like the real one.

Trace-driven mode: arrivals given as the 4-tuple produced by
:func:`repro_torch.core.workload.azure_like_trace_np` with
``service_model="tokens"`` derive per-job service demand from the trace's
(in_tokens, out_tokens) via :func:`repro_torch.core.workload.token_work`.

A copy of the JAX package's ``core/scenarios.py`` without
``run_scenario``, which drives the sim plane (ROADMAP queue 1, item 9);
the composition and membership helpers and the result types it uses are
kept for that plane.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .servers import Server, ServiceSpec
from .simulator import SimResult
from .tuning import compose_best_effort
from .workload import (
    classed_phased_poisson, phased_poisson, token_work,
)

#: known event kinds
EVENT_KINDS = ["fail", "add", "slowdown", "burst", "fail_group",
               "tenant_burst", "region_burst", "region_evacuate",
               "region_partition"]

#: event kinds that shape the arrival process rather than the cluster
BURST_KINDS = ("burst", "tenant_burst")

#: event kinds scoped to a geo region fleet (the JAX package's
#: ``repro.geo``, not ported): they are executed by the cross-region layer,
#: never by the per-cluster membership machinery (``cluster_events``
#: excludes them like it excludes bursts)
REGION_KINDS = ("region_burst", "region_evacuate", "region_partition")


@dataclasses.dataclass(frozen=True)
class ScenarioEvent:
    """One timed event.  ``scale`` is the tau multiplier for ``slowdown``
    (absolute, relative to nominal) and the rate multiplier for ``burst`` /
    ``tenant_burst``; ``duration`` is only meaningful for bursts; ``sids``
    names the member set of a correlated ``fail_group`` (a rack, a power
    domain); ``cls`` names the request class a ``tenant_burst`` multiplies
    (one tenant's traffic spikes, the others' stays flat).

    Region-scoped kinds (executed by the JAX package's geo layer) reuse the same
    fields: ``region_burst`` multiplies one *source region's* arrival rate
    (``sid`` = region name, ``scale``/``duration`` as for ``burst``);
    ``region_evacuate`` drains a region out of the routing target set
    (``sid`` = region name); ``region_partition`` cuts the named region
    group (``sids``) off from the rest of the fleet for ``duration``
    seconds — each side serves split-brain and reconciles on heal."""
    time: float
    kind: str
    sid: str = ""
    server: Optional[Server] = None
    scale: float = 1.0
    duration: float = 0.0
    sids: Tuple[str, ...] = ()
    cls: int = -1

    def __post_init__(self):
        if self.kind not in EVENT_KINDS:
            raise ValueError(f"unknown event kind {self.kind!r}")
        if self.kind == "add" and self.server is None:
            raise ValueError("add event needs a server")
        if self.kind in ("fail", "slowdown") and not self.sid:
            raise ValueError(f"{self.kind} event needs a server id")
        if self.kind == "fail_group" and not self.sids:
            raise ValueError("fail_group event needs a non-empty sid set")
        if self.kind == "tenant_burst" and self.cls < 0:
            raise ValueError("tenant_burst event needs a class index")
        if self.kind in ("region_burst", "region_evacuate") and not self.sid:
            raise ValueError(f"{self.kind} event needs a region name (sid)")
        if self.kind == "region_partition":
            if not self.sids:
                raise ValueError(
                    "region_partition event needs a non-empty region group "
                    "(sids)")
            if self.duration <= 0:
                raise ValueError(
                    "region_partition event needs a positive duration "
                    "(partitions heal at time + duration)")


@dataclasses.dataclass
class Scenario:
    """A timeline of cluster + workload events over ``[0, horizon)``."""
    horizon: float
    events: List[ScenarioEvent] = dataclasses.field(default_factory=list)
    description: str = ""

    # -- chainable builders ---------------------------------------------------
    def fail(self, time: float, sid: str) -> "Scenario":
        self.events.append(ScenarioEvent(time, "fail", sid=sid))
        return self

    def add(self, time: float, server: Server) -> "Scenario":
        self.events.append(ScenarioEvent(time, "add", server=server))
        return self

    # recovery is adding the same server back
    recover = add

    def fail_group(self, time: float, sids: Sequence[str]) -> "Scenario":
        """Correlated failure: one event takes down a named server set
        (e.g. a rack sharing a switch or power domain)."""
        self.events.append(
            ScenarioEvent(time, "fail_group", sids=tuple(sids)))
        return self

    def slowdown(self, time: float, sid: str, scale: float) -> "Scenario":
        self.events.append(ScenarioEvent(time, "slowdown", sid=sid, scale=scale))
        return self

    def burst(self, time: float, duration: float, scale: float) -> "Scenario":
        self.events.append(
            ScenarioEvent(time, "burst", scale=scale, duration=duration))
        return self

    def tenant_burst(self, time: float, duration: float, scale: float,
                     cls: int) -> "Scenario":
        """One tenant class's arrival rate spikes (a product launch, a batch
        backfill) while every other class's stays flat — the regime where
        class-blind scheduling lets one tenant's burst destroy everyone
        else's SLO."""
        self.events.append(ScenarioEvent(time, "tenant_burst", scale=scale,
                                         duration=duration, cls=cls))
        return self

    def region_burst(self, time: float, duration: float, scale: float,
                     region: str) -> "Scenario":
        """One source region's arrival rate spikes (a regional product
        launch) while the other regions' traffic stays flat."""
        self.events.append(ScenarioEvent(time, "region_burst", sid=region,
                                         scale=scale, duration=duration))
        return self

    def region_evacuate(self, time: float, region: str) -> "Scenario":
        """Drain a region out of the routing target set: from ``time`` on,
        no new work is routed there (its own sources route to survivors);
        in-queue work finishes locally."""
        self.events.append(ScenarioEvent(time, "region_evacuate",
                                         sid=region))
        return self

    def region_partition(self, time: float, duration: float,
                         sids: Sequence[str]) -> "Scenario":
        """Network partition: the named region group loses connectivity to
        the rest of the fleet for ``duration`` seconds.  Each side routes
        and serves split-brain; unroutable arrivals defer and reconcile at
        ``time + duration`` (the heal)."""
        self.events.append(ScenarioEvent(time, "region_partition",
                                         sids=tuple(sids),
                                         duration=duration))
        return self

    # -- views ------------------------------------------------------------------
    def cluster_events(self) -> List[ScenarioEvent]:
        """fail/add/slowdown events, time-sorted (stable)."""
        evs = [e for e in self.events
               if e.kind not in BURST_KINDS and e.kind not in REGION_KINDS]
        return sorted(evs, key=lambda e: e.time)

    def region_events(self) -> List[ScenarioEvent]:
        """Region-scoped events (``REGION_KINDS``), time-sorted (stable)."""
        evs = [e for e in self.events if e.kind in REGION_KINDS]
        return sorted(evs, key=lambda e: e.time)

    def _overlay(self, base_rate: float,
                 bursts: List[ScenarioEvent]) -> List[Tuple[float, float, float]]:
        """Piecewise-constant rate over [0, horizon): base times the product
        of every given burst multiplier active in the segment."""
        points = {0.0, self.horizon}
        for b in bursts:
            points.add(min(b.time, self.horizon))
            points.add(min(b.time + b.duration, self.horizon))
        cuts = sorted(p for p in points if 0.0 <= p <= self.horizon)
        phases = []
        for a, b in zip(cuts[:-1], cuts[1:]):
            rate = base_rate
            for ev in bursts:
                if ev.time <= a and a < ev.time + ev.duration:
                    rate *= ev.scale
            if b > a:
                phases.append((a, b, rate))
        return phases

    def arrival_phases(self, base_rate: float) -> List[Tuple[float, float, float]]:
        """Class-blind rate profile: global ``burst`` multipliers only
        (``tenant_burst`` events need the per-class view below)."""
        return self._overlay(
            base_rate, [e for e in self.events if e.kind == "burst"])

    def class_arrival_phases(
        self, class_rates: Sequence[float]
    ) -> List[List[Tuple[float, float, float]]]:
        """Per-class rate profiles: class ``c`` sees every global ``burst``
        plus the ``tenant_burst`` events addressed to it."""
        out = []
        for c, base in enumerate(class_rates):
            bursts = [e for e in self.events
                      if e.kind == "burst"
                      or (e.kind == "tenant_burst" and e.cls == c)]
            out.append(self._overlay(base, bursts))
        return out

    def region_arrival_phases(
        self, base_rate: float, region: str
    ) -> List[Tuple[float, float, float]]:
        """One source region's rate profile: every global ``burst`` plus
        the ``region_burst`` events addressed to it.  With no region bursts
        this is exactly :meth:`arrival_phases` — the geo layer's
        single-region parity anchor."""
        bursts = [e for e in self.events
                  if e.kind == "burst"
                  or (e.kind == "region_burst" and e.sid == region)]
        return self._overlay(base_rate, bursts)

    def region_class_arrival_phases(
        self, class_rates: Sequence[float], region: str
    ) -> List[List[Tuple[float, float, float]]]:
        """Per-class rate profiles for one source region: class ``c`` sees
        global bursts, its own ``tenant_burst`` events, and the region's
        ``region_burst`` events."""
        out = []
        for c, base in enumerate(class_rates):
            bursts = [e for e in self.events
                      if e.kind == "burst"
                      or (e.kind == "tenant_burst" and e.cls == c)
                      or (e.kind == "region_burst" and e.sid == region)]
            out.append(self._overlay(base, bursts))
        return out

    def generate_arrivals(
        self, base_rate: float, seed: int = 0
    ) -> Tuple[np.ndarray, np.ndarray]:
        """(times, works) over the horizon, bursts applied."""
        return phased_poisson(self.arrival_phases(base_rate), seed=seed)

    def generate_classed_arrivals(
        self, class_rates: Sequence[float], seed: int = 0
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Class-labeled ``(times, works, class_ids)`` over the horizon —
        per-class base rates with global and tenant bursts applied."""
        return classed_phased_poisson(
            self.class_arrival_phases(class_rates), seed=seed)


# ---------------------------------------------------------------------------
# Scenario results and the composition / membership helpers
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class ScenarioLogEntry:
    time: float
    kind: str
    sid: str
    requeued: int           # in-flight/queued jobs re-dispatched
    n_chains: int
    total_rate: float       # nu of the new composition
    degraded: bool          # demand infeasible: composed for the largest
    #                         feasible load instead
    drained: int = 0        # in-flight jobs drained out-of-band (voluntary
    #                         recompositions only)


@dataclasses.dataclass
class ScenarioResult:
    result: SimResult
    log: List[ScenarioLogEntry]
    n_jobs: int
    completed_all: bool
    reconfigurations: int
    restarts: int
    n_rejected: int = 0        # shed by the admission gate (never lost)

    def p99(self) -> float:
        rt = self.result.response_times
        return float(np.percentile(rt, 99)) if len(rt) else math.nan

    def per_class(self, response_stats=None, waiting_stats=None) -> dict:
        """Per-class response/waiting quantiles (empty for class-blind runs);
        optional precomputed whole-run stats pass through to
        :meth:`SimResult.per_class`."""
        return self.result.per_class(response_stats, waiting_stats)


def compose_or_degrade(
    servers: Sequence[Server],
    spec: ServiceSpec,
    lam: float,
    rho_bar: float,
    tuner: str = "bound-lower",
) -> Tuple[List[float], List[int], List[Tuple], bool]:
    """(rates, caps, keys, degraded) of the best composition for the cluster.

    Runs the paper's tuned pipeline; if the demand is infeasible for the
    (possibly shrunken) cluster, degrades to the *largest feasible load*:
    bisect the biggest fraction of ``lam`` the cluster still composes for
    and serve with that chain set — an overloaded system keeps serving at
    its actual capacity instead of collapsing to a throughput-pessimal
    composition.  (The old fallback — ``c = 1`` over every server — starved
    cache concurrency exactly when the queue was longest; it remains the
    last resort when even a vanishing load is infeasible.)  Returns empty
    lists when not a single complete chain can be formed.  ``keys`` are the
    chains' physical identities (server-id + block tuples), used by
    the simulator's ``reconfigure`` to decide which chains truly survive a
    recomposition.
    """
    _, alloc, degraded = compose_best_effort(servers, spec, lam, rho_bar,
                                             tuner=tuner)
    pairs = alloc.sorted_by_rate()
    rates = [ch.rate for ch, _ in pairs]
    caps = [c for _, c in pairs]
    keys = [ch.key() for ch, _ in pairs]
    return rates, caps, keys, degraded


def _effective(cluster: Dict[str, Server], tau: Dict[str, float]) -> List[Server]:
    return [
        Server(s.sid, s.memory_gb, s.tau_c * tau[s.sid], s.tau_p * tau[s.sid])
        for s in cluster.values()
    ]


def _apply_membership(cluster: Dict[str, Server], tau: Dict[str, float],
                      ev: ScenarioEvent) -> str:
    """Mutate the cluster/straggler view for one event; returns the display
    sid (comma-joined for correlated groups)."""
    if ev.kind == "fail":
        cluster.pop(ev.sid, None)
        tau.pop(ev.sid, None)
        return ev.sid
    if ev.kind == "fail_group":
        for sid in ev.sids:
            cluster.pop(sid, None)
            tau.pop(sid, None)
        return ",".join(ev.sids)
    if ev.kind == "add":
        cluster[ev.server.sid] = ev.server
        tau[ev.server.sid] = 1.0
        return ev.server.sid
    if ev.kind == "slowdown":
        if ev.sid in tau:
            tau[ev.sid] = ev.scale
        return ev.sid
    raise ValueError(f"not a cluster event: {ev.kind!r}")


def _resolve_arrivals(
    scenario: Scenario,
    base_rate: float,
    seed: int,
    arrivals,
    service_model: str,
    trace_stats,
    class_rates: Optional[Sequence[float]] = None,
) -> Tuple[np.ndarray, np.ndarray, Optional[np.ndarray]]:
    """(times, works, class_ids) for the run; in ``tokens`` mode the works
    are derived from the trace's per-job (in_tokens, out_tokens) via
    ``token_work``.  ``class_ids`` is None for class-blind runs; explicit
    arrivals may carry labels as a third column (work mode) or fifth column
    (token mode, e.g. ``classed_azure_trace_np``)."""
    if service_model not in ("work", "tokens"):
        raise ValueError("service_model must be 'work' or 'tokens'")
    if service_model == "tokens":
        if arrivals is None or len(arrivals) not in (4, 5):
            raise ValueError(
                "service_model='tokens' needs arrivals=(times, works, "
                "in_tokens, out_tokens[, class_ids]), e.g. from "
                "azure_like_trace_np / classed_azure_trace_np")
        times, tin, tout = arrivals[0], arrivals[2], arrivals[3]
        cls = arrivals[4] if len(arrivals) == 5 else None
        return np.asarray(times, dtype=np.float64), \
            token_work(tin, tout, stats=trace_stats), cls
    if arrivals is None:
        if class_rates is not None:
            return scenario.generate_classed_arrivals(class_rates, seed=seed)
        t, w = scenario.generate_arrivals(base_rate, seed=seed)
        return t, w, None
    if len(arrivals) == 5:            # class-labeled token trace, work mode
        return arrivals[0], arrivals[1], arrivals[4]
    if len(arrivals) == 4:            # token-count trace, work mode: use works
        return arrivals[0], arrivals[1], None
    if len(arrivals) == 3:            # class-labeled (times, works, cls)
        return arrivals[0], arrivals[1], arrivals[2]
    return arrivals[0], arrivals[1], None

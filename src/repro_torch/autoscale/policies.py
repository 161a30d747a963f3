"""Autoscaling policies: the decision half of the feedback loop.

Every policy maps (telemetry window, cluster view) -> an
:class:`AutoscaleAction` (how many servers to add / remove and why).  The
controller owns the actuation mechanics — cooldown, hysteresis floor/ceiling,
warm-up lag, victim selection, cost accounting — so policies stay pure
functions of the observed state and are directly comparable on the
cost/latency frontier.

Three families, in increasing sophistication:

  * :class:`TargetUtilizationPolicy` — the classic reactive controller:
    scale out above a high-water slot utilization, scale in below a
    low-water mark (the gap between the two marks is the hysteresis band).
  * :class:`QueueGradientPolicy` — reacts to the *derivative* of queue
    depth, catching overload while utilization still reads 100%-and-flat
    (a saturated cluster has no utilization signal left; its queue slope is
    the only observable).
  * :class:`PredictivePolicy` — fits the arrival-rate trend over the
    telemetry window, forecasts the rate one provisioning-lag ahead, and
    sizes the cluster with the paper's own composition pipeline as the
    oracle: the smallest number of template servers whose tuned
    c -> GBP-CR -> GCA composition is feasible for the forecast load.
    Provisioning *ahead* of the ramp hides the warm-up lag that the reactive
    policies eat as queueing delay.

:class:`SLOAwareAdmissionPolicy` composes with any of them for multi-tenant
fleets: it watches the *protected* class's windowed p99 and, on an SLO
breach, first tightens the admission gate (defer/shed best-effort work —
free and instantly reversible) and only delegates to the wrapped scaling
policy once admission is exhausted — the "shed before you spend" rule of
serverless LLM serving.

A copy of the JAX package's ``autoscale/policies.py``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Sequence

from repro_torch.core.servers import Server, ServiceSpec
from repro_torch.core.tuning import compose

from .telemetry import Telemetry


@dataclasses.dataclass(frozen=True)
class ClusterView:
    """What a policy may know about the cluster at a control tick."""
    servers: List[Server]          # active (composed, serving) servers
    pending: List[Server]          # provisioned but still warming up
    spec: ServiceSpec
    rho_bar: float
    total_rate: float              # nu of the current composition
    admission_level: float = 1.0   # current best-effort throttle (1 = open)

    @property
    def n_provisioned(self) -> int:
        return len(self.servers) + len(self.pending)


@dataclasses.dataclass(frozen=True)
class AutoscaleAction:
    add: int = 0
    remove: int = 0
    reason: str = ""
    # target admission throttle (None = leave unchanged); the controller
    # actuates it on the engine/orchestrator admission gate
    admission_level: Optional[float] = None

    @property
    def is_noop(self) -> bool:
        return self.add == 0 and self.remove == 0 \
            and self.admission_level is None


class AutoscalePolicy:
    """Base: a named, stateless decision rule."""

    name = "base"

    def decide(self, tel: Telemetry, view: ClusterView,
               now: float) -> AutoscaleAction:
        raise NotImplementedError

    def sizing_rate(self, tel: Telemetry, lag: float) -> float:
        """The arrival rate the cluster should be *composed* for.

        The controller recomposes after every action it takes; composing for
        a lower rate than the policy sized the hardware for under-builds the
        chain set (tuned c targets the given load), so the policy states its
        own target.  ``lag`` is the controller's warm-up lag.  The base rule
        covers the reactive policies: current estimate vs. one-lag forecast.
        """
        return max(tel.arrival_rate(), tel.forecast_rate(lag))


def composition_feasible(servers: Sequence[Server], spec: ServiceSpec,
                         rate: float, rho_bar: float) -> bool:
    """Can the paper's tuned pipeline compose ``servers`` for ``rate``?"""
    if not servers or rate <= 0:
        return bool(servers)
    try:
        compose(servers, spec, rate, rho_bar)
        return True
    except ValueError:
        return False


def servers_needed(
    base: Sequence[Server],
    template: Server,
    spec: ServiceSpec,
    rate: float,
    rho_bar: float,
    max_extra: int = 64,
) -> Optional[int]:
    """Sizing oracle: the smallest ``k >= 0`` such that ``base`` plus ``k``
    template clones composes feasibly for ``rate`` (None if even
    ``max_extra`` clones cannot).  Clone sids are placeholders — the
    controller mints real ones at provisioning time."""
    pool = list(base)
    for k in range(max_extra + 1):
        if composition_feasible(pool, spec, rate, rho_bar):
            return k
        pool.append(Server(f"__probe{k}__", template.memory_gb,
                           template.tau_c, template.tau_p))
    return None


class TargetUtilizationPolicy(AutoscalePolicy):
    """Reactive threshold controller with a hysteresis band.

    Above ``high``: add servers proportional to the overshoot (at least one).
    Below ``low`` *and* queue empty: remove one (gentle scale-in — one server
    per cooldown window avoids oscillation).  Between the marks: hold.
    """

    name = "target-util"

    def __init__(self, high: float = 0.85, low: float = 0.40):
        if not 0.0 < low < high <= 1.0:
            raise ValueError("need 0 < low < high <= 1")
        self.high = high
        self.low = low

    def decide(self, tel: Telemetry, view: ClusterView,
               now: float) -> AutoscaleAction:
        util = tel.utilization()
        if util > self.high:
            # size the overshoot against the mid-band target utilization
            target = 0.5 * (self.high + self.low)
            n = max(1, len(view.servers))
            add = max(1, int(math.ceil(n * (util / target - 1.0))))
            return AutoscaleAction(
                add=add, reason=f"util {util:.2f} > {self.high:.2f}")
        if util < self.low and tel.queue_depth() == 0 \
                and view.n_provisioned > 1:
            return AutoscaleAction(
                remove=1, reason=f"util {util:.2f} < {self.low:.2f}")
        return AutoscaleAction(reason=f"util {util:.2f} in band")


class QueueGradientPolicy(AutoscalePolicy):
    """Scale on queue growth: a saturated cluster's utilization pegs at 1.0
    and carries no signal, but its queue-depth slope (jobs/s of unmet
    demand) directly measures the service-rate deficit.  Scale-out is sized
    so the deficit clears within ``drain_target`` seconds; scale-in mirrors
    the utilization policy's low-water mark."""

    name = "queue-gradient"

    def __init__(self, depth_threshold: int = 4, drain_target: float = 30.0,
                 low_util: float = 0.40):
        self.depth_threshold = depth_threshold
        self.drain_target = drain_target
        self.low_util = low_util

    def decide(self, tel: Telemetry, view: ClusterView,
               now: float) -> AutoscaleAction:
        depth = tel.queue_depth()
        grad = tel.queue_gradient()
        if depth > self.depth_threshold and grad > 0:
            # per-server service rate of the current composition
            per_server = view.total_rate / max(1, len(view.servers))
            deficit = grad + depth / self.drain_target
            add = max(1, int(math.ceil(deficit / max(per_server, 1e-9))))
            return AutoscaleAction(
                add=add,
                reason=f"queue {depth} growing at {grad:.2f}/s")
        if depth == 0 and tel.utilization() < self.low_util \
                and view.n_provisioned > 1:
            return AutoscaleAction(remove=1, reason="queue empty, low util")
        return AutoscaleAction(reason=f"queue {depth}, grad {grad:.2f}")


class PredictivePolicy(AutoscalePolicy):
    """Trend-forecast sizing through the composition oracle.

    Forecast the arrival rate ``lead`` seconds ahead (the controller sets
    ``lead`` to its warm-up lag plus one control interval, so capacity
    ordered now is warm exactly when the forecast load lands), inflate by a
    safety ``margin``, and ask :func:`servers_needed` how many template
    servers the composition pipeline needs for that load.  Scale in only
    when the forecast says the cluster stays feasible after shedding one
    server — checked through the same oracle, not a utilization proxy.
    """

    name = "predictive"

    def __init__(self, template: Server, lead: float = 20.0,
                 margin: float = 1.2, max_extra_per_tick: int = 4,
                 remove_margin: float = 1.6,
                 max_util_for_remove: float = 0.5):
        self.template = template
        self.lead = lead
        self.margin = margin
        self.max_extra_per_tick = max_extra_per_tick
        self.remove_margin = remove_margin
        self.max_util_for_remove = max_util_for_remove

    def _forecast(self, tel: Telemetry) -> float:
        """Trend-extrapolated rate, clamped to [0.5x, 2x] of the current
        estimate — a least-squares slope over a short noisy window can
        otherwise order a fleet for a spike that never comes."""
        rate = tel.arrival_rate()
        forecast = tel.forecast_rate(self.lead)
        if rate > 0:
            forecast = min(max(forecast, 0.5 * rate), 2.0 * rate)
        return forecast

    def sizing_rate(self, tel: Telemetry, lag: float) -> float:
        return max(tel.arrival_rate(), self._forecast(tel) * self.margin)

    def decide(self, tel: Telemetry, view: ClusterView,
               now: float) -> AutoscaleAction:
        forecast = self._forecast(tel) * self.margin
        provisioned = view.servers + view.pending
        if forecast <= 0:
            return AutoscaleAction(reason="no load forecast")
        need = servers_needed(provisioned, self.template, view.spec,
                              forecast, view.rho_bar,
                              max_extra=self.max_extra_per_tick)
        if need is None:
            need = self.max_extra_per_tick
        if need > 0:
            return AutoscaleAction(
                add=need,
                reason=f"forecast {forecast:.2f}/s needs +{need}")
        # Scale in only when it is *safe*: demand not rising, nothing queued,
        # the cluster mostly idle (an eviction restarts in-flight jobs — at
        # low utilization there are few to restart), and the trimmed cluster
        # still composes for the forecast at a wider safety margin.
        if len(provisioned) > 1 and tel.rate_trend() <= 0 \
                and tel.queue_depth() == 0 \
                and tel.utilization() < self.max_util_for_remove:
            trimmed = provisioned[:-1]
            guard = self._forecast(tel) * self.remove_margin
            if composition_feasible(trimmed, view.spec, guard,
                                    view.rho_bar):
                return AutoscaleAction(
                    remove=1, reason=f"forecast {forecast:.2f}/s fits n-1")
        return AutoscaleAction(reason=f"forecast {forecast:.2f}/s fits")


class SLOAwareAdmissionPolicy(AutoscalePolicy):
    """Shed/defer best-effort work before paying for scale-out.

    Wraps any scaling policy.  Watches the *protected* class's windowed p99
    (class index ``protected_cls``, SLO ``slo`` seconds):

      * p99 over SLO and the admission gate not yet fully closed — tighten
        the gate (halve the level; below ``floor_snap`` snap to 0, deferring
        all best-effort work that would queue).  No servers are ordered:
        admission is free and reverses at the next tick, a scale-out bills
        for its whole lifetime.
      * p99 over SLO with the gate already closed — best-effort shedding is
        exhausted; the *protected* load alone is too much.  Delegate to the
        wrapped policy (scale out).
      * p99 comfortably under SLO (below ``relax_guard * slo``) with the
        gate partially closed and no queue — re-open it gradually (double),
        then let the wrapped policy consider scale-in.

    With a single class (or no SLO) it is transparent: every decision is
    the wrapped policy's.
    """

    name = "slo-admission"

    def __init__(self, inner: AutoscalePolicy, slo: float,
                 protected_cls: int = 0, min_level: float = 0.0,
                 tighten: float = 0.5, relax: float = 2.0,
                 relax_guard: float = 0.5, floor_snap: float = 0.05):
        if slo <= 0:
            raise ValueError("slo must be positive")
        self.inner = inner
        self.slo = float(slo)
        self.protected_cls = protected_cls
        self.min_level = float(min_level)
        self.tighten = float(tighten)
        self.relax = float(relax)
        self.relax_guard = float(relax_guard)
        self.floor_snap = float(floor_snap)

    def sizing_rate(self, tel: Telemetry, lag: float) -> float:
        return self.inner.sizing_rate(tel, lag)

    def decide(self, tel: Telemetry, view: ClusterView,
               now: float) -> AutoscaleAction:
        p99 = tel.response_quantile(99.0, cls=self.protected_cls)
        lvl = view.admission_level
        if not math.isnan(p99) and p99 > self.slo:
            if lvl > self.min_level + 1e-9:
                new = lvl * self.tighten
                if new < self.floor_snap:
                    new = self.min_level
                return AutoscaleAction(
                    admission_level=new,
                    reason=f"p99 {p99:.2f} > slo {self.slo:g}: "
                           f"admission {lvl:g} -> {new:g}")
            return self.inner.decide(tel, view, now)   # shedding exhausted
        if lvl < 1.0 and tel.queue_depth() == 0 \
                and (math.isnan(p99) or p99 < self.relax_guard * self.slo):
            new = min(1.0, max(lvl * self.relax, self.floor_snap))
            return AutoscaleAction(
                admission_level=new,
                reason=f"p99 {p99:.2f} under slo: "
                       f"admission {lvl:g} -> {new:g}")
        return self.inner.decide(tel, view, now)

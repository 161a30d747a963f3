"""Autoscale controller: closes the telemetry -> policy -> recompose loop.

The controller owns everything a policy should not have to think about:

  * **cadence** — one decision per ``interval`` seconds, enforced
    **cooldown** between scaling actions (no add/remove churn);
  * **provisioning delay** — a scale-out decision at ``t`` yields a server
    that only joins the composition at ``t + warmup_lag``; until then it is
    *provisioned* (billed, visible as pending/warming) but receives no
    dispatches;
  * **bounds** — ``min_servers`` <= provisioned count <= ``max_servers``,
    and only servers the controller itself added are eligible victims for
    scale-in (the operator's base cluster is never shrunk);
  * **cost accounting** — the exact piecewise-constant integral of
    provisioned-server count over time (server-seconds), plus SLO-violation
    counting, so every policy lands on the same cost/latency axes.

Two actuation planes share the same decision core:

  * the **simulated** plane calls :meth:`AutoscaleController.control_tick`
    at every control interval with the paused simulator's telemetry; the
    controller answers with synthesized ``ScenarioEvent`` add/fail actions
    that flow through the same recomposition path as scripted events (the
    sim plane is not ported yet: ROADMAP queue 1, item 9);
  * the **live** plane — :meth:`bind_orchestrator` registers submit/step
    hooks on a ``repro_torch.serving.Orchestrator``; decisions actuate
    through ``add_server`` (with a warm-up deadline) and
    ``retire_servers``.

A copy of the JAX package's ``autoscale/controller.py`` (numpy only).
"""
from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.servers import Server

from .policies import AutoscaleAction, AutoscalePolicy, ClusterView
from .telemetry import Telemetry, TelemetryConfig, sample_orchestrator


@dataclasses.dataclass
class ControllerConfig:
    interval: float = 5.0         # seconds between control ticks
    cooldown: float = 15.0        # min seconds between scaling *actions*
    warmup_lag: float = 10.0      # provisioning delay for new servers
    min_servers: int = 1          # floor on provisioned count
    max_servers: int = 64         # ceiling on provisioned count
    slo_response_time: Optional[float] = None   # SLO threshold (seconds)
    # relative sizing-rate deviation that re-runs the composition pipeline on
    # the *same* servers (tuned c targets a specific load; a chain set tuned
    # at the trough underserves the ramp even on identical hardware)
    retune_threshold: float = 0.25


@dataclasses.dataclass
class ScalingRecord:
    """One actuated scaling action (the controller's audit log)."""
    time: float
    action: str                   # "add" | "remove"
    count: int
    sids: List[str]
    reason: str


@dataclasses.dataclass
class CostReport:
    policy: str
    server_seconds: float
    slo: Optional[float]
    slo_violations: int
    n_completed: int
    n_actions: int
    peak_servers: int
    final_servers: int

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


def slo_violations(response_times: np.ndarray,
                   slo: Optional[float]) -> int:
    if slo is None or len(response_times) == 0:
        return 0
    return int(np.sum(np.asarray(response_times) > slo))


class AutoscaleController:
    """Feedback controller binding a policy to an actuation plane."""

    def __init__(
        self,
        policy: AutoscalePolicy,
        template: Server,
        config: ControllerConfig = ControllerConfig(),
        telemetry: Optional[Telemetry] = None,
        telemetry_config: TelemetryConfig = TelemetryConfig(),
    ):
        self.policy = policy
        self.template = template
        self.cfg = config
        self.telemetry = telemetry if telemetry is not None \
            else Telemetry(telemetry_config)
        # provisioning state (simulated plane; the live plane keeps warming
        # state inside the orchestrator)
        self.pending: List[Tuple[float, Server]] = []   # (ready_time, server)
        self.added_sids: List[str] = []                 # LIFO victim stack
        self._minted = 0
        self.last_action_time = -math.inf
        self.records: List[ScalingRecord] = []
        # SLO-aware admission throttle last actuated (1.0 = gate open); the
        # execution plane (simulator / orchestrator) applies it
        self.admission_level = 1.0
        # cost accounting: exact piecewise-constant integral
        self.server_seconds = 0.0
        self._bill_t = 0.0
        self._bill_n: Optional[int] = None
        self.peak_servers = 0
        self._finalized = False
        # optional repro_torch.obs.MetricsRegistry; every ScalingRecord is
        # mirrored into it by _record() when attached
        self.metrics = None

    def _record(self, rec: ScalingRecord) -> None:
        """Append one scaling record, mirroring it into the metrics
        registry (per-action counters + actuation gauges) when one is
        attached by the execution plane."""
        self.records.append(rec)
        if self.metrics is not None:
            m = self.metrics
            m.counter(f"autoscale.{rec.action}").inc()
            m.counter("autoscale.servers_added").inc(
                rec.count if rec.action == "add" else 0)
            m.counter("autoscale.servers_removed").inc(
                rec.count if rec.action == "remove" else 0)
            m.gauge("autoscale.admission_level").set(self.admission_level)

    # -- provisioning ---------------------------------------------------------
    def _mint(self) -> Server:
        self._minted += 1
        return Server(f"as{self._minted}", self.template.memory_gb,
                      self.template.tau_c, self.template.tau_p)

    def take_ready(self, now: float) -> List[Server]:
        """Pending servers whose warm-up lag has elapsed (they join now)."""
        ready = [s for (rt, s) in self.pending if rt <= now]
        self.pending = [(rt, s) for (rt, s) in self.pending if rt > now]
        return ready

    def pick_victims(self, cluster_sids: Sequence[str], n: int) -> List[str]:
        """Scale-in victims: most recently added first (LIFO), only from the
        controller's own additions — never the operator's base cluster."""
        present = set(cluster_sids)
        victims = []
        for sid in reversed(self.added_sids):
            if sid in present:
                victims.append(sid)
                present.discard(sid)
                if len(victims) == n:
                    break
        return victims

    # -- cost accounting --------------------------------------------------------
    def bill(self, now: float, n_provisioned: int) -> None:
        """Advance the server-seconds integral to ``now``.

        ``n_provisioned`` is the count that has been in force since the
        *previous* billing point (membership only changes at control ticks,
        so the integral is exact).  The first call anchors the clock.
        """
        if self._bill_n is not None and now > self._bill_t:
            self.server_seconds += self._bill_n * (now - self._bill_t)
        self._bill_t = max(self._bill_t, now)
        self._bill_n = n_provisioned
        self.peak_servers = max(self.peak_servers, n_provisioned)

    def finalize(self, t_end: float) -> None:
        """Close the billing integral at the end of the run."""
        if not self._finalized and self._bill_n is not None:
            self.bill(t_end, self._bill_n)
            self._finalized = True

    def compose_rate(self, fallback: float) -> float:
        """Target arrival rate for recomposition after an autoscale action —
        delegated to the policy's sizing target (composing for less than the
        policy sized the hardware for would under-build the chain set); the
        controller never sees the true ``base_rate``, ``fallback`` only
        covers the cold start."""
        r = self.policy.sizing_rate(self.telemetry, self.cfg.warmup_lag)
        return r if r > 0 else fallback

    def needs_retune(self, composed_rate: float, fallback: float) -> bool:
        """Has the sizing rate drifted far enough from the rate the current
        chain set was composed for that the pipeline should re-run?"""
        target = self.compose_rate(fallback)
        if composed_rate <= 0:
            return target > 0
        dev = abs(target - composed_rate) / composed_rate
        return dev > self.cfg.retune_threshold

    # -- the decision core -------------------------------------------------------
    def decide(self, view: ClusterView, now: float) -> AutoscaleAction:
        """Run the policy and clamp with cooldown / min / max bounds.

        Cooldown gates *scaling* actions only: an admission retune is free
        and instantly reversible, so it passes through — the gate can keep
        tightening every tick during an active SLO breach while the
        expensive add/remove machinery stays rate-limited.
        """
        if now - self.last_action_time < self.cfg.cooldown:
            action = self.policy.decide(self.telemetry, view, now)
            if action.admission_level is not None \
                    and action.admission_level != view.admission_level:
                return AutoscaleAction(admission_level=action.admission_level,
                                       reason=action.reason)
            return AutoscaleAction(reason="cooldown")
        action = self.policy.decide(self.telemetry, view, now)
        if action.is_noop:
            return action
        provisioned = view.n_provisioned
        add = min(action.add, self.cfg.max_servers - provisioned)
        remove = min(action.remove,
                     max(0, provisioned - self.cfg.min_servers))
        add, remove = max(0, add), max(0, remove)
        if add == 0 and remove == 0:
            if action.admission_level is not None:
                # admission retune survives the scaling clamp untouched
                return AutoscaleAction(
                    admission_level=action.admission_level,
                    reason=action.reason)
            return AutoscaleAction(reason=f"{action.reason} (clamped)")
        return AutoscaleAction(add=add, remove=remove,
                               admission_level=action.admission_level,
                               reason=action.reason)

    # -- simulated plane (the sim plane's hook) ----------------------------------
    def control_tick(self, view: ClusterView, now: float,
                     cluster_sids: Sequence[str]) -> List:
        """One control tick on the simulated plane.

        Telemetry has already been fed (the sim plane samples the paused
        simulator first).  Returns synthesized ``ScenarioEvent`` actions:
        ``add`` events for pending servers whose warm-up elapsed, and
        ``fail`` events for scale-in victims.  New scale-out decisions only
        enter ``pending`` here — their add events fire ``warmup_lag`` later.
        """
        from repro_torch.core.scenarios import ScenarioEvent   # cycle-free import

        events = []
        for srv in self.take_ready(now):
            events.append(ScenarioEvent(now, "add", server=srv))
        action = self.decide(view, now)
        if action.admission_level is not None \
                and action.admission_level != self.admission_level:
            # free and reversible: does not start the scaling cooldown
            self.admission_level = action.admission_level
            self._record(ScalingRecord(now, "admission", 0, [],
                                              action.reason))
        if action.add:
            sids = []
            for _ in range(action.add):
                srv = self._mint()
                sids.append(srv.sid)
                self.pending.append((now + self.cfg.warmup_lag, srv))
                self.added_sids.append(srv.sid)
            self._record(ScalingRecord(now, "add", action.add, sids,
                                              action.reason))
            self.last_action_time = now
        elif action.remove:
            victims = self.pick_victims(cluster_sids, action.remove)
            if victims:
                for sid in victims:
                    events.append(ScenarioEvent(now, "fail", sid=sid))
                self._record(ScalingRecord(
                    now, "remove", len(victims), victims, action.reason))
                self.last_action_time = now
        return events

    # -- live plane (orchestrator hooks) ---------------------------------------------
    def bind_orchestrator(self, orch) -> None:
        """Attach to a live ``Orchestrator``: record arrivals on submit and
        run the control loop between decode rounds (per-step hook).  New
        servers are placed immediately with a warm-up deadline — the
        orchestrator keeps them out of the composition (zero dispatches)
        until the deadline passes."""
        self._orch_next_tick = 0.0
        self._orch_fin_cursor = 0
        # track the gate we actuate (the orchestrator may have been
        # configured with a non-default level before binding)
        self.admission_level = getattr(orch, "admission_level", 1.0)
        # the rate the *active* chain set was composed for — tracked apart
        # from o.lam, which we retarget ahead of warm-joins (a pending
        # server composes at the new rate only when its warm-up elapses)
        self._orch_composed_lam = orch.lam
        self._orch_recompositions = orch.recompositions

        def on_submit(req, now: float) -> None:
            self.telemetry.record_arrival(now)

        def on_step(o, now: float) -> None:
            if now < self._orch_next_tick:
                return
            self._orch_next_tick = now + self.cfg.interval
            if o.recompositions != self._orch_recompositions:
                # something recomposed since our last tick (warm-join,
                # failure): whatever o.lam was then is what's composed now
                self._orch_composed_lam = o.lam
                self._orch_recompositions = o.recompositions
            n_provisioned = len(o.servers)          # warming servers included
            self.bill(now, n_provisioned)
            self._orch_fin_cursor = sample_orchestrator(
                self.telemetry, o, now, self._orch_fin_cursor)
            view = ClusterView(
                servers=[s for sid, s in o.servers.items()
                         if sid not in o.warming],
                pending=[o.servers[sid] for sid in o.warming],
                spec=o.spec,
                rho_bar=o.cfg.rho_bar,
                total_rate=(o.allocation.total_rate
                            if o.allocation is not None else 0.0),
                admission_level=getattr(o, "admission_level", 1.0),
            )
            action = self.decide(view, now)
            if action.admission_level is not None \
                    and action.admission_level != self.admission_level:
                # actuate the admission gate on the live plane: deferred
                # best-effort work yields before any server is ordered —
                # free and reversible, so no scaling cooldown starts
                self.admission_level = action.admission_level
                o.set_admission_level(action.admission_level)
                self._record(ScalingRecord(now, "admission", 0, [],
                                                  action.reason))
            if action.add:
                # retarget o.lam so the warm-join recompose sizes for the
                # new load; the active set retunes on a later tick (the
                # composed-lam record below is deliberately not updated)
                o.lam = self.compose_rate(o.lam)
                sids = []
                for _ in range(action.add):
                    srv = self._mint()
                    sids.append(srv.sid)
                    self.added_sids.append(srv.sid)
                    o.add_server(srv, now,
                                 warmup_until=now + self.cfg.warmup_lag)
                self._record(ScalingRecord(now, "add", action.add,
                                                  sids, action.reason))
                self.last_action_time = now
            elif action.remove:
                victims = self.pick_victims(list(o.servers), action.remove)
                if victims:
                    o.lam = self.compose_rate(o.lam)
                    o.retire_servers(victims, now)   # graceful, not a crash
                    self._orch_composed_lam = o.lam
                    self._record(ScalingRecord(
                        now, "remove", len(victims), victims, action.reason))
                    self.last_action_time = now
            elif self.needs_retune(self._orch_composed_lam, o.lam):
                # same servers, drifted load: retarget the composition
                o.lam = self.compose_rate(o.lam)
                o._recompose_preserving(now, drain=True)
                self._orch_composed_lam = o.lam
            self._orch_recompositions = o.recompositions
            self.bill(now, len(o.servers))

        orch.submit_hooks.append(on_submit)
        orch.step_hooks.append(on_step)

    # -- reporting -----------------------------------------------------------------
    def report(self, response_times: np.ndarray,
               final_servers: int) -> CostReport:
        return CostReport(
            policy=self.policy.name,
            server_seconds=self.server_seconds,
            slo=self.cfg.slo_response_time,
            slo_violations=slo_violations(response_times,
                                          self.cfg.slo_response_time),
            n_completed=len(response_times),
            n_actions=len(self.records),
            peak_servers=self.peak_servers,
            final_servers=final_servers,
        )


def static_baseline_cost(
    n_servers: int,
    t_end: float,
    response_times: np.ndarray,
    slo: Optional[float],
) -> CostReport:
    """The frontier anchor: a fixed (over)provisioned cluster billed on the
    same server-seconds basis as the controller."""
    return CostReport(
        policy="static",
        server_seconds=n_servers * t_end,
        slo=slo,
        slo_violations=slo_violations(response_times, slo),
        n_completed=len(response_times),
        n_actions=0,
        peak_servers=n_servers,
        final_servers=n_servers,
    )

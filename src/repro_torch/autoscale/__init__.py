"""Closed-loop autoscaling control plane (numpy only).

The paper composes a *static* cluster; :mod:`repro_torch.core.scenarios` replays
*scripted* dynamics.  This package closes the loop for *unpredicted* load:

    telemetry (observe)  ->  policy (decide)  ->  controller (actuate)
         ^                                            |
         |   add/fail events + the paper's full       |
         +---- tuned-c -> GBP-CR -> GCA recompose <---+

:class:`Telemetry` estimates arrival rate (EWMA + sliding window), queue
depth/gradient, utilization and response quantiles from either the
queueing simulator (paused at control ticks) or the live orchestrator
(per-decode-round hooks).  Three :class:`AutoscalePolicy` families —
reactive target-utilization, queue-gradient, and predictive (trend forecast
sized by the composition pipeline itself) — are actuated by
:class:`AutoscaleController` with provisioning warm-up lag, cooldown, and
exact server-seconds cost accounting, so policies are comparable on a
cost/latency frontier.

A copy of the JAX package's ``autoscale`` package.
"""
from .telemetry import (
    StateSample,
    Telemetry,
    TelemetryConfig,
    sample_orchestrator,
    sample_simulator,
)
from .policies import (
    AutoscaleAction,
    AutoscalePolicy,
    ClusterView,
    PredictivePolicy,
    QueueGradientPolicy,
    SLOAwareAdmissionPolicy,
    TargetUtilizationPolicy,
    composition_feasible,
    servers_needed,
)
from .controller import (
    AutoscaleController,
    ControllerConfig,
    CostReport,
    ScalingRecord,
    slo_violations,
    static_baseline_cost,
)

__all__ = [
    "StateSample", "Telemetry", "TelemetryConfig",
    "sample_orchestrator", "sample_simulator",
    "AutoscaleAction", "AutoscalePolicy", "ClusterView",
    "PredictivePolicy", "QueueGradientPolicy", "SLOAwareAdmissionPolicy",
    "TargetUtilizationPolicy",
    "composition_feasible", "servers_needed",
    "AutoscaleController", "ControllerConfig", "CostReport", "ScalingRecord",
    "slo_violations", "static_baseline_cost",
]

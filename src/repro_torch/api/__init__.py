"""One experiment API: declarative specs, plane-agnostic execution.

* **Specs** (:mod:`repro_torch.api.spec`): frozen dataclasses —
  :class:`ClusterSpec`, :class:`WorkloadSpec`, :class:`PolicySpec`,
  :class:`AdmissionSpec`, :class:`AutoscaleSpec`, :class:`ScenarioSpec` —
  composed into one :class:`ExperimentSpec` with lossless dict/JSON
  round-trip (the same schema as the JAX package's) and validation errors
  that name the bad field.
* **Registries** (:mod:`repro_torch.api.registry`): dispatch policies,
  tuners, workload generators, autoscale policies and execution planes are
  string-keyed and decorator-extensible.
* **Planes** (:mod:`repro_torch.api.planes`): :class:`LivePlane` runs the
  serving orchestrator over mock or torch chain engines; :func:`run`
  returns one :class:`RunReport` schema.

    >>> from repro_torch import api
    >>> spec = api.ExperimentSpec(
    ...     cluster=api.ClusterSpec(servers=servers, service=service),
    ...     scenario=api.ScenarioSpec(horizon=10.0),
    ...     workload=api.WorkloadSpec(generator="poisson", base_rate=2.0,
    ...                               params={"n": 16}))
    >>> plane = api.LivePlane(engine="torch", model=model, params=params)
    >>> api.run(spec, plane=plane).p99()

The port's copy of the JAX package's ``repro.api``; what it leaves out
(the sim plane, the flight recorder, the results store, presets, sweeps
and multi-region fleets) is queued in ROADMAP queue 1.
"""
from .registry import (
    DISPATCH_POLICIES,
    PLANES,
    Registry,
    SCALERS,
    TUNERS,
    UnknownNameError,
    WORKLOADS,
)
from .spec import (
    AdmissionSpec,
    AutoscaleSpec,
    ClusterSpec,
    ENGINE_SEED_OFFSET,
    ExperimentSpec,
    PolicySpec,
    ScenarioSpec,
    SpecError,
    WorkloadSpec,
)
from .report import RunReport
from .planes import LivePlane, drive_orchestrator
from .runner import get_plane, run

__all__ = [
    "Registry", "UnknownNameError",
    "DISPATCH_POLICIES", "TUNERS", "WORKLOADS", "SCALERS", "PLANES",
    "ClusterSpec", "WorkloadSpec", "PolicySpec", "AdmissionSpec",
    "AutoscaleSpec", "ScenarioSpec", "ExperimentSpec",
    "SpecError", "ENGINE_SEED_OFFSET",
    "RunReport",
    "LivePlane", "drive_orchestrator",
    "run", "get_plane",
]

"""Declarative experiment specs: one frozen description of a whole run.

An :class:`ExperimentSpec` composes six sub-specs — cluster, workload,
dispatch policy, admission, optional autoscaling, and the scenario timeline
— into a single immutable value that any execution plane can run (the
port has :class:`repro_torch.api.planes.LivePlane`).  Specs round-trip losslessly through plain dicts and JSON
(:meth:`ExperimentSpec.to_dict` / :meth:`ExperimentSpec.from_dict` /
``to_json`` / ``from_json``); every validation error is a
:class:`SpecError` naming the offending field by dotted path
(``"workload.generator"``, ``"scenario.events[2].kind"``).

**Seed derivation rule** — the single source of truth for every RNG stream
a run touches (this is where the historical ``run_scenario`` convention of
silently seeding the simulator at ``seed + 1`` is written down):

* ``spec.workload_seed()`` — the arrival/workload stream: ``workload.seed``
  when set (to share one trace across specs that differ elsewhere), else
  ``spec.seed``;
* ``spec.engine_seed()`` — the dispatch/simulation RNG (policy tie-breaks,
  ``random``/``jsq``/``jiq`` choices): ``spec.seed + ENGINE_SEED_OFFSET``.

``ENGINE_SEED_OFFSET = 1`` keeps every spec-driven run bit-identical to the
pre-API entry points on the same ``seed``.

**RNG-scheme rule** — *how* the engine seed turns into policy randomness is
the spec's ``rng_scheme`` field (one of :data:`RNG_SCHEMES`): ``"legacy"``
(default, a stateful ``random.Random(engine_seed)`` stream) or
``"counter"`` (a stateless per-job threefry derivation).  Only the sim
plane's dispatch draws from it; the live plane dispatches JFFC, which draws
nothing.

A copy of the JAX package's ``api/spec.py``: a spec serialises to the same
dict and JSON in both packages, so a spec written by either loads in the
other.  Two parts have no implementation in the port yet and are checked
only by name: ``cluster.engine`` (the sim plane's backend, validated
against :data:`SIM_ENGINES`; ROADMAP queue 1, item 9) and
``cluster.regions`` (multi-region fleets, item 15), which raises
:class:`SpecError` when set.
"""
from __future__ import annotations

import dataclasses
import json
import math
from typing import Dict, Mapping, Optional, Sequence, Tuple

from repro_torch.core.scenarios import (
    BURST_KINDS, REGION_KINDS, Scenario, ScenarioEvent,
)
from repro_torch.core.servers import Server, ServiceSpec
from repro_torch.core.workload import RequestClass, TraceStats

from . import workloads as _workloads  # noqa: F401  (registers builtins)
from .registry import (
    DISPATCH_POLICIES, SCALERS, TUNERS, UnknownNameError, WORKLOADS,
)

#: engine RNG = spec.seed + this (see the module docstring's seed rule)
ENGINE_SEED_OFFSET = 1

#: how the engine seed becomes policy randomness (module docstring rule);
#: the JAX package's ``core/engines/counter_rng.RNG_SCHEMES``
RNG_SCHEMES = ("legacy", "counter")

#: the simulation backends ``cluster.engine`` may name: the JAX package's
#: ``core.engines.ENGINES`` keys (only the sim plane reads the field)
SIM_ENGINES = ("batched", "vector")

SPEC_VERSION = 1


_NO_REGIONS = ("multi-region fleets are not ported yet (ROADMAP queue 1, "
               "item 15)")


class SpecError(ValueError):
    """A validation error that names the bad field by dotted path."""

    def __init__(self, field: str, message: str):
        self.field = field
        self.message = message
        super().__init__(f"{field}: {message}")


# ---------------------------------------------------------------------------
# dict <-> value converters (JSON-safe: inf/nan encode as strings)
# ---------------------------------------------------------------------------

def _enc_float(x: float):
    if x == math.inf:
        return "inf"
    if x == -math.inf:
        return "-inf"
    if isinstance(x, float) and math.isnan(x):
        return "nan"
    return float(x)


def _dec_float(x, field: str) -> float:
    if isinstance(x, str):
        try:
            return float(x)
        except ValueError:
            raise SpecError(field, f"not a number: {x!r}") from None
    if isinstance(x, bool) or not isinstance(x, (int, float)):
        raise SpecError(field, f"expected a number, got {type(x).__name__}")
    return float(x)


def _dec_int(x, field: str) -> int:
    if isinstance(x, bool) or not isinstance(x, int):
        raise SpecError(field, f"expected an integer, got {type(x).__name__}")
    return int(x)


def _dec_str(x, field: str) -> str:
    if not isinstance(x, str):
        raise SpecError(field, f"expected a string, got {type(x).__name__}")
    return x


def _need_mapping(data, field: str) -> Mapping:
    if not isinstance(data, Mapping):
        raise SpecError(field,
                        f"expected a mapping, got {type(data).__name__}")
    return data


def _take(data: Mapping, field: str, known: Sequence[str]) -> Dict:
    """Shallow-validate a sub-dict: reject unknown keys by name."""
    data = _need_mapping(data, field)
    for k in data:
        if k not in known:
            raise SpecError(f"{field}.{k}", "unknown field")
    return dict(data)


def _server_to_dict(s: Server) -> dict:
    return {"sid": s.sid, "memory_gb": s.memory_gb,
            "tau_c": s.tau_c, "tau_p": s.tau_p}


def _server_from_dict(d, field: str) -> Server:
    d = _take(d, field, ("sid", "memory_gb", "tau_c", "tau_p"))
    try:
        return Server(_dec_str(d.get("sid", ""), f"{field}.sid"),
                      _dec_float(d.get("memory_gb", 0.0),
                                 f"{field}.memory_gb"),
                      _dec_float(d.get("tau_c", 0.0), f"{field}.tau_c"),
                      _dec_float(d.get("tau_p", 0.0), f"{field}.tau_p"))
    except ValueError as e:
        if isinstance(e, SpecError):
            raise
        raise SpecError(field, str(e)) from None


def _service_to_dict(s: ServiceSpec) -> dict:
    return {"num_blocks": s.num_blocks, "block_size_gb": s.block_size_gb,
            "cache_size_gb": s.cache_size_gb}


def _service_from_dict(d, field: str) -> ServiceSpec:
    d = _take(d, field, ("num_blocks", "block_size_gb", "cache_size_gb"))
    try:
        return ServiceSpec(
            _dec_int(d.get("num_blocks", 1), f"{field}.num_blocks"),
            _dec_float(d.get("block_size_gb", 1.0), f"{field}.block_size_gb"),
            _dec_float(d.get("cache_size_gb", 1.0),
                       f"{field}.cache_size_gb"))
    except ValueError as e:
        if isinstance(e, SpecError):
            raise
        raise SpecError(field, str(e)) from None


def _class_to_dict(c: RequestClass) -> dict:
    return {"name": c.name, "tenant": c.tenant, "priority": c.priority,
            "slo_target": _enc_float(c.slo_target),
            "deadline": _enc_float(c.deadline)}


def _class_from_dict(d, field: str) -> RequestClass:
    d = _take(d, field, ("name", "tenant", "priority", "slo_target",
                         "deadline"))
    return RequestClass(
        name=_dec_str(d.get("name", "default"), f"{field}.name"),
        tenant=_dec_str(d.get("tenant", "default"), f"{field}.tenant"),
        priority=_dec_int(d.get("priority", 0), f"{field}.priority"),
        slo_target=_dec_float(d.get("slo_target", "inf"),
                              f"{field}.slo_target"),
        deadline=_dec_float(d.get("deadline", "inf"), f"{field}.deadline"))


def _stats_to_dict(s: TraceStats) -> dict:
    return {"mean_rate": s.mean_rate,
            "interarrival_std_ratio": s.interarrival_std_ratio,
            "mean_in_tokens": s.mean_in_tokens,
            "mean_out_tokens": s.mean_out_tokens}


def _stats_from_dict(d, field: str) -> TraceStats:
    d = _take(d, field, ("mean_rate", "interarrival_std_ratio",
                         "mean_in_tokens", "mean_out_tokens"))
    return TraceStats(
        mean_rate=_dec_float(d.get("mean_rate", 1.0), f"{field}.mean_rate"),
        interarrival_std_ratio=_dec_float(
            d.get("interarrival_std_ratio", 1.0),
            f"{field}.interarrival_std_ratio"),
        mean_in_tokens=_dec_float(d.get("mean_in_tokens", 1.0),
                                  f"{field}.mean_in_tokens"),
        mean_out_tokens=_dec_float(d.get("mean_out_tokens", 1.0),
                                   f"{field}.mean_out_tokens"))


def _event_to_dict(e: ScenarioEvent) -> dict:
    return {"time": e.time, "kind": e.kind, "sid": e.sid,
            "server": None if e.server is None else _server_to_dict(e.server),
            "scale": e.scale, "duration": e.duration,
            "sids": list(e.sids), "cls": e.cls}


def _event_from_dict(d, field: str) -> ScenarioEvent:
    d = _take(d, field, ("time", "kind", "sid", "server", "scale",
                         "duration", "sids", "cls"))
    server = d.get("server")
    sids = d.get("sids", ())
    if not isinstance(sids, (list, tuple)):
        raise SpecError(f"{field}.sids", "expected a list of server ids")
    try:
        return ScenarioEvent(
            time=_dec_float(d.get("time", 0.0), f"{field}.time"),
            kind=_dec_str(d.get("kind", ""), f"{field}.kind"),
            sid=_dec_str(d.get("sid", ""), f"{field}.sid"),
            server=None if server is None
            else _server_from_dict(server, f"{field}.server"),
            scale=_dec_float(d.get("scale", 1.0), f"{field}.scale"),
            duration=_dec_float(d.get("duration", 0.0), f"{field}.duration"),
            sids=tuple(_dec_str(s, f"{field}.sids") for s in sids),
            cls=_dec_int(d.get("cls", -1), f"{field}.cls"))
    except ValueError as e:
        if isinstance(e, SpecError):
            raise
        raise SpecError(f"{field}.kind", str(e)) from None


# ---------------------------------------------------------------------------
# Sub-specs
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ClusterSpec:
    """The serving hardware: either physical ``servers`` composed through
    the paper's tuned-c -> GBP-CR -> GCA pipeline, or pre-composed
    ``job_servers`` as ``(rate, capacity)`` pairs (micro-benchmarks and
    queueing studies that start from a known chain set).

    ``engine`` names the simulation backend the sim plane drives: the
    interpreter ``"vector"`` or the compiled ``"batched"``.  The live
    plane ignores it.

    ``regions`` (a fleet of serving regions in the JAX package) has no
    implementation in the port: anything but ``None`` raises."""

    servers: Tuple[Server, ...] = ()
    service: Optional[ServiceSpec] = None
    job_servers: Tuple[Tuple[float, int], ...] = ()
    rho_bar: float = 0.7
    tuner: str = "bound-lower"
    engine: str = "vector"
    regions: None = None

    def __post_init__(self):
        object.__setattr__(self, "servers", tuple(self.servers))
        object.__setattr__(
            self, "job_servers",
            tuple((float(m), int(c)) for (m, c) in self.job_servers))
        if self.servers and self.job_servers:
            raise SpecError("cluster",
                            "give servers (composed) OR job_servers "
                            "(pre-composed), not both")
        if not self.servers and not self.job_servers:
            raise SpecError("cluster", "needs servers or job_servers")
        for i, s in enumerate(self.servers):
            if not isinstance(s, Server):
                raise SpecError(f"cluster.servers[{i}]",
                                f"expected a Server, got {type(s).__name__}")
        if self.servers and self.service is None:
            raise SpecError("cluster.service",
                            "required when composing from servers")
        if not 0.0 < self.rho_bar <= 1.0:
            raise SpecError("cluster.rho_bar", "must be in (0, 1]")
        try:
            TUNERS.validate(self.tuner)
        except UnknownNameError as e:
            raise SpecError("cluster.tuner", str(e)) from None
        if self.engine not in SIM_ENGINES:
            raise SpecError("cluster.engine", str(UnknownNameError(
                "simulation engine", self.engine, SIM_ENGINES)))
        if self.regions is not None:
            raise SpecError("cluster.regions", _NO_REGIONS)

    def to_dict(self) -> dict:
        out = {
            "servers": [_server_to_dict(s) for s in self.servers],
            "service": None if self.service is None
            else _service_to_dict(self.service),
            "job_servers": [list(p) for p in self.job_servers],
            "rho_bar": self.rho_bar,
            "tuner": self.tuner,
            "engine": self.engine,
        }
        return out

    @classmethod
    def from_dict(cls, d) -> "ClusterSpec":
        d = _take(d, "cluster",
                  ("servers", "service", "job_servers", "rho_bar", "tuner",
                   "engine", "regions"))
        servers = d.get("servers", [])
        if not isinstance(servers, (list, tuple)):
            raise SpecError("cluster.servers", "expected a list")
        job_servers = d.get("job_servers", [])
        if not isinstance(job_servers, (list, tuple)):
            raise SpecError("cluster.job_servers", "expected a list")
        js = []
        for i, pair in enumerate(job_servers):
            if not isinstance(pair, (list, tuple)) or len(pair) != 2:
                raise SpecError(f"cluster.job_servers[{i}]",
                                "expected a (rate, capacity) pair")
            js.append((_dec_float(pair[0], f"cluster.job_servers[{i}]"),
                       _dec_int(pair[1], f"cluster.job_servers[{i}]")))
        service = d.get("service")
        if d.get("regions") is not None:
            raise SpecError("cluster.regions", _NO_REGIONS)
        return cls(
            servers=tuple(_server_from_dict(s, f"cluster.servers[{i}]")
                          for i, s in enumerate(servers)),
            service=None if service is None
            else _service_from_dict(service, "cluster.service"),
            job_servers=tuple(js),
            rho_bar=_dec_float(d.get("rho_bar", 0.7), "cluster.rho_bar"),
            tuner=_dec_str(d.get("tuner", "bound-lower"), "cluster.tuner"),
            engine=_dec_str(d.get("engine", "vector"), "cluster.engine"))


@dataclasses.dataclass(frozen=True)
class WorkloadSpec:
    """The offered load: a registry-named ``generator`` plus its ``params``,
    per-run base/class rates, request classes, and the service model.
    ``seed`` overrides the workload stream's seed (share one trace across
    specs); ``None`` derives it from ``ExperimentSpec.seed``."""

    generator: str = "scenario"
    base_rate: Optional[float] = None
    class_rates: Optional[Tuple[float, ...]] = None
    classes: Tuple[RequestClass, ...] = ()
    service_model: str = "work"
    seed: Optional[int] = None
    params: Mapping = dataclasses.field(default_factory=dict)
    trace_stats: Optional[TraceStats] = None

    def __post_init__(self):
        object.__setattr__(self, "classes", tuple(self.classes))
        if self.class_rates is not None:
            object.__setattr__(self, "class_rates",
                               tuple(float(r) for r in self.class_rates))
        object.__setattr__(self, "params", dict(self.params))
        try:
            WORKLOADS.validate(self.generator)
        except UnknownNameError as e:
            raise SpecError("workload.generator", str(e)) from None
        if self.service_model not in ("work", "tokens"):
            raise SpecError("workload.service_model",
                            "must be 'work' or 'tokens'")
        for i, c in enumerate(self.classes):
            if not isinstance(c, RequestClass):
                raise SpecError(
                    f"workload.classes[{i}]",
                    f"expected a RequestClass, got {type(c).__name__}")
        if (self.class_rates is not None and self.classes
                and len(self.class_rates) != len(self.classes)):
            raise SpecError("workload.class_rates",
                            f"length {len(self.class_rates)} != "
                            f"{len(self.classes)} classes")

    def resolved_base_rate(self) -> float:
        """``base_rate``, defaulting to ``sum(class_rates)``."""
        if self.base_rate is not None:
            return float(self.base_rate)
        if self.class_rates is not None:
            return float(sum(self.class_rates))
        raise SpecError("workload.base_rate",
                        "need base_rate or class_rates")

    def to_dict(self) -> dict:
        return {
            "generator": self.generator,
            "base_rate": self.base_rate,
            "class_rates": None if self.class_rates is None
            else list(self.class_rates),
            "classes": [_class_to_dict(c) for c in self.classes],
            "service_model": self.service_model,
            "seed": self.seed,
            "params": dict(self.params),
            "trace_stats": None if self.trace_stats is None
            else _stats_to_dict(self.trace_stats),
        }

    @classmethod
    def from_dict(cls, d) -> "WorkloadSpec":
        d = _take(d, "workload",
                  ("generator", "base_rate", "class_rates", "classes",
                   "service_model", "seed", "params", "trace_stats"))
        classes = d.get("classes", [])
        if not isinstance(classes, (list, tuple)):
            raise SpecError("workload.classes", "expected a list")
        class_rates = d.get("class_rates")
        if class_rates is not None:
            if not isinstance(class_rates, (list, tuple)):
                raise SpecError("workload.class_rates", "expected a list")
            class_rates = tuple(
                _dec_float(r, f"workload.class_rates[{i}]")
                for i, r in enumerate(class_rates))
        base_rate = d.get("base_rate")
        seed = d.get("seed")
        stats = d.get("trace_stats")
        return cls(
            generator=_dec_str(d.get("generator", "scenario"),
                               "workload.generator"),
            base_rate=None if base_rate is None
            else _dec_float(base_rate, "workload.base_rate"),
            class_rates=class_rates,
            classes=tuple(_class_from_dict(c, f"workload.classes[{i}]")
                          for i, c in enumerate(classes)),
            service_model=_dec_str(d.get("service_model", "work"),
                                   "workload.service_model"),
            seed=None if seed is None else _dec_int(seed, "workload.seed"),
            params=_need_mapping(d.get("params", {}), "workload.params"),
            trace_stats=None if stats is None
            else _stats_from_dict(stats, "workload.trace_stats"))


@dataclasses.dataclass(frozen=True)
class PolicySpec:
    """Online dispatch: a registry-named policy plus the priority engine's
    anti-starvation aging rate (ignored by class-blind policies)."""

    name: str = "jffc"
    aging_rate: float = 0.0

    def __post_init__(self):
        try:
            DISPATCH_POLICIES.validate(self.name)
        except UnknownNameError as e:
            raise SpecError("policy.name", str(e)) from None
        if self.aging_rate < 0:
            raise SpecError("policy.aging_rate", "must be >= 0")

    def to_dict(self) -> dict:
        return {"name": self.name, "aging_rate": self.aging_rate}

    @classmethod
    def from_dict(cls, d) -> "PolicySpec":
        d = _take(d, "policy", ("name", "aging_rate"))
        return cls(name=_dec_str(d.get("name", "jffc"), "policy.name"),
                   aging_rate=_dec_float(d.get("aging_rate", 0.0),
                                         "policy.aging_rate"))


@dataclasses.dataclass(frozen=True)
class AdmissionSpec:
    """The admission gate's initial throttle: sheddable-class deadlines are
    scaled by ``level`` (1.0 = nominal, 0.0 = defer/shed all best-effort
    work that would queue).  Autoscale policies may retune it live."""

    level: float = 1.0

    def __post_init__(self):
        if self.level < 0:
            raise SpecError("admission.level", "must be >= 0")

    def to_dict(self) -> dict:
        return {"level": self.level}

    @classmethod
    def from_dict(cls, d) -> "AdmissionSpec":
        d = _take(d, "admission", ("level",))
        return cls(level=_dec_float(d.get("level", 1.0), "admission.level"))


@dataclasses.dataclass(frozen=True)
class AutoscaleSpec:
    """Closed-loop scaling: a registry-named scaler (built with ``template``
    and ``params``) actuated by an ``AutoscaleController`` configured from
    the remaining fields (one-to-one with ``ControllerConfig``)."""

    policy: str
    template: Optional[Server] = None
    params: Mapping = dataclasses.field(default_factory=dict)
    interval: float = 5.0
    cooldown: float = 15.0
    warmup_lag: float = 10.0
    min_servers: int = 1
    max_servers: int = 64
    slo_response_time: Optional[float] = None
    retune_threshold: float = 0.25
    telemetry_window: float = 20.0

    def __post_init__(self):
        object.__setattr__(self, "params", dict(self.params))
        try:
            SCALERS.validate(self.policy)
        except UnknownNameError as e:
            raise SpecError("autoscale.policy", str(e)) from None
        if self.template is None:
            raise SpecError("autoscale.template",
                            "required (the controller mints scale-out "
                            "servers from it)")
        if self.interval <= 0:
            raise SpecError("autoscale.interval", "must be > 0")
        if self.telemetry_window <= 0:
            raise SpecError("autoscale.telemetry_window", "must be > 0")

    def to_dict(self) -> dict:
        return {
            "policy": self.policy,
            "template": None if self.template is None
            else _server_to_dict(self.template),
            "params": dict(self.params),
            "interval": self.interval,
            "cooldown": self.cooldown,
            "warmup_lag": self.warmup_lag,
            "min_servers": self.min_servers,
            "max_servers": self.max_servers,
            "slo_response_time": self.slo_response_time,
            "retune_threshold": self.retune_threshold,
            "telemetry_window": self.telemetry_window,
        }

    @classmethod
    def from_dict(cls, d) -> "AutoscaleSpec":
        d = _take(d, "autoscale",
                  ("policy", "template", "params", "interval", "cooldown",
                   "warmup_lag", "min_servers", "max_servers",
                   "slo_response_time", "retune_threshold",
                   "telemetry_window"))
        template = d.get("template")
        slo = d.get("slo_response_time")
        return cls(
            policy=_dec_str(d.get("policy", ""), "autoscale.policy"),
            template=None if template is None
            else _server_from_dict(template, "autoscale.template"),
            params=_need_mapping(d.get("params", {}), "autoscale.params"),
            interval=_dec_float(d.get("interval", 5.0), "autoscale.interval"),
            cooldown=_dec_float(d.get("cooldown", 15.0),
                                "autoscale.cooldown"),
            warmup_lag=_dec_float(d.get("warmup_lag", 10.0),
                                  "autoscale.warmup_lag"),
            min_servers=_dec_int(d.get("min_servers", 1),
                                 "autoscale.min_servers"),
            max_servers=_dec_int(d.get("max_servers", 64),
                                 "autoscale.max_servers"),
            slo_response_time=None if slo is None
            else _dec_float(slo, "autoscale.slo_response_time"),
            retune_threshold=_dec_float(d.get("retune_threshold", 0.25),
                                        "autoscale.retune_threshold"),
            telemetry_window=_dec_float(d.get("telemetry_window", 20.0),
                                        "autoscale.telemetry_window"))

    def build_controller(self):
        """Construct the (stateful) controller this spec describes — one
        fresh controller per run."""
        from repro_torch.autoscale import (
            AutoscaleController, ControllerConfig, Telemetry, TelemetryConfig,
        )

        policy = SCALERS.get(self.policy)(self.template, dict(self.params))
        return AutoscaleController(
            policy, self.template,
            ControllerConfig(interval=self.interval, cooldown=self.cooldown,
                             warmup_lag=self.warmup_lag,
                             min_servers=self.min_servers,
                             max_servers=self.max_servers,
                             slo_response_time=self.slo_response_time,
                             retune_threshold=self.retune_threshold),
            telemetry=Telemetry(TelemetryConfig(
                window=self.telemetry_window)))


@dataclasses.dataclass(frozen=True)
class ScenarioSpec:
    """The scripted timeline: a serializable twin of
    :class:`repro_torch.core.scenarios.Scenario` (events validate their kind
    against the extensible event-kind registry)."""

    horizon: float
    events: Tuple[ScenarioEvent, ...] = ()
    description: str = ""

    def __post_init__(self):
        object.__setattr__(self, "events", tuple(self.events))
        if self.horizon <= 0:
            raise SpecError("scenario.horizon", "must be > 0")
        for i, e in enumerate(self.events):
            if not isinstance(e, ScenarioEvent):
                raise SpecError(
                    f"scenario.events[{i}]",
                    f"expected a ScenarioEvent, got {type(e).__name__}")

    def to_scenario(self) -> Scenario:
        return Scenario(horizon=self.horizon, events=list(self.events),
                        description=self.description)

    @classmethod
    def from_scenario(cls, sc: Scenario) -> "ScenarioSpec":
        return cls(horizon=sc.horizon, events=tuple(sc.events),
                   description=sc.description)

    def to_dict(self) -> dict:
        return {"horizon": self.horizon,
                "description": self.description,
                "events": [_event_to_dict(e) for e in self.events]}

    @classmethod
    def from_dict(cls, d) -> "ScenarioSpec":
        d = _take(d, "scenario", ("horizon", "description", "events"))
        events = d.get("events", [])
        if not isinstance(events, (list, tuple)):
            raise SpecError("scenario.events", "expected a list")
        return cls(
            horizon=_dec_float(d.get("horizon", 0.0), "scenario.horizon"),
            description=_dec_str(d.get("description", ""),
                                 "scenario.description"),
            events=tuple(_event_from_dict(e, f"scenario.events[{i}]")
                         for i, e in enumerate(events)))


# ---------------------------------------------------------------------------
# The composed experiment
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ExperimentSpec:
    """One declarative experiment, runnable on any execution plane."""

    cluster: ClusterSpec
    scenario: ScenarioSpec
    workload: WorkloadSpec = dataclasses.field(default_factory=WorkloadSpec)
    policy: PolicySpec = dataclasses.field(default_factory=PolicySpec)
    admission: AdmissionSpec = dataclasses.field(
        default_factory=AdmissionSpec)
    autoscale: Optional[AutoscaleSpec] = None
    seed: int = 0
    warmup_fraction: float = 0.0
    rng_scheme: str = "legacy"
    name: str = ""

    def __post_init__(self):
        for field_name, typ in (("cluster", ClusterSpec),
                                ("scenario", ScenarioSpec),
                                ("workload", WorkloadSpec),
                                ("policy", PolicySpec),
                                ("admission", AdmissionSpec)):
            if not isinstance(getattr(self, field_name), typ):
                raise SpecError(field_name, f"expected a {typ.__name__}")
        if self.autoscale is not None \
                and not isinstance(self.autoscale, AutoscaleSpec):
            raise SpecError("autoscale", "expected an AutoscaleSpec or None")
        if not 0.0 <= self.warmup_fraction < 1.0:
            raise SpecError("warmup_fraction", "must be in [0, 1)")
        if self.rng_scheme not in RNG_SCHEMES:
            raise SpecError("rng_scheme",
                            f"unknown scheme {self.rng_scheme!r} "
                            f"(known: {', '.join(RNG_SCHEMES)})")
        # rate must be resolvable up front, not at run time
        self.workload.resolved_base_rate()
        if self.cluster.job_servers:
            cluster_events = [e for e in self.scenario.events
                              if e.kind not in BURST_KINDS
                              and e.kind not in REGION_KINDS]
            if cluster_events:
                raise SpecError(
                    "scenario.events",
                    "cluster events need a composable cluster "
                    "(cluster.servers), not pre-composed job_servers")
            if self.autoscale is not None:
                raise SpecError(
                    "autoscale",
                    "autoscaling needs a composable cluster "
                    "(cluster.servers), not pre-composed job_servers")
        region_events = [(i, e) for i, e in enumerate(self.scenario.events)
                         if e.kind in REGION_KINDS]
        if region_events:
            i, e = region_events[0]
            raise SpecError(
                f"scenario.events[{i}]",
                f"{e.kind} events need cluster.regions: {_NO_REGIONS}")

    # -- seed derivation (the one place the rule lives) ---------------------
    def workload_seed(self) -> int:
        """Seed of the arrival/workload stream."""
        return self.seed if self.workload.seed is None else self.workload.seed

    def engine_seed(self) -> int:
        """Seed of the dispatch/simulation RNG (= ``seed + 1``)."""
        return self.seed + ENGINE_SEED_OFFSET

    # -- dict / JSON round-trip ---------------------------------------------
    def to_dict(self) -> dict:
        return {
            "version": SPEC_VERSION,
            "name": self.name,
            "seed": self.seed,
            "warmup_fraction": self.warmup_fraction,
            "rng_scheme": self.rng_scheme,
            "cluster": self.cluster.to_dict(),
            "scenario": self.scenario.to_dict(),
            "workload": self.workload.to_dict(),
            "policy": self.policy.to_dict(),
            "admission": self.admission.to_dict(),
            "autoscale": None if self.autoscale is None
            else self.autoscale.to_dict(),
        }

    @classmethod
    def from_dict(cls, d) -> "ExperimentSpec":
        d = _take(d, "spec",
                  ("version", "name", "seed", "warmup_fraction",
                   "rng_scheme", "cluster", "scenario", "workload", "policy",
                   "admission", "autoscale"))
        version = d.get("version", SPEC_VERSION)
        if version != SPEC_VERSION:
            raise SpecError("spec.version",
                            f"unsupported version {version!r} "
                            f"(this build reads {SPEC_VERSION})")
        if "cluster" not in d:
            raise SpecError("cluster", "missing")
        if "scenario" not in d:
            raise SpecError("scenario", "missing")
        autoscale = d.get("autoscale")
        return cls(
            cluster=ClusterSpec.from_dict(d["cluster"]),
            scenario=ScenarioSpec.from_dict(d["scenario"]),
            workload=WorkloadSpec.from_dict(d.get("workload", {})),
            policy=PolicySpec.from_dict(d.get("policy", {})),
            admission=AdmissionSpec.from_dict(d.get("admission", {})),
            autoscale=None if autoscale is None
            else AutoscaleSpec.from_dict(autoscale),
            seed=_dec_int(d.get("seed", 0), "spec.seed"),
            warmup_fraction=_dec_float(d.get("warmup_fraction", 0.0),
                                       "spec.warmup_fraction"),
            rng_scheme=_dec_str(d.get("rng_scheme", "legacy"),
                                "spec.rng_scheme"),
            name=_dec_str(d.get("name", ""), "spec.name"))

    def to_json(self, **kwargs) -> str:
        kwargs.setdefault("sort_keys", True)
        return json.dumps(self.to_dict(), **kwargs)

    @classmethod
    def from_json(cls, s: str) -> "ExperimentSpec":
        return cls.from_dict(json.loads(s))

    def replace(self, **changes) -> "ExperimentSpec":
        """`dataclasses.replace` that re-validates."""
        return dataclasses.replace(self, **changes)

"""String-keyed registries behind the declarative experiment API.

Every extensible concept an :class:`repro_torch.api.ExperimentSpec` names by
string — dispatch policies, c-tuners, workload generators, autoscale
policies, execution planes — resolves through one of the registries below.
Extensions register with a decorator and need zero core edits:

    from repro_torch.api import SCALERS

    @SCALERS.register("my-scaler")
    def _build(template, params):
        return MyScaler(**params)

Where a concept already has a canonical home in the core layers
(``repro_torch.core.load_balance.POLICIES``,
``repro_torch.core.tuning.TUNERS``), the registry *writes through* to it on
registration, so the core layer and the spec layer can never disagree
about the known names.

A copy of the JAX package's ``api/registry.py`` without the registries of
what the port has no implementation of yet: the simulation backends
(``ENGINES``, ROADMAP queue 1, item 9) and the geo routers
(``GEO_ROUTERS``, item 15).  Scenario event kinds validate against
``repro_torch.core.scenarios.EVENT_KINDS`` directly.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

_MISSING = object()


class UnknownNameError(ValueError):
    """Lookup of a name no one registered; carries the known names so spec
    validation can produce an error that lists them."""

    def __init__(self, kind: str, name: str, known: Tuple[str, ...]):
        self.kind = kind
        self.name = name
        self.known = known
        super().__init__(
            f"unknown {kind} {name!r} (known: {', '.join(known) or 'none'})")


class Registry:
    """A named map from string keys to factories/values with decorator
    registration."""

    def __init__(self, kind: str,
                 on_register: Optional[Callable[[str, object], None]] = None):
        self.kind = kind
        self._entries: Dict[str, object] = {}
        self._on_register = on_register

    def register(self, name: str, obj=_MISSING):
        """``register(name, value)`` directly, or ``@register(name)`` as a
        decorator.  Re-registering a name overwrites it (latest wins), so a
        test or plugin can stub a builtin."""
        if obj is not _MISSING:
            self._entries[name] = obj
            if self._on_register is not None:
                self._on_register(name, obj)
            return obj

        def decorate(fn):
            self.register(name, fn)
            return fn

        return decorate

    def get(self, name: str):
        try:
            return self._entries[name]
        except KeyError:
            raise UnknownNameError(self.kind, name, self.names()) from None

    def validate(self, name: str) -> str:
        """Raise :class:`UnknownNameError` unless ``name`` is registered."""
        if name not in self._entries:
            raise UnknownNameError(self.kind, name, self.names())
        return name

    def names(self) -> Tuple[str, ...]:
        return tuple(sorted(self._entries))

    def __contains__(self, name: str) -> bool:
        return name in self._entries

    def __iter__(self):
        return iter(sorted(self._entries))

    def __len__(self) -> int:
        return len(self._entries)


# ---------------------------------------------------------------------------
# Dispatch policies — write-through to repro_torch.core.load_balance.POLICIES.
# ---------------------------------------------------------------------------

from repro_torch.core.load_balance import POLICIES as _CORE_POLICIES  # noqa: E402

DISPATCH_POLICIES = Registry(
    "dispatch policy",
    on_register=lambda name, obj: _CORE_POLICIES.__setitem__(name, obj))

for _name, _cls in _CORE_POLICIES.items():
    DISPATCH_POLICIES.register(_name, _cls)


# ---------------------------------------------------------------------------
# c-tuners — write-through to repro_torch.core.tuning.TUNERS (consulted by
# ``compose``), so a registered tuner runs inside the composition pipeline.
# ---------------------------------------------------------------------------

from repro_torch.core.tuning import TUNERS as _CORE_TUNERS  # noqa: E402

TUNERS = Registry(
    "tuner",
    on_register=lambda name, obj: _CORE_TUNERS.__setitem__(name, obj))

for _name, _fn in _CORE_TUNERS.items():
    TUNERS.register(_name, _fn)


# ---------------------------------------------------------------------------
# Autoscale policies ("scalers") — factories (template, params) -> policy.
# ---------------------------------------------------------------------------

SCALERS = Registry("autoscale policy")


@SCALERS.register("target-util")
def _target_util(template, params):
    from repro_torch.autoscale import TargetUtilizationPolicy

    return TargetUtilizationPolicy(**params)


@SCALERS.register("queue-gradient")
def _queue_gradient(template, params):
    from repro_torch.autoscale import QueueGradientPolicy

    return QueueGradientPolicy(**params)


@SCALERS.register("predictive")
def _predictive(template, params):
    from repro_torch.autoscale import PredictivePolicy

    return PredictivePolicy(template, **params)


@SCALERS.register("slo-admission")
def _slo_admission(template, params):
    """Wrapper scaler: ``params['inner']`` names the wrapped policy as
    ``{"policy": <scaler name>, "params": {...}}``; the rest goes to
    :class:`repro_torch.autoscale.SLOAwareAdmissionPolicy`."""
    from repro_torch.autoscale import SLOAwareAdmissionPolicy

    params = dict(params)
    inner_cfg = params.pop("inner", {"policy": "predictive", "params": {}})
    inner = SCALERS.get(inner_cfg.get("policy", "predictive"))(
        template, dict(inner_cfg.get("params", {})))
    return SLOAwareAdmissionPolicy(inner, **params)


# ---------------------------------------------------------------------------
# Workload generators (builtins registered by repro_torch.api.workloads) and
# execution planes (registered by repro_torch.api.planes).
# ---------------------------------------------------------------------------

WORKLOADS = Registry("workload generator")
PLANES = Registry("execution plane")

"""Builtin workload generators for the declarative experiment API.

Every generator is a registry entry with the signature

    fn(workload: WorkloadSpec, scenario: Scenario, seed: int)
        -> arrivals tuple | None

where the returned tuple is whatever the execution planes'
arrival-resolution accepts — ``(times, works)``,
``(times, works, class_ids)``, or the token-trace 4/5-tuples — and ``None``
means "derive the arrivals from the scenario's own burst phases" (the
historical default path, kept as its own generator so spec-driven runs stay
bit-identical to the pre-API entry points).

Register your own with zero core edits:

    from repro_torch.api import WORKLOADS

    @WORKLOADS.register("my-trace")
    def my_trace(workload, scenario, seed):
        return times, works

A copy of the JAX package's ``api/workloads.py`` without the multi-region
``geo-follow-the-sun`` generator, which comes with the geo layer (ROADMAP
queue 1, item 15).
"""
from __future__ import annotations

from repro_torch.core.workload import (
    AZURE_STATS,
    azure_like_trace_np,
    classed_azure_trace_np,
    classed_poisson_mix,
    diurnal_poisson,
    poisson_exponential_np,
)

from .registry import WORKLOADS


def _params(workload, allowed, required=()):
    """Validate ``workload.params`` against the generator's signature,
    naming any unknown/missing key."""
    from .spec import SpecError

    params = dict(workload.params)
    for k in params:
        if k not in allowed:
            raise SpecError(f"workload.params.{k}",
                            f"unknown parameter for generator "
                            f"{workload.generator!r} "
                            f"(accepted: {', '.join(sorted(allowed))})")
    for k in required:
        if k not in params:
            raise SpecError(f"workload.params.{k}",
                            f"required by generator {workload.generator!r}")
    return params


def _rate(workload):
    from .spec import SpecError

    if workload.base_rate is None:
        raise SpecError("workload.base_rate",
                        f"required by generator {workload.generator!r}")
    return float(workload.base_rate)


@WORKLOADS.register("scenario")
def scenario_workload(workload, scenario, seed):
    """The default: piecewise-constant Poisson arrivals shaped by the
    scenario's burst phases — per-class streams when ``class_rates`` is
    set.  Returns ``None``: the plane generates straight from the scenario,
    exactly as the pre-API ``run_scenario`` did."""
    _params(workload, ())
    return None


@WORKLOADS.register("poisson")
def poisson_workload(workload, scenario, seed):
    """Stationary Poisson(``base_rate``) arrivals with Exp(1) works;
    ``params: n`` (job count)."""
    p = _params(workload, ("n",), required=("n",))
    return poisson_exponential_np(_rate(workload), int(p["n"]), seed=seed)


@WORKLOADS.register("diurnal")
def diurnal_workload(workload, scenario, seed):
    """Sinusoidal day/night curve over the scenario horizon;
    ``params: amplitude, n_segments, period``."""
    p = _params(workload, ("amplitude", "n_segments", "period"))
    return diurnal_poisson(
        _rate(workload), scenario.horizon,
        period=p.get("period"),
        amplitude=float(p.get("amplitude", 0.6)),
        n_segments=int(p.get("n_segments", 48)), seed=seed)


@WORKLOADS.register("classed-mix")
def classed_mix_workload(workload, scenario, seed):
    """Superposed per-class Poisson streams (``class_rates``) over the
    scenario horizon, class-labeled."""
    from .spec import SpecError

    _params(workload, ())
    if workload.class_rates is None:
        raise SpecError("workload.class_rates",
                        "required by generator 'classed-mix'")
    return classed_poisson_mix(list(workload.class_rates), scenario.horizon,
                               seed=seed)


@WORKLOADS.register("azure-trace")
def azure_trace_workload(workload, scenario, seed):
    """Bursty azure-like MMPP trace with token counts;
    ``params: n, rate_scale`` — pair with ``service_model='tokens'`` for
    token-derived service demand."""
    p = _params(workload, ("n", "rate_scale"), required=("n",))
    return azure_like_trace_np(
        int(p["n"]), stats=workload.trace_stats or AZURE_STATS, seed=seed,
        rate_scale=float(p.get("rate_scale", 1.0)))


@WORKLOADS.register("classed-azure-trace")
def classed_azure_trace_workload(workload, scenario, seed):
    """Class-labeled azure-like trace; ``params: n, weights, rate_scale``."""
    p = _params(workload, ("n", "weights", "rate_scale"),
                required=("n", "weights"))
    return classed_azure_trace_np(
        int(p["n"]), list(p["weights"]),
        stats=workload.trace_stats or AZURE_STATS, seed=seed,
        rate_scale=float(p.get("rate_scale", 1.0)))

"""Tuning of the cache-reservation parameter c (Eq. 14 and Section 3.2.3).

Two tuners are provided:
  * ``tune_surrogate``  — c* = argmin_c c * K(c)            (Eq. 14)
  * ``tune_bound``      — c* minimizing a Thm 3.7 bound on the mean response
    time of the chains composed by GBP-CR + GCA (the paper's recommended
    method; Fig. 6/7 show the LOWER bound gives the best c*).
"""
from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Sequence, Tuple

from . import queueing
from .cache_alloc import Allocation, gca
from .placement import Placement, chains_needed_from_servers, gbp_cr
from .servers import Server, ServiceSpec, c_max as _c_max


@dataclasses.dataclass
class TuningResult:
    c_star: int
    objective: float
    per_c: List[Tuple[int, float]]       # (c, objective) for every feasible c
    placement: Optional[Placement] = None
    allocation: Optional[Allocation] = None


def tune_surrogate(
    servers: Sequence[Server],
    spec: ServiceSpec,
    lam: float,
    rho_bar: float,
    c_range: Optional[Sequence[int]] = None,
) -> TuningResult:
    """Brute-force Eq. (14): minimize c * K(c) over c in [c_max]."""
    cmax = _c_max(servers, spec)
    cs = c_range if c_range is not None else range(1, cmax + 1)
    best_c, best_obj, best_pl = None, math.inf, None
    per_c = []
    for c in cs:
        pl = gbp_cr(servers, spec, c, lam, rho_bar)
        if not pl.feasible:
            continue
        k = chains_needed_from_servers(servers, spec, pl, lam, rho_bar)
        if k is None:
            continue
        obj = c * k
        per_c.append((c, float(obj)))
        if obj < best_obj:
            best_c, best_obj, best_pl = c, obj, pl
    if best_c is None:
        raise ValueError("no feasible c: demand exceeds achievable service rate")
    return TuningResult(best_c, best_obj, per_c, placement=best_pl)


def tune_bound(
    servers: Sequence[Server],
    spec: ServiceSpec,
    lam: float,
    rho_bar: float,
    which: str = "lower",
    c_range: Optional[Sequence[int]] = None,
    use_all_servers: bool = True,
) -> TuningResult:
    """Section 3.2.3: pick c minimizing the Thm 3.7 ``which`` in
    {'lower','upper'} bound on mean response time for GBP-CR + GCA chains."""
    if which not in ("lower", "upper"):
        raise ValueError("which must be 'lower' or 'upper'")
    cmax = _c_max(servers, spec)
    cs = c_range if c_range is not None else range(1, cmax + 1)
    best = (None, math.inf, None, None)
    per_c = []
    for c in cs:
        pl = gbp_cr(servers, spec, c, lam, rho_bar, use_all_servers=use_all_servers)
        if not pl.feasible:
            continue
        alloc = gca(servers, pl)
        js = alloc.job_servers()
        if not js or not queueing.is_stable(js, lam):
            continue
        lo, hi = queueing.response_time_bounds(js, lam)
        obj = lo if which == "lower" else hi
        per_c.append((c, float(obj)))
        if obj < best[1]:
            best = (c, obj, pl, alloc)
    if best[0] is None:
        raise ValueError("no feasible c: demand exceeds achievable service rate")
    return TuningResult(best[0], best[1], per_c, placement=best[2], allocation=best[3])


def _compose_surrogate(servers, spec, lam, rho_bar):
    res = tune_surrogate(servers, spec, lam, rho_bar)
    pl = gbp_cr(servers, spec, res.c_star, lam, rho_bar, use_all_servers=True)
    return res.c_star, pl, gca(servers, pl)


def _compose_bound(which: str):
    def tuner_fn(servers, spec, lam, rho_bar):
        res = tune_bound(servers, spec, lam, rho_bar, which=which)
        assert res.placement is not None and res.allocation is not None
        return res.c_star, res.placement, res.allocation

    tuner_fn.__name__ = f"bound_{which}"
    return tuner_fn


#: tuner registry consulted by :func:`compose`: name ->
#: ``fn(servers, spec, lam, rho_bar) -> (c_star, Placement, Allocation)``.
TUNERS = {
    "surrogate": _compose_surrogate,
    "bound-lower": _compose_bound("lower"),
    "bound-upper": _compose_bound("upper"),
}


def compose(
    servers: Sequence[Server],
    spec: ServiceSpec,
    lam: float,
    rho_bar: float = 0.7,
    tuner: str = "bound-lower",
) -> Tuple[int, Placement, Allocation]:
    """One-call server-chain composition: tune c, place, allocate.

    This is the paper's full offline pipeline (GBP-CR + GCA with tuned c) and
    the entry point used by the serving orchestrator.  ``tuner`` names an
    entry of :data:`TUNERS`; unregistered names keep their historical
    meaning as a Theorem 3.7 bound selector (``"<anything>-upper"`` etc.).
    """
    fn = TUNERS.get(tuner)
    if fn is not None:
        return fn(servers, spec, lam, rho_bar)
    which = tuner.split("-")[1] if "-" in tuner else "lower"
    res = tune_bound(servers, spec, lam, rho_bar, which=which)
    assert res.placement is not None and res.allocation is not None
    return res.c_star, res.placement, res.allocation


def compose_best_effort(
    servers: Sequence[Server],
    spec: ServiceSpec,
    lam: float,
    rho_bar: float = 0.7,
    tuner: str = "bound-lower",
) -> Tuple[int, Allocation, bool]:
    """``compose`` that degrades instead of raising on infeasible demand.

    When ``lam`` exceeds what the cluster can compose for, bisect the
    largest feasible fraction of it and serve at actual capacity — an
    overloaded system keeps serving instead of collapsing to a
    throughput-pessimal chain set.  The last resort (not even a vanishing
    load composes, e.g. no complete chain exists) is ``c = 1`` over every
    server.  Returns ``(c_star, allocation, degraded)``.  Both execution
    planes — the scenario engine and the live orchestrator — degrade
    through this one helper so overload behaviour stays identical.
    """
    try:
        c, _, alloc = compose(servers, spec, lam, rho_bar, tuner=tuner)
        return c, alloc, False
    except ValueError:
        pass
    best: Optional[Tuple[int, Allocation]] = None
    lo, hi = 0.0, 1.0                  # feasible / infeasible lam fractions
    for _ in range(12):
        mid = 0.5 * (lo + hi)
        try:
            c, _, cand = compose(servers, spec, mid * lam, rho_bar,
                                 tuner=tuner)
            best, lo = (c, cand), mid
        except ValueError:
            hi = mid
    if best is not None:
        return best[0], best[1], True
    pl = gbp_cr(servers, spec, 1, lam, rho_bar, use_all_servers=True)
    return 1, gca(servers, pl), True

"""The unified run report every execution plane returns.

:class:`RunReport` is the one schema every plane fills in — per-class
quantiles, the event log, the autoscaler's cost report, and plane-specific
extras — so two runs of a spec can be *diffed* (:meth:`RunReport.diff`),
across planes and across packages.  The plane-native object rides along as
``raw`` for callers that need it.

A copy of the JAX package's ``api/report.py`` with the live plane's
builder (:func:`report_from_orchestrator`); the sim plane's
``report_from_scenario_result`` comes with that plane (ROADMAP queue 1,
item 9).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.simulator import _quantile_stats

#: report fields diff() compares by default
_DIFF_KEYS = ("plane", "n_jobs", "n_completed", "n_rejected", "n_failed",
              "completed_all", "reconfigurations", "restarts")


def _close(a, b, rel: float = 1e-9) -> bool:
    if isinstance(a, float) and isinstance(b, float):
        if math.isnan(a) and math.isnan(b):
            return True
        return math.isclose(a, b, rel_tol=rel, abs_tol=1e-12)
    return a == b


def _jsonable(x):
    if isinstance(x, dict):
        return {str(k): _jsonable(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_jsonable(v) for v in x]
    if isinstance(x, np.ndarray):
        return x.tolist()
    if isinstance(x, (np.integer,)):
        return int(x)
    if isinstance(x, (np.floating,)):
        return float(x)
    if isinstance(x, (str, int, float, bool)) or x is None:
        return x
    return repr(x)


@dataclasses.dataclass
class RunReport:
    """What one :class:`repro_torch.api.ExperimentSpec` run produced, on any plane.

    ``n_rejected`` counts requests the admission gate kept out of service at
    the end of the run: shed arrivals on the sim plane, still-deferred
    requests on the live plane.  ``restarts`` counts re-dispatches
    (re-prefills) caused by failures/recompositions on the sim plane and
    request retries on the live plane.
    """

    plane: str
    name: str
    n_jobs: int
    n_completed: int
    n_rejected: int
    n_failed: int
    completed_all: bool
    sim_time: float
    response: Dict[str, float]
    waiting: Dict[str, float]
    per_class: Dict[int, dict]
    events: List[dict]
    reconfigurations: int
    restarts: int
    cost: Optional[dict] = None
    extras: Dict[str, Any] = dataclasses.field(default_factory=dict)
    #: decoded run timeline of a ``trace=True`` run (the flight recorder,
    #: ROADMAP queue 1, item 13; always ``None`` in the port) — like ``raw``
    #: it is a live object and never round-trips through :meth:`to_dict`
    trace: Any = None
    raw: Any = None

    def p99(self) -> float:
        return float(self.response.get("p99", math.nan))

    def mean_response(self) -> float:
        return float(self.response.get("mean", math.nan))

    def to_dict(self) -> dict:
        """JSON-safe dict (drops ``raw`` and ``trace``; coerces extras).

        Built field by field, never through ``dataclasses.asdict``: that
        deep-copies every value, and ``extras`` holds the live orchestrator,
        whose engines hold the model's weights and KV caches on the device
        (the JAX package's ``asdict`` raises on its JAX engines' devices).
        Live handles become their ``repr`` either way."""
        return _jsonable({f.name: getattr(self, f.name)
                          for f in dataclasses.fields(self)
                          if f.name not in ("raw", "trace")})

    @classmethod
    def from_dict(cls, d: dict) -> "RunReport":
        """Rebuild a report from :meth:`to_dict` output (how the JAX
        package's results store reads one).  ``raw`` is gone — it never
        serializes — and extras hold whatever JSON survived (live handles
        like the controller/orchestrator objects were reduced to reprs)."""
        d = dict(d)
        d.pop("raw", None)
        d.pop("trace", None)
        d["per_class"] = {int(k): v
                          for k, v in (d.get("per_class") or {}).items()}
        known = {f.name for f in dataclasses.fields(cls) if f.name != "raw"}
        unknown = set(d) - known
        if unknown:
            raise ValueError(f"unknown RunReport fields: {sorted(unknown)}")
        return cls(raw=None, **d)

    def diff(self, other: "RunReport",
             rel: float = 1e-9) -> Dict[str, Tuple[Any, Any]]:
        """Fields where two reports disagree: ``{field: (self, other)}``.

        Scalar counters compare exactly; response/waiting quantiles and the
        cost report compare to ``rel`` relative tolerance.  An empty dict
        means the runs agree on everything the unified schema captures.
        """
        out: Dict[str, Tuple[Any, Any]] = {}
        for k in _DIFF_KEYS:
            a, b = getattr(self, k), getattr(other, k)
            if a != b:
                out[k] = (a, b)
        for group in ("response", "waiting"):
            a_g, b_g = getattr(self, group), getattr(other, group)
            for k in sorted(set(a_g) | set(b_g)):
                a, b = a_g.get(k, math.nan), b_g.get(k, math.nan)
                if not _close(float(a), float(b), rel):
                    out[f"{group}.{k}"] = (a, b)
        a_cost = self.cost or {}
        b_cost = other.cost or {}
        for k in sorted(set(a_cost) | set(b_cost)):
            a, b = a_cost.get(k), b_cost.get(k)
            if not _close(a, b, rel):
                out[f"cost.{k}"] = (a, b)
        return out

    def summary_line(self) -> str:
        """One-line human summary; with more than one request class it
        appends each class's p99 + shed count (the multi-tenant demos'
        per-class print blocks, folded into the report itself)."""
        r = self.response
        line = (f"[{self.plane}] {self.name or 'experiment'}: "
                f"{self.n_completed}/{self.n_jobs} completed "
                f"(+{self.n_rejected} gated, {self.n_failed} failed), "
                f"mean {r.get('mean', math.nan):.3f}s "
                f"p99 {r.get('p99', math.nan):.3f}s, "
                f"{self.reconfigurations} recompositions")
        if len(self.per_class) > 1:
            parts = []
            for c in sorted(self.per_class):
                e = self.per_class[c]
                name = e.get("name") or f"class{c}"
                p99 = float((e.get("response") or {}).get("p99", math.nan))
                parts.append(f"{name} p99 {p99:.3f}s"
                             f" shed {int(e.get('rejected', 0) or 0)}")
            line += " | " + ", ".join(parts)
        return line


def report_from_orchestrator(spec, orch, summary: dict, dt: float,
                             plane: str = "live",
                             cost: Optional[dict] = None,
                             extras: Optional[dict] = None) -> RunReport:
    """Fold a live-plane drive summary + orchestrator state into the
    unified schema.

    ``spec.warmup_fraction`` trims the front of the completion-ordered
    finished list before any quantile is computed — the same rule the sim
    plane's ``SimResult`` applies — so cross-plane diffs compare the same
    job population.  ``completed_all`` is judged on the untrimmed counts.
    """
    n_finished_total = len(orch.finished)
    skip = int(n_finished_total * spec.warmup_fraction)
    finished = orch.finished[skip:]
    rts = np.asarray([r.response_time() for r in finished
                      if r.response_time() is not None])
    wts = np.asarray([r.waiting_time() for r in finished
                      if r.waiting_time() is not None])
    per_class: Dict[int, dict] = {}
    if len(orch.classes) > 1:
        for c, rc in enumerate(orch.classes):
            c_rts = np.asarray([r.response_time() for r in finished
                                if r.cls == c
                                and r.response_time() is not None])
            c_wts = np.asarray([r.waiting_time() for r in finished
                                if r.cls == c
                                and r.waiting_time() is not None])
            per_class[c] = {
                "name": rc.name,
                "n": int(sum(1 for r in finished if r.cls == c)),
                "rejected": int(sum(1 for r in orch.deferred
                                    if r.cls == c)),
                "response": _quantile_stats(c_rts),
                "waiting": _quantile_stats(c_wts),
            }
    n_jobs = summary.get("n_jobs", n_finished_total + len(orch.failed)
                         + len(orch.deferred))
    all_extras = {"rounds": summary.get("rounds", 0),
                  "idle_skipped": summary.get("idle_skipped", 0),
                  "deferred": len(orch.deferred),
                  "c_star": orch.c_star,
                  "chains": [(list(c), cap)
                             for c, cap in ((tuple(e.chain.servers),
                                             e.capacity)
                                            for e in orch.engines)]}
    all_extras.update(extras or {})
    return RunReport(
        plane=plane,
        name=spec.name,
        n_jobs=n_jobs,
        n_completed=len(finished),
        n_rejected=len(orch.deferred),
        n_failed=len(orch.failed),
        completed_all=(n_finished_total == n_jobs and not orch.failed
                       and not orch.deferred),
        sim_time=summary.get("rounds", 0) * dt,
        response=_quantile_stats(rts),
        waiting=_quantile_stats(wts),
        per_class=per_class,
        events=list(summary.get("events", [])),
        reconfigurations=orch.recompositions,
        restarts=int(sum(r.retries for r in orch.finished)
                     + sum(r.retries for r in orch.failed)),
        cost=cost,
        extras=all_extras,
        raw=summary,
    )

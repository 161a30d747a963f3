"""Result types of the queueing simulator (Section 4.1).

:class:`SimResult` is the output schema every simulation backend of the
JAX package fills in; ``_quantile_stats`` is the one quantile summary
every report uses.  The port keeps these two pieces of the JAX package's
``core/simulator.py`` (``core/engines/result.py`` there): the scenario
result and the run report need them.  The event simulator and its
backends come with the sim plane (ROADMAP queue 1, item 9).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional

import numpy as np


def _quantile_stats(x: np.ndarray) -> dict:
    if len(x) == 0:
        return {"mean": math.nan}
    # one fused partition for all three quantiles (3x fewer O(n) passes
    # than separate median/p95/p99 calls — this runs once per report and
    # twice more per request class, so sweeps feel it)
    med, p95, p99 = np.percentile(x, (50.0, 95.0, 99.0))
    return {
        "mean": float(np.mean(x)),
        "median": float(med),
        "p95": float(p95),
        "p99": float(p99),
        "max": float(np.max(x)),
        "min": float(np.min(x)),
    }


@dataclasses.dataclass
class SimResult:
    response_times: np.ndarray
    waiting_times: np.ndarray
    service_times: np.ndarray
    n_completed: int
    sim_time: float
    # multi-tenant extensions (None / 0 for class-blind legacy constructions)
    class_ids: Optional[np.ndarray] = None       # per completed job, aligned
    n_rejected: int = 0                          # shed by the admission gate
    rejected_class_ids: Optional[np.ndarray] = None

    def summary(self) -> dict:
        out = {
            "response": _quantile_stats(self.response_times),
            "waiting": _quantile_stats(self.waiting_times),
            "service": _quantile_stats(self.service_times),
            "n": self.n_completed,
        }
        if self.n_rejected:
            out["rejected"] = self.n_rejected
        return out

    def per_class(self, response_stats: Optional[dict] = None,
                  waiting_stats: Optional[dict] = None) -> Dict[int, dict]:
        """Per-class response/waiting quantiles + completion/shed counts.

        ``response_stats`` / ``waiting_stats`` are optional precomputed
        whole-run ``_quantile_stats`` dicts: in the common class-blind
        case (one default class, nothing shed) class 0's stats ARE the
        run's stats, so a caller that already computed them (the report
        layer) avoids re-partitioning the same arrays.
        """
        if self.class_ids is None:
            return {}
        rej = self.rejected_class_ids if self.rejected_class_ids is not None \
            else np.empty(0, dtype=np.int64)
        if len(rej) == 0 and len(self.class_ids) \
                and not np.any(self.class_ids):
            # the common class-blind run: one default class, nothing shed —
            # the masks would select everything, so skip building them
            return {0: {
                "n": int(len(self.class_ids)),
                "rejected": 0,
                "response": dict(response_stats) if response_stats
                is not None else _quantile_stats(self.response_times),
                "waiting": dict(waiting_stats) if waiting_stats
                is not None else _quantile_stats(self.waiting_times),
            }}
        present = set(np.unique(self.class_ids).tolist()) \
            | set(np.unique(rej).tolist())
        out: Dict[int, dict] = {}
        for c in sorted(present):
            m = self.class_ids == c
            out[int(c)] = {
                "n": int(np.sum(m)),
                "rejected": int(np.sum(rej == c)),
                "response": _quantile_stats(self.response_times[m]),
                "waiting": _quantile_stats(self.waiting_times[m]),
            }
        return out

    @property
    def mean_response(self) -> float:
        return float(np.mean(self.response_times)) if len(self.response_times) else math.nan

    @property
    def mean_occupancy_via_little(self) -> float:
        # E[N] = lambda_eff * E[T]
        lam_eff = self.n_completed / self.sim_time
        return lam_eff * self.mean_response

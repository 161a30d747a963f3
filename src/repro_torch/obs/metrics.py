"""Streaming metrics: counters, gauges, and fixed-bucket log histograms.

The repo's aggregate statistics (``_quantile_stats``) need the full sample
array in memory; the autoscale
:class:`~repro_torch.autoscale.telemetry.Telemetry` would need an unbounded
``(t, resp, cls)`` list for the same reason.  The
types here give streaming p50/p99 in O(buckets) memory instead:
:class:`LogHistogram` bins samples into fixed log-scale buckets (geometric
bucket midpoints bound the relative quantile error by the bucket ratio,
~6% at the default resolution) while tracking count/sum/min/max exactly.

A :class:`MetricsRegistry` is a flat get-or-create namespace of instruments;
:meth:`MetricsRegistry.snapshot` freezes it into a plain-dict
:class:`MetricsSnapshot` whose :meth:`MetricsSnapshot.diff` is the
run-to-run regression check the benchmarks share.

A copy of the JAX package's ``obs/metrics.py`` (numpy only).
"""
from __future__ import annotations

import math
from typing import Any, Dict, Iterable, Tuple, Union

import numpy as np

__all__ = ["Counter", "Gauge", "LogHistogram", "MetricsRegistry",
           "MetricsSnapshot"]


class Counter:
    """Monotonic event count."""

    __slots__ = ("value",)

    def __init__(self) -> None:
        self.value = 0

    def inc(self, n: int = 1) -> None:
        self.value += int(n)


class Gauge:
    """Last-written scalar (queue depth, capacity, admission level...)."""

    __slots__ = ("value",)

    def __init__(self) -> None:
        self.value = math.nan

    def set(self, v: float) -> None:
        self.value = float(v)


class LogHistogram:
    """Fixed-bucket log-scale histogram with streaming quantiles.

    Buckets are geometric: bucket ``i`` covers
    ``[lo * step**i, lo * step**(i+1))`` with ``step = 10**(1/per_decade)``.
    Samples below ``lo`` land in an underflow bucket (reported as ``lo``),
    samples at or above ``hi`` in an overflow bucket (reported as the exact
    tracked max).  Count, sum, min and max are exact; quantiles are bucket
    midpoints, so their relative error is bounded by ``sqrt(step)``.
    """

    __slots__ = ("lo", "hi", "per_decade", "_log_lo", "_log_step",
                 "_counts", "count", "sum", "min", "max")

    def __init__(self, lo: float = 1e-6, hi: float = 1e6,
                 per_decade: int = 40) -> None:
        if not (0.0 < lo < hi):
            raise ValueError(f"need 0 < lo < hi, got lo={lo} hi={hi}")
        self.lo = float(lo)
        self.hi = float(hi)
        self.per_decade = int(per_decade)
        self._log_lo = math.log10(self.lo)
        self._log_step = 1.0 / self.per_decade
        n = int(math.ceil((math.log10(self.hi) - self._log_lo)
                          * self.per_decade))
        # [0] = underflow (x < lo), [1..n] = log buckets, [n+1] = overflow
        self._counts = np.zeros(n + 2, dtype=np.int64)
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf

    def _index(self, x: float) -> int:
        if x < self.lo:
            return 0
        if x >= self.hi:
            return len(self._counts) - 1
        return 1 + int((math.log10(x) - self._log_lo) / self._log_step)

    def record(self, x: float) -> None:
        x = float(x)
        if math.isnan(x):
            return
        self._counts[self._index(x)] += 1
        self.count += 1
        self.sum += x
        if x < self.min:
            self.min = x
        if x > self.max:
            self.max = x

    def record_many(self, xs: Iterable[float]) -> None:
        a = np.asarray(list(xs) if not isinstance(xs, np.ndarray) else xs,
                       dtype=np.float64).ravel()
        a = a[~np.isnan(a)]
        if not len(a):
            return
        idx = np.ones(len(a), dtype=np.int64)
        mid = (a >= self.lo) & (a < self.hi)
        with np.errstate(divide="ignore"):
            idx[mid] = 1 + ((np.log10(a[mid]) - self._log_lo)
                            / self._log_step).astype(np.int64)
        idx[a < self.lo] = 0
        idx[a >= self.hi] = len(self._counts) - 1
        np.add.at(self._counts, idx, 1)
        self.count += int(len(a))
        self.sum += float(np.sum(a))
        self.min = min(self.min, float(np.min(a)))
        self.max = max(self.max, float(np.max(a)))

    def _bucket_value(self, i: int) -> float:
        if i == 0:
            return self.lo
        if i == len(self._counts) - 1:
            return self.max if self.max > -math.inf else self.hi
        # geometric midpoint of the bucket
        return 10.0 ** (self._log_lo + (i - 0.5) * self._log_step)

    def quantile(self, q: float) -> float:
        """Approximate ``q``-th percentile (``q`` in [0, 100])."""
        if self.count == 0:
            return math.nan
        if q <= 0:
            return self.min
        if q >= 100:
            return self.max
        target = q / 100.0 * self.count
        acc = 0
        for i, c in enumerate(self._counts):
            acc += int(c)
            if acc >= target:
                return min(max(self._bucket_value(i), self.min), self.max)
        return self.max

    def merge(self, other: "LogHistogram") -> None:
        if (other.lo != self.lo or other.hi != self.hi
                or other.per_decade != self.per_decade):
            raise ValueError("cannot merge histograms with different buckets")
        self._counts += other._counts
        self.count += other.count
        self.sum += other.sum
        self.min = min(self.min, other.min)
        self.max = max(self.max, other.max)

    @property
    def mean(self) -> float:
        return self.sum / self.count if self.count else math.nan

    def to_dict(self) -> Dict[str, float]:
        if self.count == 0:
            return {"count": 0}
        return {"count": self.count, "mean": self.mean,
                "min": self.min, "max": self.max,
                "p50": self.quantile(50), "p90": self.quantile(90),
                "p99": self.quantile(99)}


Instrument = Union[Counter, Gauge, LogHistogram]


class MetricsRegistry:
    """Flat get-or-create namespace of instruments.

    Names are dotted paths by convention (``engine.completed``,
    ``orchestrator.rounds``, ``controller.scale_ups``).  Asking for an
    existing name returns the existing instrument; asking for it with a
    different type raises.
    """

    def __init__(self) -> None:
        self._instruments: Dict[str, Instrument] = {}

    def _get(self, name: str, cls, **kwargs) -> Instrument:
        inst = self._instruments.get(name)
        if inst is None:
            inst = cls(**kwargs)
            self._instruments[name] = inst
        elif not isinstance(inst, cls):
            raise TypeError(f"metric {name!r} already registered as "
                            f"{type(inst).__name__}, not {cls.__name__}")
        return inst

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge)

    def histogram(self, name: str, lo: float = 1e-6, hi: float = 1e6,
                  per_decade: int = 40) -> LogHistogram:
        return self._get(name, LogHistogram, lo=lo, hi=hi,
                         per_decade=per_decade)

    def snapshot(self) -> "MetricsSnapshot":
        values: Dict[str, Any] = {}
        for name, inst in sorted(self._instruments.items()):
            if isinstance(inst, LogHistogram):
                values[name] = inst.to_dict()
            else:
                values[name] = inst.value
        return MetricsSnapshot(values)


class MetricsSnapshot:
    """Frozen plain-dict view of a registry (or any name→value mapping).

    Histogram entries are nested dicts; everything is JSON-safe, so a
    snapshot can be embedded verbatim in a ``BENCH_*.json`` row and
    compared to a previous run with :meth:`diff`.
    """

    __slots__ = ("values",)

    def __init__(self, values: Dict[str, Any]) -> None:
        self.values = dict(values)

    def as_dict(self) -> Dict[str, Any]:
        return dict(self.values)

    def __getitem__(self, name: str) -> Any:
        return self.values[name]

    def __contains__(self, name: str) -> bool:
        return name in self.values

    def __repr__(self) -> str:
        return f"MetricsSnapshot({self.values!r})"

    @staticmethod
    def _flat(values: Dict[str, Any], prefix: str = "") -> Dict[str, Any]:
        out: Dict[str, Any] = {}
        for k, v in values.items():
            key = f"{prefix}{k}"
            if isinstance(v, dict):
                out.update(MetricsSnapshot._flat(v, key + "."))
            else:
                out[key] = v
        return out

    def diff(self, other: "MetricsSnapshot",
             rel: float = 1e-9) -> Dict[str, Tuple[Any, Any]]:
        """Flattened fields where two snapshots disagree:
        ``{name: (self, other)}``.  Floats compare to ``rel`` relative
        tolerance (NaN == NaN); a name missing on one side reports
        ``None`` for that side.  Empty dict == no regression.
        """
        a = self._flat(self.values)
        b = self._flat(other.values)
        out: Dict[str, Tuple[Any, Any]] = {}
        for k in sorted(set(a) | set(b)):
            va, vb = a.get(k), b.get(k)
            if isinstance(va, float) and isinstance(vb, float):
                if math.isnan(va) and math.isnan(vb):
                    continue
                if math.isclose(va, vb, rel_tol=rel, abs_tol=1e-12):
                    continue
                out[k] = (va, vb)
            elif va != vb:
                out[k] = (va, vb)
        return out

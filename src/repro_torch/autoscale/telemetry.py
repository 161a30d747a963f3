"""Telemetry: the observation half of the autoscaling feedback loop.

A :class:`Telemetry` window ingests three streams —

  * **arrivals** (timestamps, possibly batched),
  * **completions** (timestamp + response time),
  * **state samples** (queue depth, in-flight jobs, slot capacity, server
    count at a control tick)

— and exposes the estimators the :mod:`repro_torch.autoscale.policies` consume:
sliding-window + EWMA arrival-rate estimates, a least-squares rate trend
(the predictive policy's forecast input), queue depth and its gradient,
slot utilization, and response-time quantiles over the window.

Two feeders are provided for the two execution planes:

  * :func:`sample_simulator` — reads a paused queueing simulator through
    its telemetry taps (``run_until`` pauses at control-tick boundaries;
    the taps are read-only); the sim plane is not ported yet (ROADMAP
    queue 1, item 9);
  * :func:`sample_orchestrator` — reads a live
    ``repro_torch.serving.Orchestrator`` between decode rounds (registered
    as a per-step hook by ``AutoscaleController.bind_orchestrator``).

A copy of the JAX package's ``autoscale/telemetry.py`` (numpy only).

Memory bound: the completion buffer is capped at
``TelemetryConfig.max_completions`` records.  Below the cap quantiles are
exact (interpolated percentiles over the raw window, the behaviour the
policy tests pin).  When a burst overflows the cap the *oldest* records
spill out (never the newest — the window wants recent data) and
:meth:`Telemetry.response_quantile` transparently falls back to a pair of
rotating per-class :class:`repro_torch.obs.LogHistogram` sketches covering the
last one-to-two windows, so tail estimates stay meaningful at any
completion rate in O(buckets) memory.
"""
from __future__ import annotations

import bisect
import dataclasses
import math
from collections import deque
from typing import Deque, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.obs.metrics import LogHistogram


@dataclasses.dataclass
class TelemetryConfig:
    window: float = 20.0          # sliding-window length (seconds)
    ewma_alpha: float = 0.3       # smoothing of the per-tick rate estimate
    max_completions: int = 100_000  # hard cap on retained completion records


@dataclasses.dataclass(frozen=True)
class StateSample:
    time: float
    queue_depth: int
    in_flight: int
    capacity: int
    n_servers: int


class Telemetry:
    """Sliding-window estimators over arrival/completion/state streams."""

    def __init__(self, config: TelemetryConfig = TelemetryConfig()):
        self.cfg = config
        self._arrivals: Deque[float] = deque()
        # (t, resp, cls) — class 0 unless the feeder reports SLO classes
        self._completions: Deque[Tuple[float, float, int]] = deque()
        self._samples: Deque[StateSample] = deque()
        self._rates: Deque[Tuple[float, float]] = deque()        # (t, window rate)
        self.rate_ewma: float = 0.0
        self._t0: Optional[float] = None    # first observation time
        self.now: float = 0.0
        self.n_arrivals = 0
        self.n_completions = 0
        # histogram fallback state: per-class rotating (previous, current)
        # sketch pair; _cap_evict_t is the newest timestamp ever spilled by
        # the cap — quantiles are exact while every spilled record would
        # have aged out of the window anyway
        self._hists: Dict[int, Tuple[LogHistogram, LogHistogram]] = {}
        self._hist_start: float = 0.0
        self._cap_evict_t: float = -math.inf

    # -- ingestion -----------------------------------------------------------
    def _advance(self, t: float) -> None:
        if self._t0 is None:
            self._t0 = t
        self.now = max(self.now, t)
        horizon = self.now - self.cfg.window
        while self._arrivals and self._arrivals[0] <= horizon:
            self._arrivals.popleft()
        while self._completions and self._completions[0][0] <= horizon:
            self._completions.popleft()
        while self._samples and self._samples[0].time <= horizon:
            self._samples.popleft()
        while self._rates and self._rates[0][0] <= horizon:
            self._rates.popleft()

    def record_arrival(self, t: float) -> None:
        self.n_arrivals += 1
        self._arrivals.append(t)
        self._advance(t)

    def record_arrivals(self, times: np.ndarray) -> None:
        """Batched arrivals (already time-sorted)."""
        if len(times) == 0:
            return
        if self._t0 is None:       # the window opens at the first *arrival*,
            self._t0 = float(times[0])   # not at the end of the first batch
        self.n_arrivals += len(times)
        self._arrivals.extend(float(t) for t in times)
        self._advance(float(times[-1]))

    def record_completion(self, t: float, response_time: float,
                          cls: int = 0) -> None:
        self.n_completions += 1
        self._completions.append((t, response_time, cls))
        # spill the OLDEST records past the cap (the window wants recent
        # data); remember the newest spilled timestamp so quantiles know
        # when the exact buffer stopped covering the whole window
        while len(self._completions) > self.cfg.max_completions:
            old_t, _, _ = self._completions.popleft()
            self._cap_evict_t = max(self._cap_evict_t, old_t)
        self._rotate_hists(t)
        cur = self._hists.setdefault(
            int(cls), (LogHistogram(), LogHistogram()))[1]
        cur.record(response_time)
        self._advance(t)

    def _rotate_hists(self, t: float) -> None:
        """Age the sketch pair: once a full window has accumulated in the
        current sketches they become the previous generation.  prev+cur
        together always cover the last one-to-two windows."""
        if t - self._hist_start < self.cfg.window:
            return
        self._hists = {c: (cur, LogHistogram())
                       for c, (_, cur) in self._hists.items()}
        self._hist_start = t

    def record_sample(
        self,
        t: float,
        queue_depth: int,
        in_flight: int,
        capacity: int,
        n_servers: int,
    ) -> StateSample:
        """One control-tick state snapshot; updates the EWMA rate estimate."""
        self._advance(t)
        sample = StateSample(t, queue_depth, in_flight, capacity, n_servers)
        self._samples.append(sample)
        inst = self.arrival_rate_window()
        a = self.cfg.ewma_alpha
        self.rate_ewma = inst if len(self._rates) == 0 \
            else (1 - a) * self.rate_ewma + a * inst
        self._rates.append((t, inst))
        return sample

    # -- estimators ------------------------------------------------------------
    def _elapsed_window(self) -> float:
        if self._t0 is None:
            return 0.0
        return min(self.cfg.window, self.now - self._t0)

    def arrival_rate_window(self) -> float:
        """Arrivals per second over the (possibly still-filling) window."""
        dt = self._elapsed_window()
        return len(self._arrivals) / dt if dt > 0 else 0.0

    def arrival_rate(self) -> float:
        """The smoothed estimate policies should act on (EWMA of window rates,
        falling back to the raw window rate before the first sample)."""
        return self.rate_ewma if self._rates else self.arrival_rate_window()

    def rate_trend(self) -> float:
        """d(rate)/dt via least squares over the windowed rate samples
        (0 until two samples exist)."""
        if len(self._rates) < 2:
            return 0.0
        ts = np.array([t for t, _ in self._rates])
        rs = np.array([r for _, r in self._rates])
        ts = ts - ts.mean()
        denom = float(np.dot(ts, ts))
        if denom <= 0:
            return 0.0
        return float(np.dot(ts, rs - rs.mean()) / denom)

    def forecast_rate(self, horizon: float) -> float:
        """Trend-extrapolated arrival rate ``horizon`` seconds ahead."""
        return max(0.0, self.arrival_rate() + self.rate_trend() * horizon)

    def queue_depth(self) -> int:
        return self._samples[-1].queue_depth if self._samples else 0

    def queue_gradient(self) -> float:
        """d(queue depth)/dt via least squares over the windowed samples."""
        if len(self._samples) < 2:
            return 0.0
        ts = np.array([s.time for s in self._samples])
        qs = np.array([s.queue_depth for s in self._samples], dtype=np.float64)
        ts = ts - ts.mean()
        denom = float(np.dot(ts, ts))
        if denom <= 0:
            return 0.0
        return float(np.dot(ts, qs - qs.mean()) / denom)

    def utilization(self) -> float:
        s = self._samples[-1] if self._samples else None
        if s is None:
            return 0.0
        return s.in_flight / s.capacity if s.capacity else 1.0

    def _exact_covers_window(self) -> bool:
        """True while no record spilled by the cap is still inside the
        window — i.e. the raw buffer holds every windowed completion."""
        return self._cap_evict_t <= self.now - self.cfg.window

    def response_quantile(self, q: float, cls: Optional[int] = None) -> float:
        """q-th percentile (0..100) of windowed response times (nan if
        none); ``cls`` restricts to one SLO class — the per-class p99 the
        SLO-aware admission policy watches.

        Exact (interpolated over the raw buffer) below the completion cap;
        past it, a bucketed :class:`~repro_torch.obs.LogHistogram` estimate over
        the last one-to-two windows."""
        if not self._exact_covers_window():
            merged = LogHistogram()
            for c, (prev, cur) in self._hists.items():
                if cls is None or c == cls:
                    merged.merge(prev)
                    merged.merge(cur)
            if merged.count:
                return merged.quantile(q)
            return math.nan
        rts = [r for _, r, c in self._completions
               if cls is None or c == cls]
        if not rts:
            return math.nan
        return float(np.percentile(rts, q))

    def completions_in_window(self, cls: Optional[int] = None) -> int:
        if cls is None:
            return len(self._completions)
        return sum(1 for _, _, c in self._completions if c == cls)


# ---------------------------------------------------------------------------
# Feeders
# ---------------------------------------------------------------------------

def sample_simulator(tel: Telemetry, sim, t: float, n_servers: int,
                     cursor: Tuple[int, float]) -> Tuple[int, float]:
    """Feed one control tick from a paused queueing simulator.

    ``cursor`` is ``(completion_cursor, last_tick_time)`` — pass ``(0, 0.0)``
    at the first tick and the returned pair thereafter.  Arrivals in
    ``(last_tick, t]`` are replayed from the simulator's arrival array (they
    are known there up front; telemetry still only sees the past), completions
    since the last tick contribute response times, and the paused queue /
    in-flight / capacity state becomes the tick's :class:`StateSample`.
    """
    comp_cursor, last_t = cursor
    lo = bisect.bisect_right(sim.times, last_t)
    hi = bisect.bisect_right(sim.times, t)
    if hi > lo:
        tel.record_arrivals(np.asarray(sim.times[lo:hi]))
    comp_cursor, jids = sim.completions_since(comp_cursor)
    for jid in jids:
        tel.record_completion(min(t, sim.fin[jid]), sim.response_time_of(jid),
                              cls=sim.cls[jid])
    tel.record_sample(t, queue_depth=sim.queue_len(at=t),
                      in_flight=sim.in_flight,
                      capacity=sim.total_capacity, n_servers=n_servers)
    return comp_cursor, t


def sample_orchestrator(tel: Telemetry, orch, t: float,
                        finished_cursor: int) -> int:
    """Feed one decode-round tick from a live ``Orchestrator``.

    Arrivals are recorded separately via the orchestrator's submit hook;
    this samples queue/slot state and harvests completions past
    ``finished_cursor`` (an index into ``orch.finished``).
    """
    fin: List = orch.finished
    for req in fin[finished_cursor:]:
        rt = req.response_time()
        tel.record_completion(t, rt if rt is not None else 0.0,
                              cls=getattr(req, "cls", 0))
    capacity = sum(e.capacity for e in orch.engines)
    in_flight = sum(e.num_active for e in orch.engines)
    tel.record_sample(t, queue_depth=len(orch.queue), in_flight=in_flight,
                      capacity=capacity, n_servers=len(orch.servers))
    return len(fin)

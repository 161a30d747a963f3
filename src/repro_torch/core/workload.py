"""Workload generation (Section 4.1.1 / 4.2.1).

Scalar generators (tuple lists, ``random.Random``):
  * ``poisson_exponential`` — the analysis assumptions (Poisson arrivals,
    Exp(1) work).
  * ``azure_like_trace`` — synthetic trace matching the Azure LLM-inference
    trace statistics the paper reports (Fig. 11): bursty arrivals whose
    inter-arrival std is ~13x the exponential with the same mean, input
    lengths ~2048 tokens, output lengths ~28 tokens, service less bursty than
    exponential (std ratio ~0.75).

Batched generators (numpy arrays, ``np.random.Generator``) feed the
vectorized engine directly and are 1-2 orders of magnitude faster — the
difference between waiting on the workload or on the simulation for
million-job traces:
  * ``poisson_exponential_np`` / ``azure_like_trace_np`` — array twins of
    the above (independent RNG streams, same distributions).
  * ``phased_poisson`` — piecewise-constant-rate Poisson arrivals for the
    scenario engine's burst phases (exact: the process is memoryless, so
    per-phase generation composes).

Rate profiles for the autoscaling control plane (:mod:`repro_torch.autoscale`):
  * ``diurnal_phases`` / ``diurnal_poisson`` — a sinusoidal day/night load
    curve discretized to piecewise-constant phases, the canonical workload an
    autoscaler must track (provision the peak, release the trough);
  * ``trace_replay_phases`` — an empirical rate profile estimated from any
    arrival-time array (e.g. ``azure_like_trace_np`` times), replayable at a
    different scale through :func:`phased_poisson`.

``token_work`` converts per-job (in_tokens, out_tokens) into an effective
service-work multiplier (prefill compute-bound, decode bandwidth-bound, as
in the paper's footnote 11), normalized to mean ~1 so composed chain rates
keep their jobs/sec meaning — the bridge that lets the simulators consume
trace token counts directly.

A copy of the JAX package's ``core/workload.py``: every generator draws
from ``random.Random`` / ``np.random.default_rng`` in the same order, so a
seed gives the same arrival trace in both packages.

Multi-tenant SLO classes: real LLM serving fleets multiplex tenants with
very different latency expectations (interactive chat vs. batch
summarization — the DeepServe regime).  :class:`RequestClass`
(:mod:`repro_torch.core.classes`, re-exported here) is the first-class
description of one such tenant class (priority tier, SLO target, shed
deadline) threaded through every layer of the request path:

  * ``classed_poisson_mix`` — superposed per-class Poisson streams with
    Exp(1) works, returned as class-labeled ``(times, works, class_ids)``
    arrays;
  * ``classed_phased_poisson`` — per-class piecewise-constant-rate streams
    (the scenario engine's ``tenant_burst`` phases);
  * ``label_classes`` / ``classed_azure_trace_np`` — i.i.d. class labels by
    mix weight over any arrival batch, incl. the azure-like trace.
"""
from __future__ import annotations

import dataclasses
import math
import random
from typing import List, Optional, Sequence, Tuple

import numpy as np

from .classes import DEFAULT_CLASS, RequestClass  # noqa: F401  (re-exported)

Arrival = Tuple[float, float, int, int]   # (time, work, in_tokens, out_tokens)




def interactive_batch_mix(
    interactive_slo: float = 2.0,
    batch_deadline: float = math.inf,
    batch_slo: float = math.inf,
) -> Tuple[RequestClass, RequestClass]:
    """The canonical two-tenant mix: latency-sensitive interactive chat
    (tier 0) over best-effort batch summarization (tier 1).  A finite
    ``batch_deadline`` arms the admission gate for the batch class."""
    return (
        RequestClass("interactive", "chat", 0, slo_target=interactive_slo),
        RequestClass("batch", "offline", 1, slo_target=batch_slo,
                     deadline=batch_deadline),
    )


def poisson_exponential(lam: float, n: int, seed: int = 0) -> List[Arrival]:
    rng = random.Random(seed)
    t, out = 0.0, []
    for _ in range(n):
        t += rng.expovariate(lam)
        out.append((t, rng.expovariate(1.0), 0, 0))
    return out


@dataclasses.dataclass
class TraceStats:
    mean_rate: float
    interarrival_std_ratio: float     # vs exponential with the same mean
    mean_in_tokens: float
    mean_out_tokens: float


AZURE_STATS = TraceStats(
    mean_rate=2.57, interarrival_std_ratio=13.15,
    mean_in_tokens=2048, mean_out_tokens=28,
)


def azure_like_trace(
    n: int,
    stats: TraceStats = AZURE_STATS,
    seed: int = 0,
    rate_scale: float = 1.0,
) -> List[Arrival]:
    """Bursty arrivals via a 2-state MMPP (burst/idle) calibrated so the
    inter-arrival std ratio approximates ``stats.interarrival_std_ratio``;
    token counts via gamma distributions (less bursty than exponential, std
    ratio ~0.75 as measured by the paper)."""
    rng = random.Random(seed)
    lam = stats.mean_rate * rate_scale
    # 2-state hyper-exponential interarrivals: with prob p short gaps (burst),
    # else long gaps; mean fixed to 1/lam.  Calibrate r = long/short so the
    # coefficient of variation matches the target std ratio:
    #   CV^2 = 2 (p + q r^2) / (p + q r)^2 - 1,  q = 1 - p.
    p = 0.99
    q = 1 - p
    target = 1 + stats.interarrival_std_ratio ** 2
    r = 1.0
    for _ in range(60):                       # monotone in r: bisection-free
        cur = 2 * (p + q * r * r) / (p + q * r) ** 2
        if cur >= target:
            break
        r *= 1.3
    a = (1.0 / lam) / (p + q * r)
    b = a * r
    t, out = 0.0, []
    for _ in range(n):
        gap = rng.expovariate(1 / a) if rng.random() < p else rng.expovariate(1 / b)
        t += gap
        # gamma(k=2) has std ratio 1/sqrt(2) ~ 0.71 vs exponential
        work = rng.gammavariate(2.0, 0.5)
        tin = max(1, int(rng.gammavariate(4.0, stats.mean_in_tokens / 4.0)))
        tout = max(1, int(rng.gammavariate(2.0, stats.mean_out_tokens / 2.0)))
        out.append((t, work, tin, tout))
    return out


def poisson_exponential_np(
    lam: float, n: int, seed: int = 0
) -> Tuple[np.ndarray, np.ndarray]:
    """Batched Poisson(lam) arrivals with Exp(1) works: (times, works)."""
    rng = np.random.default_rng(seed)
    times = np.cumsum(rng.exponential(1.0 / lam, size=n))
    works = rng.exponential(1.0, size=n)
    return times, works


def azure_like_trace_np(
    n: int,
    stats: TraceStats = AZURE_STATS,
    seed: int = 0,
    rate_scale: float = 1.0,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Batched twin of :func:`azure_like_trace`:
    (times, works, in_tokens, out_tokens) arrays."""
    rng = np.random.default_rng(seed)
    lam = stats.mean_rate * rate_scale
    p = 0.99
    q = 1 - p
    target = 1 + stats.interarrival_std_ratio ** 2
    r = 1.0
    for _ in range(60):
        cur = 2 * (p + q * r * r) / (p + q * r) ** 2
        if cur >= target:
            break
        r *= 1.3
    a = (1.0 / lam) / (p + q * r)
    b = a * r
    burst = rng.random(n) < p
    gaps = np.where(burst, rng.exponential(a, size=n), rng.exponential(b, size=n))
    times = np.cumsum(gaps)
    works = rng.gamma(2.0, 0.5, size=n)
    tin = np.maximum(1, rng.gamma(4.0, stats.mean_in_tokens / 4.0,
                                  size=n).astype(np.int64))
    tout = np.maximum(1, rng.gamma(2.0, stats.mean_out_tokens / 2.0,
                                   size=n).astype(np.int64))
    return times, works, tin, tout


def phased_poisson(
    phases: Sequence[Tuple[float, float, float]],
    seed: int = 0,
) -> Tuple[np.ndarray, np.ndarray]:
    """Arrivals of a piecewise-constant-rate Poisson process with Exp(1)
    works.  ``phases`` is ``[(t_start, t_end, rate), ...]``; phases may be
    given in any order but must not overlap.  Exact by memorylessness: each
    phase's arrivals are an independent Poisson process restricted to the
    phase window."""
    rng = np.random.default_rng(seed)
    chunks = []
    for (t0, t1, lam) in sorted(phases):
        dur = t1 - t0
        if lam <= 0 or dur <= 0:
            continue
        expect = lam * dur
        batch = int(expect + 6.0 * math.sqrt(expect + 1.0)) + 16
        ts = t0 + np.cumsum(rng.exponential(1.0 / lam, size=batch))
        while ts[-1] < t1:                      # rare top-up
            more = rng.exponential(1.0 / lam, size=batch)
            ts = np.concatenate([ts, ts[-1] + np.cumsum(more)])
        chunks.append(ts[ts < t1])
    if not chunks:
        return np.empty(0), np.empty(0)
    times = np.concatenate(chunks)
    works = rng.exponential(1.0, size=len(times))
    return times, works


def _merge_classed(
    chunks: Sequence[Tuple[np.ndarray, np.ndarray, int]],
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Stable time-merge of per-class (times, works) streams into one
    class-labeled batch."""
    chunks = [c for c in chunks if len(c[0])]
    if not chunks:
        return (np.empty(0), np.empty(0), np.empty(0, dtype=np.int64))
    times = np.concatenate([t for t, _, _ in chunks])
    works = np.concatenate([w for _, w, _ in chunks])
    cls = np.concatenate([np.full(len(t), c, dtype=np.int64)
                          for t, _, c in chunks])
    order = np.argsort(times, kind="stable")
    return times[order], works[order], cls[order]


def classed_poisson_mix(
    class_rates: Sequence[float],
    horizon: float,
    seed: int = 0,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Superposed per-class Poisson streams with Exp(1) works over
    ``[0, horizon)``: class ``c`` arrives at rate ``class_rates[c]``.
    Returns time-sorted ``(times, works, class_ids)`` arrays — the
    class-labeled twin of :func:`poisson_exponential_np`.  Each class draws
    from an independent RNG stream, so adding a class never perturbs the
    others' sample paths."""
    chunks = []
    for c, lam in enumerate(class_rates):
        if lam <= 0 or horizon <= 0:
            continue
        t, w = phased_poisson([(0.0, horizon, lam)], seed=seed + 100003 * (c + 1))
        chunks.append((t, w, c))
    return _merge_classed(chunks)


def classed_phased_poisson(
    phases_per_class: Sequence[Sequence[Tuple[float, float, float]]],
    seed: int = 0,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Per-class piecewise-constant-rate Poisson streams, merged into one
    class-labeled batch — the scenario engine's ``tenant_burst`` workload
    (each class has its own rate profile)."""
    chunks = []
    for c, phases in enumerate(phases_per_class):
        t, w = phased_poisson(phases, seed=seed + 100003 * (c + 1))
        chunks.append((t, w, c))
    return _merge_classed(chunks)


def label_classes(
    n: int, weights: Sequence[float], seed: int = 0
) -> np.ndarray:
    """i.i.d. class labels for ``n`` arrivals drawn by mix weight — attach
    tenant classes to any pre-generated arrival batch (e.g. a trace whose
    arrival process should stay untouched)."""
    w = np.asarray(weights, dtype=np.float64)
    if len(w) == 0 or np.any(w < 0) or w.sum() <= 0:
        raise ValueError("weights must be non-negative and sum > 0")
    rng = np.random.default_rng(seed)
    return rng.choice(len(w), size=n, p=w / w.sum()).astype(np.int64)


def classed_azure_trace_np(
    n: int,
    weights: Sequence[float],
    stats: TraceStats = AZURE_STATS,
    seed: int = 0,
    rate_scale: float = 1.0,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Class-labeled azure-like trace:
    ``(times, works, in_tokens, out_tokens, class_ids)`` — the bursty MMPP
    arrival process of :func:`azure_like_trace_np` with tenant labels drawn
    i.i.d. by ``weights`` (tenant mix is independent of burst state, as in
    multiplexed serving fleets)."""
    times, works, tin, tout = azure_like_trace_np(
        n, stats=stats, seed=seed, rate_scale=rate_scale)
    cls = label_classes(n, weights, seed=seed + 1)
    return times, works, tin, tout, cls


def diurnal_phases(
    base_rate: float,
    horizon: float,
    period: Optional[float] = None,
    amplitude: float = 0.6,
    n_segments: int = 48,
    phase_shift: float = -0.5 * math.pi,
) -> List[Tuple[float, float, float]]:
    """Piecewise-constant discretization of a sinusoidal day/night rate curve

        rate(t) = base_rate * (1 + amplitude * sin(2 pi t / period + shift))

    over ``[0, horizon)``; by default one full period spans the horizon and
    the shift starts the curve at the trough (night), so an autoscaler sees a
    ramp up to the midday peak and back down.  The segment rate is the curve
    evaluated at the segment midpoint.
    """
    if not 0.0 <= amplitude < 1.0:
        raise ValueError("amplitude must be in [0, 1)")
    period = horizon if period is None else period
    edges = np.linspace(0.0, horizon, n_segments + 1)
    phases = []
    for a, b in zip(edges[:-1], edges[1:]):
        mid = 0.5 * (a + b)
        rate = base_rate * (1.0 + amplitude
                            * math.sin(2.0 * math.pi * mid / period + phase_shift))
        phases.append((float(a), float(b), float(rate)))
    return phases


def diurnal_poisson(
    base_rate: float,
    horizon: float,
    period: Optional[float] = None,
    amplitude: float = 0.6,
    n_segments: int = 48,
    seed: int = 0,
) -> Tuple[np.ndarray, np.ndarray]:
    """(times, works) of a diurnal-rate Poisson process with Exp(1) works."""
    return phased_poisson(
        diurnal_phases(base_rate, horizon, period, amplitude, n_segments),
        seed=seed)


def trace_replay_phases(
    times: np.ndarray,
    bin_width: float,
    rate_scale: float = 1.0,
    min_rate: float = 0.0,
) -> List[Tuple[float, float, float]]:
    """Empirical piecewise-constant rate profile of an arrival-time array.

    Bins the trace at ``bin_width`` and returns ``(t0, t1, rate)`` phases
    re-based to start at 0, scaled by ``rate_scale`` — replay any recorded
    trace's load shape (e.g. ``azure_like_trace_np``) at a chosen scale via
    :func:`phased_poisson`, or feed it to the scenario engine as the ground
    truth an autoscaling policy must chase.
    """
    ts = np.asarray(times, dtype=np.float64)
    if len(ts) == 0:
        return []
    if bin_width <= 0:
        raise ValueError("bin_width must be positive")
    t0 = float(ts[0])
    span = float(ts[-1]) - t0
    n_bins = max(1, int(math.ceil(span / bin_width)) or 1)
    counts, edges = np.histogram(ts - t0, bins=n_bins,
                                 range=(0.0, n_bins * bin_width))
    phases = []
    for a, b, c in zip(edges[:-1], edges[1:], counts):
        # the trace may end mid-bin: rate over the covered span, not the
        # nominal bin width, or the closing rate reads ~2x too low
        b_eff = min(float(b), span) if span > a else float(b)
        width = b_eff - float(a)
        if width <= 0:
            continue
        phases.append((float(a), b_eff,
                       max(min_rate, rate_scale * c / width)))
    return phases


def token_work(
    in_tokens: np.ndarray,
    out_tokens: np.ndarray,
    stats: TraceStats = AZURE_STATS,
    prefill_weight: float = 0.5,
) -> np.ndarray:
    """Effective service work of each job from its token counts.

    Prefill cost scales with input length (compute-bound) and decode cost
    with output length (bandwidth-bound, one pass per generated token); the
    two are blended by ``prefill_weight`` (the prefill share of the *mean*
    job's service time) and normalized by the trace means, so a job with mean
    token counts has work 1.0 and composed chain rates keep their calibrated
    jobs/sec meaning.  This is Eq. (2)'s per-job service time with the
    token-dependent terms made explicit.
    """
    if not 0.0 <= prefill_weight <= 1.0:
        raise ValueError("prefill_weight must be in [0, 1]")
    tin = np.asarray(in_tokens, dtype=np.float64)
    tout = np.asarray(out_tokens, dtype=np.float64)
    return (prefill_weight * tin / stats.mean_in_tokens
            + (1.0 - prefill_weight) * tout / stats.mean_out_tokens)


def interarrival_std_ratio(arrivals: List[Arrival]) -> float:
    """Empirical std(inter-arrival)/std(exponential with the same mean) —
    exponential std equals its mean, so this is std/mean (coefficient of
    variation)."""
    times = [a[0] for a in arrivals]
    gaps = [b - a for a, b in zip(times[:-1], times[1:])]
    m = sum(gaps) / len(gaps)
    var = sum((g - m) ** 2 for g in gaps) / (len(gaps) - 1)
    return math.sqrt(var) / m

"""Steady-state response-time analysis of JFFC (Section 3.2.2, Appendix A.3).

All functions take the composed job servers as ``(mu_l, c_l)`` pairs sorted by
DESCENDING service rate, a Poisson arrival rate ``lam``, and return mean
occupancy E[sum Z_l]; mean response time follows from Little's law (Eq. 20).
"""
from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import numpy as np

JobServers = Sequence[Tuple[float, int]]    # [(mu_l, c_l)] descending mu


def _validate(job_servers: JobServers, lam: float) -> Tuple[List[float], List[int]]:
    mus = [float(m) for m, _ in job_servers]
    caps = [int(c) for _, c in job_servers]
    if any(m <= 0 for m in mus) or any(c < 1 for c in caps):
        raise ValueError("rates must be > 0 and capacities >= 1")
    if any(mus[i] < mus[i + 1] - 1e-15 for i in range(len(mus) - 1)):
        raise ValueError("job servers must be sorted by descending rate")
    if lam <= 0:
        raise ValueError("arrival rate must be positive")
    return mus, caps


def total_rate(job_servers: JobServers) -> float:
    """nu = sum_l c_l mu_l (Lemma 3.6 stability threshold)."""
    return sum(m * c for m, c in job_servers)


def death_rates_fastest_first(job_servers: JobServers) -> List[float]:
    """nu_bar_n, Eq. (24): departure rate with n jobs packed on fastest chains."""
    mus, caps = zip(*job_servers)
    C = sum(caps)
    out = []
    for n in range(1, C + 1):
        acc, used = 0.0, 0
        for mu, c in job_servers:
            k = min(c, max(n - used, 0))
            acc += mu * k
            used += c
        out.append(acc)
    return out


def death_rates_slowest_first(job_servers: JobServers) -> List[float]:
    """nu_under_n, Eq. (25): departure rate with n jobs packed on slowest chains."""
    rev = list(reversed(list(job_servers)))
    return death_rates_fastest_first(rev)


def _birth_death_occupancy(lam: float, deaths: Sequence[float], nu: float) -> float:
    """Mean occupancy of the birth-death chain with birth rate lam, death rates
    ``deaths[n-1]`` for n = 1..C and constant nu beyond C (Thm 3.7 / Eq. 26-28).

    Computed iteratively in ratio space to stay stable for large C."""
    C = len(deaths)
    if lam >= nu:
        return math.inf
    rho = lam / nu
    # b_n = phi_n / phi_0 for n = 0..C
    b = [1.0]
    for n in range(1, C + 1):
        b.append(b[-1] * lam / deaths[n - 1])
    # Normalization: sum_{n<=C-1} b_n + b_C * nu/(nu-lam)   [geometric tail]
    z = sum(b[:C]) + b[C] / (1.0 - rho)
    phi = [x / z for x in b]
    # E[Phi] = sum_{n<C} n phi_n + phi_C (rho/(1-rho)^2 + C/(1-rho))
    mean = sum(n * phi[n] for n in range(C))
    mean += phi[C] * (rho / (1.0 - rho) ** 2 + C / (1.0 - rho))
    return mean


def occupancy_lower_bound(job_servers: JobServers, lam: float) -> float:
    """Eq. (27): lower bound on steady-state mean occupancy under JFFC."""
    _validate(job_servers, lam)
    nu = total_rate(job_servers)
    return _birth_death_occupancy(lam, death_rates_fastest_first(job_servers), nu)


def occupancy_upper_bound(job_servers: JobServers, lam: float) -> float:
    """Eq. (28): upper bound on steady-state mean occupancy under JFFC."""
    _validate(job_servers, lam)
    nu = total_rate(job_servers)
    return _birth_death_occupancy(lam, death_rates_slowest_first(job_servers), nu)


def response_time_bounds(job_servers: JobServers, lam: float) -> Tuple[float, float]:
    """(lower, upper) bounds on steady-state mean response time (Thm 3.7 +
    Little's law)."""
    lo = occupancy_lower_bound(job_servers, lam) / lam
    hi = occupancy_upper_bound(job_servers, lam) / lam
    return lo, hi


def is_stable(job_servers: JobServers, lam: float) -> bool:
    """Lemma 3.6: ergodic iff lam < nu."""
    return lam < total_rate(job_servers)


# ---------------------------------------------------------------------------
# Exact analysis
# ---------------------------------------------------------------------------

def exact_occupancy_k2(mu1: float, c1: int, mu2: float, c2: int, lam: float) -> float:
    """Exact steady-state mean occupancy for K = 2 chains (Appendix A.3).

    Implements the recursion (38)-(44): coefficients alpha_z = pi_z / pi_{0,0,c2}.
    """
    if mu1 < mu2:
        raise ValueError("chain 1 must be the fastest")
    nu = c1 * mu1 + c2 * mu2
    if lam >= nu:
        return math.inf
    # alpha[z1][z2] for queue-empty states.
    alpha = np.zeros((c1 + 1, c2 + 1))
    alpha[0, c2] = 1.0
    # (38): states (0, n, c2)
    for n in range(1, c1 + 1):
        alpha[n, c2] = (
            c2 * mu2 * alpha[: n, c2].sum() + lam * alpha[n - 1, c2]
        ) / (n * mu1)
    # Sweep z2 = c2-1 .. 0 via (40)-(44).
    for z2 in range(c2 - 1, -1, -1):
        up = alpha[:, z2 + 1]
        # (40): alpha_{0,c1,z2}
        alpha[c1, z2] = (z2 + 1) * mu2 / lam * up.sum()
        # alpha_{0,n,z2} = beta_n * alpha_{0,0,z2} + gamma_n  via (42)-(43)
        beta = np.zeros(c1 + 1)
        gamma = np.zeros(c1 + 1)
        beta[0] = 1.0
        for n in range(1, c1 + 1):
            beta[n] = (z2 * mu2 * beta[:n].sum() + lam * beta[n - 1]) / (n * mu1)
            gamma[n] = (
                z2 * mu2 * gamma[:n].sum()
                + lam * gamma[n - 1]
                - (z2 + 1) * mu2 * up[:n].sum()
            ) / (n * mu1)
        # (44)
        a00 = (alpha[c1, z2] - gamma[c1]) / beta[c1]
        alpha[0, z2] = a00
        for n in range(1, c1):
            alpha[n, z2] = beta[n] * a00 + gamma[n]
    # Queue states (n, c1, c2): alpha = (lam/nu)^n alpha_{0,c1,c2}  (39)
    r = lam / nu
    a_full = alpha[c1, c2]
    # Sums over Z: occupancy-weighted and plain.
    z1g, z2g = np.meshgrid(np.arange(c1 + 1), np.arange(c2 + 1), indexing="ij")
    s_plain = alpha.sum() + a_full * r / (1 - r)
    s_occ = (alpha * (z1g + z2g)).sum() + a_full * (
        r / (1 - r) * (c1 + c2) + r / (1 - r) ** 2
    )
    return float(s_occ / s_plain)


def exact_occupancy_ctmc(
    job_servers: JobServers, lam: float, queue_cap: int = 4000
) -> float:
    """Exact mean occupancy by solving the full CTMC with the central queue
    truncated at ``queue_cap`` (numerical ground truth for small systems)."""
    mus, caps = _validate(job_servers, lam)
    K = len(mus)
    nu = total_rate(job_servers)
    if lam >= nu:
        return math.inf
    # Enumerate states: (q, z_1..z_K) with q > 0 only when all z_l = c_l.
    states: List[Tuple[int, Tuple[int, ...]]] = []
    index: Dict[Tuple[int, Tuple[int, ...]], int] = {}

    def add(state):
        if state not in index:
            index[state] = len(states)
            states.append(state)

    def rec(l, z):
        if l == K:
            add((0, tuple(z)))
            return
        for v in range(caps[l] + 1):
            rec(l + 1, z + [v])

    rec(0, [])
    full = tuple(caps)
    for q in range(1, queue_cap + 1):
        add((q, full))
    n = len(states)
    Q = np.zeros((n, n))

    def jffc_target(z):
        for l in range(K):
            if z[l] < caps[l]:
                return l
        return None

    for (q, z), i in index.items():
        # arrival
        tgt = jffc_target(z)
        if q == 0 and tgt is not None:
            z2 = list(z)
            z2[tgt] += 1
            j = index[(0, tuple(z2))]
            Q[i, j] += lam
        else:
            if q + 1 <= queue_cap:
                j = index[(q + 1, z)]
                Q[i, j] += lam
            # else: truncated (reflecting) — fine for lam << nu
        # departures
        if q == 0:
            for l in range(K):
                if z[l] > 0:
                    z2 = list(z)
                    z2[l] -= 1
                    j = index[(0, tuple(z2))]
                    Q[i, j] += z[l] * mus[l]
        else:
            # all chains full; a departure immediately pulls a queued job
            j = index[(q - 1, z)]
            Q[i, j] += nu
    np.fill_diagonal(Q, -Q.sum(axis=1))
    # Solve pi Q = 0, sum pi = 1.
    A = np.vstack([Q.T, np.ones(n)])
    b = np.zeros(n + 1)
    b[-1] = 1.0
    pi, *_ = np.linalg.lstsq(A, b, rcond=None)
    pi = np.clip(pi, 0.0, None)
    pi /= pi.sum()
    occ = 0.0
    for (q, z), i in index.items():
        occ += pi[i] * (q + sum(z))
    return float(occ)

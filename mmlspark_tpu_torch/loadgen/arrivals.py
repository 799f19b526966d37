"""Open-loop arrival processes: *when* requests fire, decoupled from the
server's replies.

Closed-loop benches (send → wait → send) let a slow server throttle its
own load generator, so queueing collapse hides from the latency numbers —
the coordinated-omission trap. Everything here is open-loop: an arrival
process stamps each request with its *scheduled* send time up front, and
the scorecard measures latency from that intended instant, not from
whenever the sender thread actually got around to writing bytes.

Three seeded samplers compose into a scenario's traffic shape:

* :func:`poisson_offsets` — homogeneous Poisson (exponential
  interarrivals), the memoryless baseline.
* :func:`diurnal_offsets` — inhomogeneous Poisson with a sinusoidal rate
  envelope (Lewis–Shedler thinning), the day/night load swing compressed
  into a test-sized window.
* :func:`heavy_tail_rows` — Pareto request sizes (median-parameterized),
  because production payloads are not uniform batches.

:class:`TenantMix` assigns each arrival a tenant by configured weight and
a Zipf-skewed shared-prefix key (the ``X-Mmlspark-Prefix`` affinity
header), so prefix-cache routing sees realistic hot/cold skew. All
randomness flows through one ``random.Random(seed)`` — a (seed, config)
pair always yields the identical plan.

The port's copy of ``mmlspark_tpu/loadgen/arrivals.py``.
"""

from __future__ import annotations

import bisect
import math
import random
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

__all__ = ["Arrival", "TenantMix", "diurnal_offsets", "heavy_tail_rows",
           "interarrivals", "poisson_offsets", "weighted_choice"]


@dataclass(frozen=True)
class Arrival:
    """One planned request: everything known before any byte is sent."""

    index: int
    #: scheduled send offset in seconds from scenario start — latency is
    #: measured FROM here (coordinated-omission correction)
    at: float
    tenant: str
    workload: str          # "vision" | "generation" | "gbdt"
    rows: int              # heavy-tailed request size
    #: X-Mmlspark-Prefix affinity key, None for an unkeyed request
    prefix: Optional[str]


def poisson_offsets(rate: float, duration_s: float,
                    rng: random.Random) -> List[float]:
    """Homogeneous Poisson arrival offsets over ``[0, duration_s)``.

    Interarrivals are iid Exponential(rate): mean ``1/rate``, variance
    ``1/rate**2`` — the properties tests pin down.
    """
    if rate <= 0 or duration_s <= 0:
        return []
    out: List[float] = []
    t = 0.0
    while True:
        t += rng.expovariate(rate)
        if t >= duration_s:
            return out
        out.append(t)


def diurnal_offsets(rate: float, duration_s: float, rng: random.Random,
                    period_s: Optional[float] = None,
                    depth: float = 0.5) -> List[float]:
    """Inhomogeneous Poisson with a sinusoidal "diurnal" envelope.

    Instantaneous rate ``rate * (1 + depth * sin(2*pi*t/period_s))``,
    sampled by Lewis–Shedler thinning against the peak rate: candidates
    arrive at the peak rate and are accepted with probability
    ``rate(t)/peak``, which is exact for any bounded envelope. With the
    default ``period_s == duration_s`` the first half of the window is
    the "day" (above-mean rate) and the second half the "night".
    """
    if rate <= 0 or duration_s <= 0:
        return []
    period = period_s if period_s and period_s > 0 else duration_s
    depth = min(max(float(depth), 0.0), 1.0)
    peak = rate * (1.0 + depth)
    out: List[float] = []
    t = 0.0
    while True:
        t += rng.expovariate(peak)
        if t >= duration_s:
            return out
        lam = rate * (1.0 + depth * math.sin(2.0 * math.pi * t / period))
        if rng.random() * peak <= lam:
            out.append(t)


def interarrivals(offsets: Sequence[float]) -> List[float]:
    """Gaps between consecutive offsets (first gap measured from 0)."""
    prev = 0.0
    out: List[float] = []
    for t in offsets:
        out.append(t - prev)
        prev = t
    return out


def heavy_tail_rows(rng: random.Random, median: int = 8,
                    alpha: float = 1.6, cap: int = 4096) -> int:
    """Pareto-distributed request size (rows), parameterized by its median.

    ``P(X > x) = (xm / x) ** alpha`` with ``xm`` chosen so the median is
    ``median``; ``alpha`` in (1, 2] gives the finite-mean, infinite-ish
    variance shape real payload mixes show. Capped at ``cap`` so one
    sample cannot blow a test's memory or wall-clock.
    """
    alpha = max(float(alpha), 0.1)
    xm = float(median) / (2.0 ** (1.0 / alpha))
    u = max(rng.random(), 1e-12)
    x = xm / (u ** (1.0 / alpha))
    return max(1, min(int(math.ceil(x)), int(cap)))


def weighted_choice(rng: random.Random,
                    items: Sequence[Tuple[str, float]]) -> str:
    """One weighted draw over ``(name, weight)`` pairs (no numpy)."""
    total = sum(max(w, 0.0) for _, w in items)
    if total <= 0:
        return items[0][0]
    r = rng.random() * total
    acc = 0.0
    for name, w in items:
        acc += max(w, 0.0)
        if r <= acc:
            return name
    return items[-1][0]


class TenantMix:
    """Weighted multi-tenant mix with Zipf-skewed prefix sharing.

    Each arrival draws a tenant proportional to ``weights`` and, with
    probability ``keyed_fraction``, a shared-prefix key from that
    tenant's pool of ``prefix_pool`` keys under a Zipf(``prefix_skew``)
    rank distribution — rank 1 is the hot system prompt everyone shares,
    the tail is long. The key value is deterministic
    (``"{tenant}-p{rank}"``) so affinity routing and the KV pool see the
    same hot keys across runs.
    """

    def __init__(self, weights: Dict[str, float], prefix_pool: int = 4,
                 prefix_skew: float = 1.1, keyed_fraction: float = 0.75):
        if not weights:
            weights = {"default": 1.0}
        self.weights = {str(t): float(w) for t, w in weights.items()}
        self._items = sorted(self.weights.items())
        self.keyed_fraction = min(max(float(keyed_fraction), 0.0), 1.0)
        n = max(int(prefix_pool), 1)
        ranks = [1.0 / (r ** float(prefix_skew)) for r in range(1, n + 1)]
        total = sum(ranks)
        cum, acc = [], 0.0
        for w in ranks:
            acc += w / total
            cum.append(acc)
        self._prefix_cum = cum

    def pick(self, rng: random.Random) -> Tuple[str, Optional[str]]:
        """Draw ``(tenant, prefix-or-None)`` for one arrival."""
        tenant = weighted_choice(rng, self._items)
        if rng.random() >= self.keyed_fraction:
            return tenant, None
        rank = bisect.bisect_left(self._prefix_cum, rng.random()) + 1
        rank = min(rank, len(self._prefix_cum))
        return tenant, f"{tenant}-p{rank}"

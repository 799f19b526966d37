"""Tree-structured Parzen Estimator — adaptive hyperparameter proposals.

Beyond the reference's random/grid search (``TuneHyperparameters.scala``):
TPE models the observed trials as two densities — l(x) over the top
``gamma`` fraction by metric, g(x) over the rest — and proposes the
candidate maximizing l(x)/g(x), concentrating trials near what already
works. Dimensions are treated independently (the standard TPE
simplification): continuous/log/int ranges get a Parzen (Gaussian-KDE)
density in their transformed space, categoricals a smoothed count ratio.

Used by ``TuneHyperparameters(search_strategy='tpe')``; proposals come in
batches of ``parallelism`` so trial evaluation keeps its thread pool.

The port's copy of ``mmlspark_tpu/automl/tpe.py`` (numpy streams only;
the same seed and the same ``tell`` calls propose the same maps).
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

from .hyperparam import DiscreteHyperParam, RangeHyperParam

__all__ = ["TPESampler"]


class _ContinuousDim:
    def __init__(self, hp: RangeHyperParam):
        self.hp = hp
        self.lo, self.hi = float(hp.low), float(hp.high)
        if hp.is_log:
            self.lo, self.hi = np.log(self.lo), np.log(self.hi)

    def transform(self, v) -> float:
        v = float(v)
        return float(np.log(v)) if self.hp.is_log else v

    def restore(self, t: float):
        v = float(np.exp(t)) if self.hp.is_log else float(t)
        v = min(max(v, float(self.hp.low)), float(self.hp.high))
        return int(round(v)) if self.hp.is_int else v

    def _kde(self, pts: np.ndarray):
        # Parzen with Scott-like bandwidth, floored so single/identical
        # points still propose a usable neighborhood
        bw = max(np.std(pts) * (len(pts) ** -0.2), (self.hi - self.lo) / 20,
                 1e-12)

        def sample(rng, n):
            centers = rng.choice(pts, size=n)
            return np.clip(centers + rng.normal(0, bw, n), self.lo, self.hi)

        def logpdf(x):
            d = (x[:, None] - pts[None, :]) / bw
            return np.log(np.mean(np.exp(-0.5 * d * d), axis=1)
                          / (bw * np.sqrt(2 * np.pi)) + 1e-300)

        return sample, logpdf

    def propose(self, rng, good: Sequence, bad: Sequence, n_cand: int):
        if not good or not bad:
            return self.restore(rng.uniform(self.lo, self.hi))
        g_pts = np.asarray([self.transform(v) for v in good])
        b_pts = np.asarray([self.transform(v) for v in bad])
        l_sample, l_logpdf = self._kde(g_pts)
        _, g_logpdf = self._kde(b_pts)
        cand = l_sample(rng, n_cand)
        best = cand[np.argmax(l_logpdf(cand) - g_logpdf(cand))]
        return self.restore(best)


class _CategoricalDim:
    def __init__(self, hp: DiscreteHyperParam):
        self.values = list(hp.values)

    def propose(self, rng, good: Sequence, bad: Sequence, n_cand: int):
        idx = {self._key(v): i for i, v in enumerate(self.values)}
        gc = np.ones(len(self.values))          # +1 smoothing
        bc = np.ones(len(self.values))
        for v in good:
            gc[idx[self._key(v)]] += 1
        for v in bad:
            bc[idx[self._key(v)]] += 1
        ratio = (gc / gc.sum()) / (bc / bc.sum())
        p = ratio / ratio.sum()
        return self.values[rng.choice(len(self.values), p=p)]

    @staticmethod
    def _key(v):
        return v if not isinstance(v, (list, dict)) else repr(v)


class TPESampler:
    """Propose parameter maps adaptively from observed (params, metric)
    trials. ``tell()`` records results; ``propose(k)`` returns the next k
    maps (random until ``n_startup`` trials exist)."""

    def __init__(self, space: Dict[str, object], seed: int = 0,
                 gamma: float = 0.25, n_startup: int = 5,
                 n_ei_candidates: int = 24, maximize: bool = True):
        if not 0.0 < gamma < 1.0:
            raise ValueError(f"gamma must be in (0, 1), got {gamma}")
        self.space = space
        self.dims = {}
        for name, hp in space.items():
            if isinstance(hp, RangeHyperParam):
                self.dims[name] = _ContinuousDim(hp)
            elif isinstance(hp, DiscreteHyperParam):
                self.dims[name] = _CategoricalDim(hp)
            else:
                raise ValueError(f"unsupported hyperparam type for "
                                 f"{name!r}: {type(hp).__name__}")
        self.rng = np.random.default_rng(seed)
        self.gamma = float(gamma)
        self.n_startup = int(n_startup)
        self.n_cand = int(n_ei_candidates)
        self.maximize = bool(maximize)
        self.trials: List[Tuple[dict, float]] = []

    def tell(self, params: dict, metric: float) -> None:
        self.trials.append((dict(params), float(metric)))

    def _split(self):
        scores = np.asarray([m for _p, m in self.trials])
        order = np.argsort(-scores if self.maximize else scores)
        n_good = max(1, int(np.ceil(self.gamma * len(order))))
        good = [self.trials[i][0] for i in order[:n_good]]
        bad = [self.trials[i][0] for i in order[n_good:]]
        return good, bad

    def _random_map(self) -> dict:
        return {k: hp.sample(self.rng) for k, hp in self.space.items()}

    def propose(self, k: int = 1) -> List[dict]:
        out = []
        for _ in range(k):
            if len(self.trials) < self.n_startup:
                out.append(self._random_map())
                continue
            good, bad = self._split()
            if not bad:
                out.append(self._random_map())
                continue
            pm = {name: dim.propose(self.rng,
                                    [g[name] for g in good],
                                    [b[name] for b in bad],
                                    self.n_cand)
                  for name, dim in self.dims.items()}
            out.append(pm)
        return out

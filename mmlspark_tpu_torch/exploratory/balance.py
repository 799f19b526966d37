"""Data balance analysis (Responsible AI).

Parity surface: ``FeatureBalanceMeasure:38``, ``DistributionBalanceMeasure:38``,
``AggregateBalanceMeasure:30`` (reference ``core/.../exploratory/*.scala``):
fairness/association measures between sensitive-feature values and labels,
per-feature distribution distances vs a uniform reference, and aggregate
inequality indices.

The port's copy of ``mmlspark_tpu/exploratory/balance.py`` (numpy only,
host work).
"""

from __future__ import annotations

import itertools
from typing import Dict

import numpy as np

from ..core.dataframe import DataFrame
from ..core.params import HasLabelCol, Param
from ..core.pipeline import Transformer

__all__ = ["FeatureBalanceMeasure", "DistributionBalanceMeasure",
           "AggregateBalanceMeasure"]


class FeatureBalanceMeasure(Transformer, HasLabelCol):
    """Pairwise association gaps between values of each sensitive column."""

    sensitive_cols = Param((list, str), default=[], doc="sensitive columns")
    verbose = Param(bool, default=False, doc="parity flag")

    def _transform(self, df: DataFrame) -> DataFrame:
        y = df[self.get("label_col")].astype(np.float64)
        pos = y == 1
        n = len(df)
        p_pos = pos.mean() if n else 0.0
        rows = []
        for col in self.get("sensitive_cols"):
            vals = df[col]
            uniq = sorted({v.item() if isinstance(v, np.generic) else v
                           for v in vals}, key=str)
            stats: Dict = {}
            for v in uniq:
                mask = np.asarray([x == v for x in vals])
                p_a = mask.mean()
                p_pos_a = (mask & pos).mean()
                p_pos_given_a = p_pos_a / p_a if p_a else 0.0
                stats[v] = (p_a, p_pos_a, p_pos_given_a)
            for a, b in itertools.combinations(uniq, 2):
                pa, ppa, ppga = stats[a]
                pb, ppb, ppgb = stats[b]
                def _pmi(pp, p):
                    return np.log(pp / (p * p_pos)) if pp > 0 and p > 0 \
                        and p_pos > 0 else float("-inf")
                rows.append({
                    "FeatureName": col, "ClassA": a, "ClassB": b,
                    "dp": ppga - ppgb,                      # statistical parity
                    "pmi": _pmi(ppa, pa) - _pmi(ppb, pb),   # pointwise MI gap
                    "sdc": ppa / (pa + p_pos) - ppb / (pb + p_pos),
                    "ji": ppa / (pa + p_pos - ppa) - ppb / (pb + p_pos - ppb),
                    "krc": _krc(pa, ppa, p_pos, n) - _krc(pb, ppb, p_pos, n),
                    "llr": (np.log(ppa / p_pos) if ppa > 0 else float("-inf"))
                           - (np.log(ppb / p_pos) if ppb > 0 else float("-inf")),
                })
        return DataFrame.from_rows(rows)


def _krc(p_a, p_pos_a, p_pos, n) -> float:
    """Kendall rank correlation term (reference FeatureBalanceMeasure)."""
    if n == 0 or p_a in (0.0, 1.0):
        return 0.0
    a = p_pos_a
    b = p_a - p_pos_a          # feature, not label
    c = p_pos - p_pos_a        # label, not feature
    d = 1.0 - p_a - c          # neither
    denom = np.sqrt((a + b) * (c + d) * (a + c) * (b + d))
    return float((a * d - b * c) / denom) if denom else 0.0


class DistributionBalanceMeasure(Transformer):
    """Per-column distribution distances vs the uniform reference."""

    sensitive_cols = Param((list, str), default=[], doc="columns to measure")

    def _transform(self, df: DataFrame) -> DataFrame:
        rows = []
        n = len(df)
        for col in self.get("sensitive_cols"):
            vals = df[col]
            uniq, counts = np.unique(vals, return_counts=True)
            p = counts / n
            k = len(uniq)
            ref = np.full(k, 1.0 / k)
            with np.errstate(divide="ignore", invalid="ignore"):
                kl = float(np.sum(p * np.log(p / ref)))
            m = 0.5 * (p + ref)
            js = float(0.5 * np.sum(p * np.log(p / m))
                       + 0.5 * np.sum(ref * np.log(ref / m)))
            chi2 = float(n * np.sum((p - ref) ** 2 / ref))
            rows.append({
                "FeatureName": col,
                "kl_divergence": kl,
                "js_dist": float(np.sqrt(js)),
                "inf_norm_dist": float(np.abs(p - ref).max()),
                "total_variation_dist": float(0.5 * np.abs(p - ref).sum()),
                "wasserstein_dist": float(np.abs(np.cumsum(p) -
                                                 np.cumsum(ref)).mean()),
                "chi_sq_stat": chi2,
            })
        return DataFrame.from_rows(rows)


class AggregateBalanceMeasure(Transformer):
    """Inequality indices over the joint sensitive-feature distribution."""

    sensitive_cols = Param((list, str), default=[], doc="columns to combine")
    epsilon = Param(float, default=1.0, doc="Atkinson inequality aversion")

    def _transform(self, df: DataFrame) -> DataFrame:
        cols = self.get("sensitive_cols")
        combos = list(zip(*(df[c] for c in cols)))
        _, counts = np.unique([str(c) for c in combos], return_counts=True)
        p = counts / counts.sum()
        k = len(p)
        mu = 1.0 / k
        eps = self.get("epsilon")
        if eps == 1.0:
            atkinson = 1.0 - np.power(np.prod(p / mu), 1.0 / k)
        else:
            atkinson = 1.0 - np.power(
                np.mean(np.power(p / mu, 1.0 - eps)), 1.0 / (1.0 - eps))
        theil_t = float(np.sum((p / mu) * np.log(p / mu)) / k)
        theil_l = float(np.sum(np.log(mu / p)) / k)
        return DataFrame.from_rows([{
            "atkinson_index": float(atkinson),
            "theil_t_index": theil_t,
            "theil_l_index": theil_l,
        }])

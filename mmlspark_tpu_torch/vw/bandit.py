"""Contextual bandit learner on hashed features.

Parity surface: ``VowpalWabbitContextualBandit``
(``vw/.../VowpalWabbitContextualBandit.scala``, 376 LoC): per-example action
sets with shared features, a chosen action (1-based), its observed cost and
logging probability; cost-sensitive learning with IPS or importance-weighted
regression ("mtr"-style) estimators; parallel ``fitMultiple`` for param
sweeps.

Design: each (shared, action) pair is crossed with the FNV interaction hash —
the same namespace-crossing VW performs for ``--cb_explore_adf`` — and a cost
regressor is trained on the chosen action's crossed features with importance
weight 1/p (clipped). Prediction scores every action and returns the
argmin-cost action plus an epsilon-greedy pmf.

The port's copy of ``mmlspark_tpu/vw/bandit.py``: the crossing stays on
the host (uint32 masks, as the JAX package computes it); the cost
regressor trains on the estimator's device, and prediction scores every
row's actions in one gather-dot there (the JAX package scores each row
in numpy), then picks on the host.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import List, Sequence

import numpy as np
import torch

from ..core.dataframe import DataFrame
from ..core.params import ComplexParam, HasLabelCol, Param
from ..core.pipeline import Estimator, Model
from ..utils.device import OnDevice
from .featurizer import NUM_BITS_KEY, sparse_column
from .learners import VowpalWabbitRegressor, pad_sparse
from .murmur import combine_hashes

__all__ = ["VowpalWabbitContextualBandit", "VowpalWabbitContextualBanditModel"]


def _cross(shared, action, mask: int):
    """Cross shared-namespace features with one action's features."""
    si, sv = np.asarray(shared[0], np.uint32), np.asarray(shared[1], np.float32)
    ai, av = np.asarray(action[0], np.uint32), np.asarray(action[1], np.float32)
    if len(si) == 0:
        return ai & np.uint32(mask), av
    if len(ai) == 0:
        return si & np.uint32(mask), sv
    ia = np.repeat(si, len(ai))
    ib = np.tile(ai, len(si))
    idx = combine_hashes(ia, ib, mask)
    val = np.repeat(sv, len(av)) * np.tile(av, len(sv))
    # keep the raw action features too, as VW's ADF examples carry both the
    # action namespace and its interaction with the shared namespace
    return (np.concatenate([ai & np.uint32(mask), idx]),
            np.concatenate([av, val]))


class VowpalWabbitContextualBandit(OnDevice, Estimator, HasLabelCol):
    """Learn action costs from logged bandit feedback."""

    shared_col = Param(str, default="shared", doc="shared-features column "
                                                  "((indices, values) rows)")
    features_col = Param(str, default="features",
                         doc="per-action features column: each row is a list "
                             "of (indices, values), one per action")
    chosen_action_col = Param(str, default="chosenAction",
                              doc="1-based index of the logged action")
    probability_col = Param(str, default="probability",
                            doc="logging probability of the chosen action")
    cb_type = Param(str, default="ips", choices=["ips", "mtr"],
                    doc="cost estimator: inverse-propensity-scaled regression "
                        "(ips) or plain importance-weighted regression (mtr)")
    epsilon = Param(float, default=0.05, doc="exploration for the output pmf")
    prob_clip = Param(float, default=0.05,
                      doc="lower clip on logging probabilities (caps IPS "
                          "importance weights)")
    num_bits = Param(int, default=18, doc="log2 weight-space size")
    num_passes = Param(int, default=1, doc="passes over the data")
    learning_rate = Param(float, default=0.5, doc="base learning rate")
    l1 = Param(float, default=0.0, doc="L1 regularization")
    l2 = Param(float, default=0.0, doc="L2 regularization")
    mini_batch = Param(int, default=64, doc="rows per device update step")

    def _num_bits(self, df: DataFrame) -> int:
        meta = df.column_metadata(self.get("features_col"))
        return int(meta.get(NUM_BITS_KEY, self.get("num_bits")))

    def _fit(self, df: DataFrame) -> "VowpalWabbitContextualBanditModel":
        bits = self._num_bits(df)
        mask = (1 << bits) - 1
        shared = df[self.get("shared_col")]
        actions = df[self.get("features_col")]
        chosen = np.asarray(df[self.get("chosen_action_col")], dtype=np.int64)
        cost = np.asarray(df[self.get("label_col")], dtype=np.float32)
        prob = np.asarray(df[self.get("probability_col")], dtype=np.float32)

        rows = []
        weights = []
        clip = self.get("prob_clip")
        for r in range(len(df)):
            acts = actions[r]
            if len(acts) == 0:
                raise ValueError(f"row {r}: empty action list")
            c = int(chosen[r])
            if not 1 <= c <= len(acts):
                raise ValueError(
                    f"row {r}: chosen_action {c} out of range 1..{len(acts)} "
                    "(VW actions are 1-based)")
            a = acts[c - 1]                          # 1-based (VW convention)
            rows.append(_cross(shared[r], a, mask))
            if self.get("cb_type") == "ips":
                weights.append(1.0 / max(float(prob[r]), clip))
            else:                                     # mtr: plain IW regression
                weights.append(1.0)

        train_df = DataFrame({
            "features": sparse_column(rows),
            "cost": cost,
            "iw": np.asarray(weights, dtype=np.float32),
        }).with_column_metadata("features", {NUM_BITS_KEY: bits})

        reg = VowpalWabbitRegressor(
            device=self.device, features_col="features", label_col="cost", weight_col="iw",
            num_passes=self.get("num_passes"),
            learning_rate=self.get("learning_rate"),
            l1=self.get("l1"), l2=self.get("l2"),
            mini_batch=self.get("mini_batch"), num_bits=bits)
        inner = reg.fit(train_df)

        m = VowpalWabbitContextualBanditModel(device=self.device)
        m.set(shared_col=self.get("shared_col"),
              features_col=self.get("features_col"),
              epsilon=self.get("epsilon"),
              weights=np.asarray(inner.get("weights")), num_bits=bits)
        m.performance_statistics = inner.performance_statistics
        return m

    def fit_multiple(self, df: DataFrame, param_maps: Sequence[dict]) -> List[Model]:
        """Parallel multi-model fit (parity:
        ``VowpalWabbitContextualBandit.fitMultiple``): threads that share
        the estimator's device."""
        with ThreadPoolExecutor(max_workers=min(4, max(1, len(param_maps)))) as ex:
            return list(ex.map(lambda m: self.fit(df, dict(m)), param_maps))


class VowpalWabbitContextualBanditModel(OnDevice, Model):
    shared_col = Param(str, default="shared", doc="shared-features column")
    features_col = Param(str, default="features", doc="per-action features column")
    prediction_col = Param(str, default="prediction",
                           doc="output: argmin-cost action (1-based)")
    scores_col = Param(str, default="scores", doc="output: per-action costs")
    pmf_col = Param(str, default="pmf", doc="output: epsilon-greedy action pmf")
    epsilon = Param(float, default=0.05, doc="exploration mass")
    weights = ComplexParam(default=None, doc="hashed weight vector")
    num_bits = Param(int, default=18, doc="log2 weight-space size")

    def _transform(self, df: DataFrame) -> DataFrame:
        mask = (1 << self.get("num_bits")) - 1
        shared = df[self.get("shared_col")]
        actions = df[self.get("features_col")]
        eps = self.get("epsilon")
        crossed, counts = [], []
        for r in range(len(df)):
            if len(actions[r]) == 0:
                raise ValueError(f"row {r}: empty action list")
            crossed += [_cross(shared[r], a, mask) for a in actions[r]]
            counts.append(len(actions[r]))
        # every row's actions in one gather-dot on the device
        dev = self.device
        idx, val = pad_sparse(sparse_column(crossed))
        w = torch.from_numpy(np.asarray(self.get("weights"),
                                        np.float32)).to(dev)
        with torch.no_grad():
            flat = (w[torch.from_numpy(idx).to(dev).long()]
                    * torch.from_numpy(val).to(dev)).sum(dim=1).cpu().numpy()
        pred = np.zeros(len(df), dtype=np.int64)
        scores_col = np.empty(len(df), dtype=object)
        pmf_col = np.empty(len(df), dtype=object)
        start = 0
        for r, k in enumerate(counts):
            scores = flat[start:start + k]
            start += k
            best = int(scores.argmin())
            pmf = np.full(k, eps / k)
            pmf[best] += 1.0 - eps
            pred[r] = best + 1
            scores_col[r] = scores.astype(np.float32)
            pmf_col[r] = pmf.astype(np.float32)
        return (df.with_column(self.get("prediction_col"), pred)
                  .with_column(self.get("scores_col"), scores_col)
                  .with_column(self.get("pmf_col"), pmf_col))

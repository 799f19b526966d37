"""Ranking evaluation & tuning.

Parity surface: ``RecommendationIndexer:18`` (string ids → dense indices),
``RankingEvaluator:100`` (NDCG@k, MAP@k, precision@k, recall@k),
``RankingAdapter:69`` (learner → per-user top-k lists),
``RankingTrainValidationSplit:25`` (reference
``core/.../recommendation/*.scala``).

The port's copy of ``mmlspark_tpu/recommendation/ranking.py`` (numpy
only; the recommender it adapts runs on its own device).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

from ..core.dataframe import DataFrame
from ..core.params import ComplexParam, Param
from ..core.pipeline import Estimator, Model, Transformer

__all__ = ["RecommendationIndexer", "RecommendationIndexerModel",
           "RankingEvaluator", "RankingAdapter", "RankingTrainValidationSplit"]


class RecommendationIndexer(Estimator):
    user_input_col = Param(str, default="user", doc="raw user id column")
    user_output_col = Param(str, default="user_idx", doc="indexed user column")
    item_input_col = Param(str, default="item", doc="raw item id column")
    item_output_col = Param(str, default="item_idx", doc="indexed item column")

    def _fit(self, df: DataFrame) -> "RecommendationIndexerModel":
        def levels(col):
            return sorted({v.item() if isinstance(v, np.generic) else v
                           for v in col}, key=str)
        m = RecommendationIndexerModel()
        m.set(user_input_col=self.get("user_input_col"),
              user_output_col=self.get("user_output_col"),
              item_input_col=self.get("item_input_col"),
              item_output_col=self.get("item_output_col"),
              user_levels=levels(df[self.get("user_input_col")]),
              item_levels=levels(df[self.get("item_input_col")]))
        return m


class RecommendationIndexerModel(Model):
    user_input_col = Param(str, default="user", doc="raw user id column")
    user_output_col = Param(str, default="user_idx", doc="indexed user column")
    item_input_col = Param(str, default="item", doc="raw item id column")
    item_output_col = Param(str, default="item_idx", doc="indexed item column")
    user_levels = Param(list, default=[], doc="user values by index")
    item_levels = Param(list, default=[], doc="item values by index")

    def _transform(self, df: DataFrame) -> DataFrame:
        out = df
        for inp, outp, lv in ((self.get("user_input_col"),
                               self.get("user_output_col"),
                               self.get("user_levels")),
                              (self.get("item_input_col"),
                               self.get("item_output_col"),
                               self.get("item_levels"))):
            table = {v: i for i, v in enumerate(lv)}
            idx = np.asarray([table[v.item() if isinstance(v, np.generic)
                                    else v] for v in df[inp]], dtype=np.int64)
            out = out.with_column(outp, idx)
        return out

    def recover_user(self, idx: int):
        return self.get("user_levels")[idx]

    def recover_item(self, idx: int):
        return self.get("item_levels")[idx]


def _ndcg_at_k(pred: Sequence, truth: Sequence, k: int) -> float:
    truth_set = set(truth)
    dcg = sum(1.0 / np.log2(i + 2) for i, p in enumerate(pred[:k])
              if p in truth_set)
    idcg = sum(1.0 / np.log2(i + 2) for i in range(min(k, len(truth_set))))
    return dcg / idcg if idcg else 0.0


def _map_at_k(pred: Sequence, truth: Sequence, k: int) -> float:
    truth_set = set(truth)
    if not truth_set:
        return 0.0
    hits, score = 0, 0.0
    for i, p in enumerate(pred[:k]):
        if p in truth_set:
            hits += 1
            score += hits / (i + 1.0)
    return score / min(len(truth_set), k)


class RankingEvaluator(Transformer):
    """Consumes a frame with per-user prediction lists and truth lists."""

    k = Param(int, default=10, doc="cutoff")
    prediction_col = Param(str, default="recommendations",
                           doc="per-user predicted item list")
    label_col = Param(str, default="labels", doc="per-user relevant item list")
    metric_name = Param(str, default="ndcgAt",
                        choices=["ndcgAt", "map", "precisionAtk", "recallAtK"],
                        doc="headline metric")

    def evaluate(self, df: DataFrame) -> float:
        row = self._transform(df)
        return float(row[self.get("metric_name")][0])

    def _transform(self, df: DataFrame) -> DataFrame:
        k = self.get("k")
        preds = df[self.get("prediction_col")]
        truths = df[self.get("label_col")]
        ndcg, maps, precs, recs = [], [], [], []
        for p, t in zip(preds, truths):
            p, t = list(p), list(t)
            ndcg.append(_ndcg_at_k(p, t, k))
            maps.append(_map_at_k(p, t, k))
            hits = len(set(p[:k]) & set(t))
            precs.append(hits / float(k))
            recs.append(hits / float(len(t)) if t else 0.0)
        return DataFrame.from_rows([{
            "ndcgAt": float(np.mean(ndcg)) if ndcg else 0.0,
            "map": float(np.mean(maps)) if maps else 0.0,
            "precisionAtk": float(np.mean(precs)) if precs else 0.0,
            "recallAtK": float(np.mean(recs)) if recs else 0.0,
        }])


class RankingAdapter(Estimator):
    """Fit a recommender and emit per-user top-k lists next to the ground
    truth, ready for RankingEvaluator (reference ``RankingAdapter.scala:69``)."""

    recommender = ComplexParam(default=None, doc="estimator producing a model "
                               "with recommend_for_all_users")
    k = Param(int, default=10, doc="items per user")
    user_col = Param(str, default="user", doc="user id column")
    item_col = Param(str, default="item", doc="item id column")

    def _fit(self, df: DataFrame) -> "RankingAdapterModel":
        model = self.get("recommender").fit(df)
        m = RankingAdapterModel()
        m.set(recommender_model=model, k=self.get("k"),
              user_col=self.get("user_col"), item_col=self.get("item_col"))
        return m


class RankingAdapterModel(Model):
    recommender_model = ComplexParam(default=None, doc="fitted recommender")
    k = Param(int, default=10, doc="items per user")
    user_col = Param(str, default="user", doc="user id column")
    item_col = Param(str, default="item", doc="item id column")

    def _transform(self, df: DataFrame) -> DataFrame:
        recs = self.get("recommender_model").recommend_for_all_users(
            self.get("k"))
        rec_map = dict(zip(recs[self.get("user_col")],
                           recs["recommendations"]))
        users = df[self.get("user_col")].astype(np.int64)
        items = df[self.get("item_col")]
        truth: Dict[int, List] = {}
        for u, i in zip(users, items):
            truth.setdefault(int(u), []).append(
                i.item() if isinstance(i, np.generic) else i)
        uniq = sorted(truth)
        out_pred = np.empty(len(uniq), dtype=object)
        out_truth = np.empty(len(uniq), dtype=object)
        for j, u in enumerate(uniq):
            out_pred[j] = list(rec_map.get(u, []))
            out_truth[j] = truth[u]
        return DataFrame({self.get("user_col"): np.asarray(uniq),
                          "recommendations": out_pred, "labels": out_truth})


class RankingTrainValidationSplit(Estimator):
    """Per-user train/validation split + evaluation of a recommender
    (reference ``RankingTrainValidationSplit.scala:25``)."""

    recommender = ComplexParam(default=None, doc="estimator to evaluate")
    train_ratio = Param(float, default=0.75, doc="per-user train fraction")
    user_col = Param(str, default="user", doc="user id column")
    item_col = Param(str, default="item", doc="item id column")
    k = Param(int, default=10, doc="evaluation cutoff")
    seed = Param(int, default=0, doc="split seed")

    validation_metrics: Optional[dict] = None

    def _fit(self, df: DataFrame) -> Model:
        rng = np.random.default_rng(self.get("seed"))
        users = df[self.get("user_col")].astype(np.int64)
        train_mask = np.zeros(len(df), dtype=bool)
        for u in np.unique(users):
            idx = np.flatnonzero(users == u)
            n_train = max(1, int(round(self.get("train_ratio") * len(idx))))
            chosen = rng.permutation(idx)[:n_train]
            train_mask[chosen] = True
        train, valid = df.filter(train_mask), df.filter(~train_mask)

        adapter = RankingAdapter(recommender=self.get("recommender"),
                                 k=self.get("k"),
                                 user_col=self.get("user_col"),
                                 item_col=self.get("item_col"))
        adapter_model = adapter.fit(train)
        ranked = adapter_model.transform(valid)
        ev = RankingEvaluator(k=self.get("k"))
        metrics = ev.transform(ranked)
        self.validation_metrics = {c: float(metrics[c][0])
                                   for c in metrics.columns}
        return adapter_model

"""Model evaluation metrics.

Parity surface: ``ComputeModelStatistics`` (reference
``core/.../train/ComputeModelStatistics.scala:59-474``: confusion matrix,
accuracy/precision/recall, AUC via ``MetricsLogger``; regression MSE/RMSE/R²/MAE)
and ``ComputePerInstanceStatistics`` (``ComputePerInstanceStatistics.scala:45``:
per-row losses). Metric math runs as vectorized array ops.

The port's copy of ``mmlspark_tpu/train/metrics.py`` (numpy only, host work).
"""

from __future__ import annotations

import numpy as np

from ..core.dataframe import DataFrame
from ..core.params import HasLabelCol, Param
from ..core.pipeline import Transformer

__all__ = ["ComputeModelStatistics", "ComputePerInstanceStatistics",
           "roc_auc", "confusion_matrix"]


def _plain(v):
    return v.item() if isinstance(v, np.generic) else v


def _class_order(df: DataFrame, scores_col: str, label_col: str,
                 y: np.ndarray, pred: np.ndarray) -> list:
    """Class values in *model* order: the label metadata a trained model
    attaches to its prediction column wins; otherwise the sorted union of
    observed labels and predictions (an eval frame may contain only a subset
    of the model's classes)."""
    from ..core.schema import get_label_metadata
    seen = {_plain(v) for v in y} | {_plain(v) for v in pred}
    for col in (scores_col, label_col):
        meta = get_label_metadata(df, col)
        if meta.get("classes"):
            classes = [_plain(c) for c in meta["classes"]]
            # tolerate labels the model never saw: append after model classes
            extras = sorted(seen - set(classes),
                            key=lambda v: (str(type(v)), v))
            return classes + extras
    return sorted(seen, key=lambda v: (str(type(v)), v))


def confusion_matrix(y_true: np.ndarray, y_pred: np.ndarray, n: int) -> np.ndarray:
    cm = np.zeros((n, n), dtype=np.int64)
    np.add.at(cm, (y_true.astype(np.int64), y_pred.astype(np.int64)), 1)
    return cm


def roc_auc(y_true: np.ndarray, scores: np.ndarray) -> float:
    """AUC by the rank statistic (equivalent to trapezoidal ROC integration)."""
    y = np.asarray(y_true).astype(bool)
    s = np.asarray(scores, dtype=np.float64)
    n_pos, n_neg = int(y.sum()), int((~y).sum())
    if n_pos == 0 or n_neg == 0:
        return float("nan")
    order = np.argsort(s, kind="mergesort")
    ranks = np.empty(len(s), dtype=np.float64)
    ranks[order] = np.arange(1, len(s) + 1)
    # tie correction: average ranks within equal scores
    sorted_s = s[order]
    i = 0
    while i < len(s):
        j = i
        while j + 1 < len(s) and sorted_s[j + 1] == sorted_s[i]:
            j += 1
        if j > i:
            ranks[order[i:j + 1]] = (i + j + 2) / 2.0
        i = j + 1
    return float((ranks[y].sum() - n_pos * (n_pos + 1) / 2) / (n_pos * n_neg))


class ComputeModelStatistics(Transformer, HasLabelCol):
    """Emit a one-row DataFrame of metrics for a scored frame."""

    scores_col = Param(str, default="prediction", doc="prediction column")
    scored_probabilities_col = Param(str, default="probability",
                                     doc="probability column (classification)")
    evaluation_metric = Param(str, default="auto",
                              choices=["auto", "classification", "regression"],
                              doc="task type; auto sniffs the columns")

    def _task(self, df: DataFrame) -> str:
        mode = self.get("evaluation_metric")
        if mode != "auto":
            return mode
        return ("classification"
                if self.get("scored_probabilities_col") in df else "regression")

    def _transform(self, df: DataFrame) -> DataFrame:
        y = df[self.get("label_col")]
        pred = df[self.get("scores_col")]
        if self._task(df) == "classification":
            classes = _class_order(df, self.get("scores_col"),
                                   self.get("label_col"), y, pred)
            table = {c: i for i, c in enumerate(classes)}
            y_idx = np.asarray([table[_plain(v)] for v in y])
            p_idx = np.asarray([table[_plain(v)] for v in pred])
            n = len(classes)
            cm = confusion_matrix(y_idx, p_idx, n)
            acc = float((y_idx == p_idx).mean())
            tp = np.diag(cm).astype(np.float64)
            prec = float(np.nanmean(tp / np.maximum(cm.sum(axis=0), 1)))
            rec = float(np.nanmean(tp / np.maximum(cm.sum(axis=1), 1)))
            row = {"accuracy": acc, "precision": prec, "recall": rec,
                   "confusion_matrix": cm}
            prob_col = self.get("scored_probabilities_col")
            if n == 2 and prob_col in df:
                probs = df[prob_col]
                pos_scores = np.asarray([np.asarray(p).ravel()[-1]
                                         for p in probs])
                row["AUC"] = roc_auc(y_idx == 1, pos_scores)
            return DataFrame.from_rows([row])
        yf = y.astype(np.float64)
        pf = pred.astype(np.float64)
        err = yf - pf
        mse = float(np.mean(err ** 2))
        ss_tot = float(np.sum((yf - yf.mean()) ** 2))
        return DataFrame.from_rows([{
            "mean_squared_error": mse,
            "root_mean_squared_error": float(np.sqrt(mse)),
            "mean_absolute_error": float(np.mean(np.abs(err))),
            "R^2": 1.0 - float(np.sum(err ** 2)) / ss_tot if ss_tot else
            float("nan"),
        }])


class ComputePerInstanceStatistics(Transformer, HasLabelCol):
    """Append per-row loss columns (reference
    ``ComputePerInstanceStatistics.scala:45``)."""

    scores_col = Param(str, default="prediction", doc="prediction column")
    scored_probabilities_col = Param(str, default="probability",
                                     doc="probability column (classification)")
    evaluation_metric = Param(str, default="auto",
                              choices=["auto", "classification", "regression"],
                              doc="task type")

    def _transform(self, df: DataFrame) -> DataFrame:
        y = df[self.get("label_col")]
        prob_col = self.get("scored_probabilities_col")
        is_cls = (self.get("evaluation_metric") == "classification"
                  or (self.get("evaluation_metric") == "auto" and prob_col in df))
        if is_cls:
            pred = df[self.get("scores_col")] if self.get("scores_col") in df else y
            classes = _class_order(df, self.get("scores_col"),
                                   self.get("label_col"), y, pred)
            table = {c: i for i, c in enumerate(classes)}
            y_idx = np.asarray([table[_plain(v)] for v in y])
            probs = np.stack([np.asarray(p).ravel() for p in df[prob_col]])
            from ..core.schema import get_label_metadata
            has_meta = any(get_label_metadata(df, c).get("classes")
                           for c in (self.get("scores_col"),
                                     self.get("label_col")))
            if probs.shape[1] != len(classes) and not has_meta:
                raise ValueError(
                    f"probability vectors have {probs.shape[1]} entries but "
                    f"{len(classes)} distinct label/prediction values were "
                    "observed; without label metadata the class order is "
                    "ambiguous — attach it via set_label_metadata")
            if probs.shape[1] < len(classes):
                raise ValueError(
                    f"probability column has {probs.shape[1]} entries but "
                    f"{len(classes)} classes are in play")
            p_true = probs[np.arange(len(y_idx)), y_idx]
            return df.with_column("log_loss", -np.log(np.maximum(p_true, 1e-15)))
        pf = df[self.get("scores_col")].astype(np.float64)
        err = y.astype(np.float64) - pf
        return (df.with_column("L1_loss", np.abs(err))
                  .with_column("L2_loss", err ** 2))

"""Linear learners: logistic & linear regression (counterpart of
``mmlspark_tpu/models/linear.py``).

These are the framework's built-in baseline learners — the role SparkML's
``LogisticRegression``/``LinearRegression`` play for the reference's
``TrainClassifier``/``TrainRegressor`` (``train/TrainClassifier.scala:50``
auto-fits any learner; its default model zoo is SparkML linear/tree models).

Full-batch Adam on the device: the JAX package runs ``max_iter``
``optax.adam`` steps as one jitted ``lax.scan``; :func:`run_linear` runs
the same steps as a loop of PyTorch ops on the tensors' device, with the
loss's gradient written out (softmax minus one-hot, weighted, through
``Xᵀ``) and optax's Adam (eps outside the square root, bias corrections
``1 - β^t`` in float32). The first W is ``0.01 · N(0, 1)`` drawn from a
``torch.Generator`` seeded with ``seed`` on the CPU, so every device
starts from the same W (the JAX package draws it from
``jax.random.PRNGKey(seed)``, which the port cannot reproduce).

``device`` is a constructor (and ``load``) keyword, not a param: ``None``
is the CUDA card and raises without one; the logistic model inherits the
estimator's (the linear model predicts on the host, as in the JAX package).
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from ..core.dataframe import DataFrame
from ..core.params import (ComplexParam, HasFeaturesCol, HasLabelCol,
                           HasPredictionCol, HasProbabilityCol, HasWeightCol,
                           Param)
from ..core.pipeline import Estimator, Model
from ..core.schema import assemble_vector, set_label_metadata
from ..utils.device import OnDevice

__all__ = ["LogisticRegression", "LogisticRegressionModel",
           "LinearRegression", "LinearRegressionModel", "run_linear",
           "init_params"]

_B1, _B2, _EPS = 0.9, 0.999, 1e-8


@torch.no_grad()
def run_linear(X: torch.Tensor, y: torch.Tensor, w: torch.Tensor,
               params: Dict[str, torch.Tensor], reg: float, lr: float,
               n_out: int, loss_kind: str, steps: int
               ) -> Dict[str, torch.Tensor]:
    """``steps`` full-batch Adam steps on ``sum(loss · w) / sum(w) +
    reg · |W|²`` (the intercept unpenalized) from ``params`` {"W": (d, k),
    "b": (k,)}; returns the new params. Everything runs on ``X``'s device
    in float32; ``params`` are not modified."""
    dev = X.device
    X = X.to(torch.float32)
    wn = (w.to(torch.float32) / w.to(torch.float32).sum())[:, None]
    W = params["W"].to(dev, torch.float32).clone()
    b = params["b"].to(dev, torch.float32).clone()
    if loss_kind == "logistic":
        target = torch.nn.functional.one_hot(y.to(dev).long(), n_out).to(
            torch.float32)
    else:
        target = y.to(dev, torch.float32)[:, None]
    moments = [(torch.zeros_like(W), torch.zeros_like(W)),
               (torch.zeros_like(b), torch.zeros_like(b))]
    b1 = torch.tensor(_B1, dtype=torch.float32)
    b2 = torch.tensor(_B2, dtype=torch.float32)
    Xt = X.T
    for t in range(1, steps + 1):
        logits = torch.addmm(b, X, W)
        if loss_kind == "logistic":
            d = (torch.softmax(logits, dim=-1) - target) * wn
        else:
            d = (logits - target) * wn
        grads = (torch.addmm(W, Xt, d, beta=2.0 * reg), d.sum(dim=0))
        c1 = float(1 - b1 ** t)
        c2 = float(1 - b2 ** t)
        for p, g, (m, v) in zip((W, b), grads, moments):
            m.mul_(_B1).add_(g, alpha=1 - _B1)
            v.mul_(_B2).add_(g * g, alpha=1 - _B2)
            p.add_((m / c1) / ((v / c2).sqrt_() + _EPS), alpha=-lr)
    return {"W": W, "b": b}


def init_params(d: int, n_out: int, seed: int) -> Dict[str, torch.Tensor]:
    """The first params: W = 0.01 · N(0, 1) from ``torch.Generator(seed)``
    on the CPU, b = 0."""
    gen = torch.Generator().manual_seed(int(seed))
    return {"W": torch.randn((d, n_out), generator=gen) * 0.01,
            "b": torch.zeros((n_out,))}


def _fit_linear(X: np.ndarray, y: np.ndarray, w: Optional[np.ndarray],
                n_out: int, loss_kind: str, reg: float, lr: float,
                steps: int, seed: int, device: torch.device):
    """Run the trainer on ``device``; returns (W, b) as numpy."""
    Xd = torch.as_tensor(np.asarray(X, np.float32)).to(device)
    yd = torch.as_tensor(np.asarray(y)).to(device)
    wd = (torch.ones(len(X), device=device) if w is None
          else torch.as_tensor(np.asarray(w, np.float32)).to(device))
    p = run_linear(Xd, yd, wd, init_params(X.shape[1], n_out, seed),
                   float(reg), float(lr), n_out=n_out, loss_kind=loss_kind,
                   steps=int(steps))
    return p["W"].cpu().numpy(), p["b"].cpu().numpy()


class _LinearParams(HasFeaturesCol, HasLabelCol, HasWeightCol):
    reg_param = Param(float, default=0.0, doc="L2 regularization strength")
    max_iter = Param(int, default=200, doc="optimizer steps")
    learning_rate = Param(float, default=0.1, doc="Adam learning rate")
    seed = Param(int, default=0, doc="init seed")


class LogisticRegression(OnDevice, Estimator, _LinearParams, HasPredictionCol,
                         HasProbabilityCol):
    """Multiclass logistic regression (softmax), full-batch on device."""

    def _fit(self, df: DataFrame) -> "LogisticRegressionModel":
        X = assemble_vector(df, [self.get("features_col")])
        y_raw = df[self.get("label_col")]
        classes, y = np.unique(y_raw, return_inverse=True)
        wcol = self.get_or_none("weight_col")
        w = df[wcol].astype(np.float64) if wcol else None
        W, b = _fit_linear(X, y, w, len(classes), "logistic",
                           self.get("reg_param"), self.get("learning_rate"),
                           self.get("max_iter"), self.get("seed"),
                           self.device)
        m = LogisticRegressionModel(device=self.device)
        m.set(features_col=self.get("features_col"),
              prediction_col=self.get("prediction_col"),
              probability_col=self.get("probability_col"),
              coefficients=W, intercept=b,
              classes=[c.item() if isinstance(c, np.generic) else c
                       for c in classes])
        return m


class LogisticRegressionModel(OnDevice, Model, HasFeaturesCol,
                              HasPredictionCol, HasProbabilityCol):
    coefficients = ComplexParam(default=None, doc="(d, k) weight matrix")
    intercept = ComplexParam(default=None, doc="(k,) bias")
    classes = Param(list, default=[], doc="class values by column index")

    def _transform(self, df: DataFrame) -> DataFrame:
        dev = self.device
        X = torch.as_tensor(assemble_vector(
            df, [self.get("features_col")]).astype(np.float32)).to(dev)
        with torch.no_grad():
            logits = torch.addmm(
                torch.as_tensor(np.asarray(self.get("intercept"),
                                           np.float32)).to(dev),
                X, torch.as_tensor(np.asarray(self.get("coefficients"),
                                              np.float32)).to(dev))
            probs = torch.softmax(logits, dim=-1).cpu().numpy()
        pred_idx = probs.argmax(axis=1)
        classes = np.asarray(self.get("classes"))
        prob_col = np.empty(len(probs), dtype=object)
        for i in range(len(probs)):
            prob_col[i] = probs[i]
        out = (df.with_column(self.get("prediction_col"), classes[pred_idx])
                 .with_column(self.get("probability_col"), prob_col))
        # class order travels with the frame so metrics index probabilities
        # correctly even when the eval labels are a subset
        return set_label_metadata(out, self.get("prediction_col"),
                                  num_classes=len(classes),
                                  classes=self.get("classes"))


class LinearRegression(OnDevice, Estimator, _LinearParams, HasPredictionCol):
    def _fit(self, df: DataFrame) -> "LinearRegressionModel":
        X = assemble_vector(df, [self.get("features_col")])
        y = df[self.get("label_col")].astype(np.float64)
        wcol = self.get_or_none("weight_col")
        w = df[wcol].astype(np.float64) if wcol else None
        W, b = _fit_linear(X, y, w, 1, "squared",
                           self.get("reg_param"), self.get("learning_rate"),
                           self.get("max_iter"), self.get("seed"),
                           self.device)
        m = LinearRegressionModel()
        m.set(features_col=self.get("features_col"),
              prediction_col=self.get("prediction_col"),
              coefficients=W, intercept=b)
        return m


class LinearRegressionModel(Model, HasFeaturesCol, HasPredictionCol):
    coefficients = ComplexParam(default=None, doc="(d, 1) weights")
    intercept = ComplexParam(default=None, doc="(1,) bias")

    def _transform(self, df: DataFrame) -> DataFrame:
        # float64 on the host, as the JAX package predicts
        X = assemble_vector(df, [self.get("features_col")])
        pred = X @ np.asarray(self.get("coefficients"))[:, 0] \
            + np.asarray(self.get("intercept"))[0]
        return df.with_column(self.get("prediction_col"), pred)

"""VW-style online linear learners on hashed sparse features (counterpart of
``mmlspark_tpu/vw/learners.py``).

Parity surface: ``VowpalWabbitClassifier`` / ``VowpalWabbitRegressor`` and the
training orchestration of ``VowpalWabbitBase`` (``vw/.../VowpalWabbitBase.scala``):
multiple passes over the data, adaptive (adagrad) importance-weighted updates,
squared / logistic / hinge / quantile losses, and a per-fit
performance-statistics table (``TrainingStats``,
``VowpalWabbitBase.scala:25-47,473-487``).

On the card: the JAX package runs the whole multi-pass optimization as one
jitted ``lax.scan`` over passes of a ``lax.scan`` over minibatches. The port
uploads the padded rows once as (n_batches, B, K) tensors and runs the same
minibatch step eagerly, once per minibatch (:func:`minibatch_step`): the
gather-dot of the touched weights, the loss gradient, the adagrad
accumulator's scatter-add, the update's scatter-add, and the l1/l2 shrink
of the touched weights (skipped when both are 0: it would write back what
it read). The host issues every step, so at ``mini_batch`` 64 the host
sets the pace.

Two rules pin the step to the JAX package's results:

* the shrink write ``w.at[bidx].set(where(bval != 0, shrunk, wt))`` meets
  duplicate indices (a feature and a padding slot, both index 0): XLA's CPU
  backend keeps the last duplicate in row-major (B, K) order, while
  ``index_put_`` with duplicates is undefined on CUDA. The port picks the
  last occurrence explicitly (the largest flat position of each index, by
  ``scatter_reduce(..., "amax")``) and every duplicate writes that one
  value, so the CPU and the card agree;
* the zero-weight rows that pad ``n`` to a multiple of ``B`` still make up
  minibatches, and each minibatch advances the step counter ``t`` of the
  ``lr * (t + 1) ** -power_t`` schedule.

The scatter-adds are ``index_add_``: atomics on CUDA, so the last bits of a
weight vary from run to run. ``use_all_reduce``: the JAX package shards
rows over its default mesh, when one is set, and averages weights each pass;
the port has no default mesh and trains on one device.
"""

from __future__ import annotations

import time
from typing import Optional, Tuple

import numpy as np
import torch

from ..core.dataframe import DataFrame
from ..core.params import (ComplexParam, HasFeaturesCol, HasLabelCol,
                           HasPredictionCol, HasProbabilityCol, HasWeightCol,
                           Param)
from ..core.pipeline import Estimator, Model
from ..utils.device import OnDevice
from .featurizer import NUM_BITS_KEY

__all__ = ["VowpalWabbitClassifier", "VowpalWabbitClassifierModel",
           "VowpalWabbitRegressor", "VowpalWabbitRegressorModel",
           "pad_sparse", "pad_sparse_plain", "minibatch_step", "train_passes"]


# ---------------------------------------------------------------------------
# Sparse batch marshalling: object rows → padded static-shape arrays
# ---------------------------------------------------------------------------

def pad_sparse(col, max_nnz: Optional[int] = None
               ) -> Tuple[np.ndarray, np.ndarray]:
    """(indices, values) object rows → (idx [n, K] int32, val [n, K] f32),
    in the native loop.

    Padding slots get index 0 with value 0 — a zero-value feature is a no-op
    for both prediction (contributes 0) and the gradient (scales by value).
    """
    if max_nnz is None:
        max_nnz = max((len(r[0]) for r in col), default=0)
    K = max(1, max_nnz)
    from ..native import pad_sparse as native_pad
    return native_pad(list(col), K)


def pad_sparse_plain(rows, K: int) -> Tuple[np.ndarray, np.ndarray]:
    """The plain version of the native padding loop (the JAX package's
    numpy loop): the same clamp to min(len idx, len val, K)."""
    n = len(rows)
    idx = np.zeros((n, K), dtype=np.int32)
    val = np.zeros((n, K), dtype=np.float32)
    for i, (ri, rv) in enumerate(rows):
        ri = np.asarray(ri).ravel()
        rv = np.asarray(rv).ravel()
        k = min(len(ri), len(rv), K)
        idx[i, :k] = ri[:k].astype(np.int64)
        val[i, :k] = rv[:k]
    return idx, val


# ---------------------------------------------------------------------------
# The minibatch step
# ---------------------------------------------------------------------------

def _dloss(loss: str, pred, y, neg_y, sw, tau: float):
    if loss == "squared":
        return (pred - y) * sw
    if loss == "logistic":        # y in {-1, +1}
        return neg_y * torch.sigmoid(neg_y * pred) * sw
    if loss == "hinge":           # y in {-1, +1}
        return torch.where(y * pred < 1.0, neg_y, 0.0) * sw
    if loss == "quantile":
        return torch.where(pred > y, 1.0 - tau, -tau).to(pred.dtype) * sw
    raise ValueError(f"unknown loss {loss!r}")


def _step_scalars(t: int, lr: float, l1: float, l2: float,
                  power_t: float) -> Tuple[float, float, float]:
    """``(step, step * l1, 1 - step * l2)`` in float32, as the JAX step
    computes them from its float32 counter: ``lr * (t + 1) ** -power_t``."""
    f = np.float32
    step = f(lr) * f(t + 1.0) ** (-f(power_t))
    return (float(step), float(step * f(l1)),
            float(f(1.0) - step * f(l2)))


def minibatch_step(w: torch.Tensor, G: torch.Tensor, bidx: torch.Tensor,
                   bval: torch.Tensor, by: torch.Tensor, neg_by: torch.Tensor,
                   bsw: torch.Tensor, scalars: Tuple[float, float, float], *,
                   loss: str, tau: float, shrink: bool,
                   last: Optional[torch.Tensor] = None,
                   pos: Optional[torch.Tensor] = None) -> None:
    """One adagrad minibatch update of ``w`` and ``G`` in place (JAX
    ``_make_pass_fn``'s ``minibatch_step``). ``bidx`` (B, K) int64,
    ``bval`` (B, K), ``by`` / ``neg_by`` / ``bsw`` (B,); ``scalars`` from
    :func:`_step_scalars`. With ``shrink``, ``last`` is a (dim,) int64
    scratch and ``pos`` the flat positions ``arange(B * K)``."""
    step, step_l1, keep_l2 = scalars
    B, K = bidx.shape
    flat = bidx.reshape(-1)
    pred = (w.index_select(0, flat).view(B, K) * bval).sum(-1)   # gather+dot
    d = _dloss(loss, pred, by, neg_by, bsw, tau)
    g = d[:, None] * bval                              # per-feature gradient
    # adagrad accumulate, then scale: the scatter-adds sum duplicate
    # indices inside the batch (minibatch adagrad's summed gradient)
    G.index_add_(0, flat, (g * g).view(-1))
    denom = G.index_select(0, flat).view(B, K).sqrt() + 1e-6
    upd = step * g / denom
    w.index_add_(0, flat, upd.view(-1), alpha=-1)
    if shrink:
        # sparse l1/l2 on the touched coordinates; padding slots (value 0)
        # write back the unshrunk weight, and of duplicate indices the last
        # in row-major order decides, as on XLA's CPU backend
        wt = w.index_select(0, flat)
        shrunk = torch.sign(wt) * torch.clamp(wt.abs() - step_l1, min=0.0)
        new = torch.where(bval.reshape(-1) != 0.0, shrunk * keep_l2, wt)
        last.scatter_reduce_(0, flat, pos, "amax", include_self=False)
        w.index_put_((flat,), new[last[flat]])


def train_passes(w: torch.Tensor, G: torch.Tensor, idx: torch.Tensor,
                 val: torch.Tensor, y: torch.Tensor, sw: torch.Tensor, *,
                 loss: str, tau: float, n_passes: int, lr: float, l1: float,
                 l2: float, power_t: float) -> int:
    """``n_passes`` passes of :func:`minibatch_step` over ``idx`` / ``val``
    (n_batches, B, K) and ``y`` / ``sw`` (n_batches, B), updating ``w`` and
    ``G`` in place; returns the number of steps issued."""
    n_batches, B, K = idx.shape
    shrink = l1 != 0.0 or l2 != 0.0
    last = pos = None
    if shrink:
        last = torch.zeros(w.shape[0], dtype=torch.int64, device=w.device)
        pos = torch.arange(B * K, dtype=torch.int64, device=w.device)
    neg_y = -y
    t = 0
    for _ in range(int(n_passes)):
        for b in range(n_batches):
            minibatch_step(w, G, idx[b], val[b], y[b], neg_y[b], sw[b],
                           _step_scalars(t, lr, l1, l2, power_t), loss=loss,
                           tau=tau, shrink=shrink, last=last, pos=pos)
            t += 1
    return t


# ---------------------------------------------------------------------------
# Base estimator
# ---------------------------------------------------------------------------

class _VWParams(HasFeaturesCol, HasLabelCol, HasWeightCol):
    num_passes = Param(int, default=1, doc="passes over the data")
    learning_rate = Param(float, default=0.5, doc="base learning rate (VW default 0.5)")
    power_t = Param(float, default=0.5, doc="learning-rate decay exponent")
    l1 = Param(float, default=0.0, doc="L1 regularization (per-update shrink)")
    l2 = Param(float, default=0.0, doc="L2 regularization (per-update decay)")
    num_bits = Param(int, default=18, doc="log2 weight-space size; overridden "
                                          "by featurizer column metadata")
    mini_batch = Param(int, default=64, doc="rows per device update step "
                                            "(stand-in for VW's per-example "
                                            "loop)")
    use_all_reduce = Param(bool, default=True,
                           doc="kept for parity: the JAX package shards rows "
                               "over its default mesh and averages weights "
                               "each pass; the port trains on one device")
    initial_model = ComplexParam(default=None, doc="warm-start weight vector")
    initial_adaptive_state = ComplexParam(
        default=None, doc="warm-start adagrad accumulator (VW --save_resume "
                          "parity; take it from a fitted model's "
                          "adaptive_state param)")
    seed = Param(int, default=0, doc="unused (training is deterministic); "
                                     "kept for API parity")


class _VWBase(OnDevice, Estimator, _VWParams):
    _loss: str = "squared"
    quantile_tau = Param(float, default=0.5, doc="tau for quantile loss")

    def _labels(self, df: DataFrame) -> np.ndarray:
        raise NotImplementedError

    def _num_bits(self, df: DataFrame) -> int:
        meta = df.column_metadata(self.get("features_col"))
        return int(meta.get(NUM_BITS_KEY, self.get("num_bits")))

    def _fit(self, df: DataFrame) -> "Model":
        t0 = time.perf_counter()
        dev = self.device
        fcol = df[self.get("features_col")]
        bits = self._num_bits(df)
        dim = 1 << bits
        idx, val = pad_sparse(fcol)
        n, K = idx.shape
        y = self._labels(df).astype(np.float32)
        wcol = self.get_or_none("weight_col")
        sw = (df[wcol].astype(np.float32) if wcol
              else np.ones(n, dtype=np.float32))
        B = min(self.get("mini_batch"), max(1, n))
        # pad the row count to a multiple of B with zero-weight rows
        per = -(-n // B) * B
        pad = per - n
        if pad:
            idx = np.vstack([idx, np.zeros((pad, K), np.int32)])
            val = np.vstack([val, np.zeros((pad, K), np.float32)])
            y = np.concatenate([y, np.zeros(pad, np.float32)])
            sw = np.concatenate([sw, np.zeros(pad, np.float32)])
        w0 = self.get_or_none("initial_model")
        w0 = (np.zeros(dim, np.float32) if w0 is None
              else np.asarray(w0, np.float32).copy())
        if len(w0) != dim:
            raise ValueError(f"initial_model has {len(w0)} weights, expected {dim}")
        G0 = self.get_or_none("initial_adaptive_state")
        G0 = (np.full(dim, 1e-12, np.float32) if G0 is None
              else np.asarray(G0, np.float32).copy())
        t_pad = time.perf_counter()

        n_batches = per // B
        w = torch.from_numpy(w0).to(dev)
        G = torch.from_numpy(G0).to(dev)
        idx_d = torch.from_numpy(idx).to(dev).long().view(n_batches, B, K)
        val_d = torch.from_numpy(val).to(dev).view(n_batches, B, K)
        y_d = torch.from_numpy(y).to(dev).view(n_batches, B)
        sw_d = torch.from_numpy(sw).to(dev).view(n_batches, B)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t_up = time.perf_counter()
        passes = self.get("num_passes")
        steps = train_passes(
            w, G, idx_d, val_d, y_d, sw_d, loss=self._loss,
            tau=float(self.get("quantile_tau")), n_passes=passes,
            lr=float(self.get("learning_rate")), l1=float(self.get("l1")),
            l2=float(self.get("l2")), power_t=float(self.get("power_t")))
        w_np = w.cpu().numpy()
        G_np = G.cpu().numpy()
        t_train = time.perf_counter()

        model = self._make_model()
        model.set(features_col=self.get("features_col"),
                  weights=w_np, num_bits=bits, adaptive_state=G_np)
        elapsed = time.perf_counter() - t0
        # TrainingStats parity (VowpalWabbitBase.scala:25-47): one row per
        # data shard (one here) with timing/size diagnostics
        model.performance_statistics = DataFrame({
            "partitionId": np.arange(1),
            "rows": np.full(1, n),
            "passes": np.full(1, passes),
            "totalSeconds": np.full(1, round(elapsed, 4)),
            "weightsNonZero": np.full(1, int((w_np != 0).sum())),
        })
        model.phase_seconds = {"pad": t_pad - t0, "upload": t_up - t_pad,
                               "train": t_train - t_up}
        model.train_steps = steps
        return model

    def _make_model(self) -> "Model":
        raise NotImplementedError


class _VWModelBase(OnDevice, Model, HasFeaturesCol, HasPredictionCol):
    weights = ComplexParam(default=None, doc="hashed weight vector (2^num_bits)")
    adaptive_state = ComplexParam(default=None,
                                  doc="adagrad accumulator for warm starts")
    num_bits = Param(int, default=18, doc="log2 weight-space size")

    def _raw_scores(self, df: DataFrame) -> np.ndarray:
        """float32 margins: the gather-dot of the padded rows on the
        model's device."""
        idx, val = pad_sparse(df[self.get("features_col")])
        dev = self.device
        w = torch.from_numpy(np.asarray(self.get("weights"),
                                        np.float32)).to(dev)
        with torch.no_grad():
            i = torch.from_numpy(idx).to(dev).long()
            v = torch.from_numpy(val).to(dev)
            return (w[i] * v).sum(dim=1).cpu().numpy()


class VowpalWabbitRegressor(_VWBase, HasPredictionCol):
    """Online linear regression (squared or quantile loss)."""

    loss_function = Param(str, default="squared",
                          choices=["squared", "quantile"],
                          doc="training loss")

    @property
    def _loss(self):
        return self.get("loss_function")

    def _labels(self, df: DataFrame) -> np.ndarray:
        return np.asarray(df[self.get("label_col")], dtype=np.float32)

    def _make_model(self):
        m = VowpalWabbitRegressorModel(device=self.device)
        m.set(prediction_col=self.get("prediction_col"))
        return m


class VowpalWabbitRegressorModel(_VWModelBase):
    def _transform(self, df: DataFrame) -> DataFrame:
        return df.with_column(self.get("prediction_col"), self._raw_scores(df))


class VowpalWabbitClassifier(_VWBase, HasPredictionCol, HasProbabilityCol):
    """Binary classifier (labels {0,1}), logistic or hinge loss."""

    loss_function = Param(str, default="logistic",
                          choices=["logistic", "hinge"],
                          doc="training loss")

    @property
    def _loss(self):
        return self.get("loss_function")

    def _labels(self, df: DataFrame) -> np.ndarray:
        y = np.asarray(df[self.get("label_col")], dtype=np.float32)
        uniq = np.unique(y)
        if not np.all(np.isin(uniq, [0.0, 1.0, -1.0])):
            raise ValueError(f"binary labels must be 0/1 (or ±1), got {uniq}")
        return np.where(y > 0, 1.0, -1.0)   # VW's ±1 convention

    def _make_model(self):
        m = VowpalWabbitClassifierModel(device=self.device)
        m.set(prediction_col=self.get("prediction_col"),
              probability_col=self.get("probability_col"))
        return m


class VowpalWabbitClassifierModel(_VWModelBase, HasProbabilityCol):
    raw_prediction_col = Param(str, default="rawPrediction",
                               doc="column for the raw margin")

    def _transform(self, df: DataFrame) -> DataFrame:
        raw = self._raw_scores(df)
        prob = 1.0 / (1.0 + np.exp(-raw))
        return (df.with_column(self.get("raw_prediction_col"), raw)
                  .with_column(self.get("probability_col"), prob)
                  .with_column(self.get("prediction_col"),
                               (raw > 0).astype(np.float64)))

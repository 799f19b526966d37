"""GBDT objectives and eval metrics (counterpart of
``models/gbdt/objectives.py``).

Each objective maps raw scores to (grad, hess) as torch functions that
run on the scores' device, so the boosting loop stays on the card between
iterations. ``init_score`` (boost-from-average) is computed on the host in
float64 numpy, as in the JAX package; the eval metrics are the same
host-side numpy functions.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

__all__ = ["get_objective", "get_metric", "OBJECTIVES", "METRICS",
           "Objective"]


class Objective:
    """grad/hess + score->prediction transform + #model outputs per row."""

    def __init__(self, grad_hess: Optional[Callable], transform: Callable,
                 n_scores: int = 1, init_score: Optional[Callable] = None):
        self.grad_hess = grad_hess
        self.transform = transform
        self.n_scores = n_scores
        self.init_score = init_score or (lambda y, w: 0.0)


# -- regression --------------------------------------------------------------

def _l2_grad(scores, y, w):
    g = scores - y
    h = torch.ones_like(scores)
    return g * w, h * w


def _l1_grad(scores, y, w):
    g = torch.sign(scores - y)
    h = torch.ones_like(scores)  # LightGBM uses hessian 1 for L1
    return g * w, h * w


def _huber_grad(delta):
    def f(scores, y, w):
        r = scores - y
        g = torch.where(r.abs() <= delta, r, delta * torch.sign(r))
        h = torch.ones_like(scores)
        return g * w, h * w
    return f


def _quantile_grad(alpha):
    def f(scores, y, w):
        r = scores - y
        g = torch.where(r >= 0, torch.full_like(r, 1.0 - alpha),
                        torch.full_like(r, -alpha))
        h = torch.ones_like(scores)
        return g * w, h * w
    return f


def _poisson_grad(scores, y, w):
    mu = torch.exp(scores)
    return (mu - y) * w, mu * w


def _tweedie_grad(rho):
    def f(scores, y, w):
        g = (-y * torch.exp((1.0 - rho) * scores)
             + torch.exp((2.0 - rho) * scores))
        h = (-y * (1.0 - rho) * torch.exp((1.0 - rho) * scores)
             + (2.0 - rho) * torch.exp((2.0 - rho) * scores))
        return g * w, h * w
    return f


def _gamma_grad(scores, y, w):
    g = 1.0 - y * torch.exp(-scores)
    h = y * torch.exp(-scores)
    return g * w, h * w


# -- classification ----------------------------------------------------------

def _binary_grad(scores, y, w):
    p = torch.sigmoid(scores)
    return (p - y) * w, torch.clamp_min(p * (1 - p), 1e-16) * w


def _multiclass_grad(scores, y, w):
    # scores: (n, K); y int labels (n,)
    p = torch.softmax(scores, dim=-1)
    onehot = torch.nn.functional.one_hot(
        y.to(torch.int64), scores.shape[-1]).to(scores.dtype)
    g = (p - onehot) * w[:, None]
    h = torch.clamp_min(p * (1 - p), 1e-16) * 2.0 * w[:, None]
    return g, h


def _softmax(s):
    return torch.softmax(s, dim=-1)


def _avg_log(y, w):
    return float(np.log(max(np.average(y, weights=w), 1e-9)))


OBJECTIVES: Dict[str, Callable[..., Objective]] = {
    "regression": lambda **kw: Objective(
        _l2_grad, lambda s: s,
        init_score=lambda y, w: float(np.average(y, weights=w))),
    "regression_l1": lambda **kw: Objective(
        _l1_grad, lambda s: s,
        init_score=lambda y, w: float(np.median(y))),
    "huber": lambda alpha=0.9, **kw: Objective(_huber_grad(alpha), lambda s: s),
    "quantile": lambda alpha=0.5, **kw: Objective(
        _quantile_grad(alpha), lambda s: s,
        init_score=lambda y, w: float(np.quantile(y, alpha))),
    "poisson": lambda **kw: Objective(_poisson_grad, torch.exp,
                                      init_score=_avg_log),
    "tweedie": lambda tweedie_variance_power=1.5, **kw: Objective(
        _tweedie_grad(tweedie_variance_power), torch.exp,
        init_score=_avg_log),
    "gamma": lambda **kw: Objective(_gamma_grad, torch.exp,
                                    init_score=_avg_log),
    "binary": lambda **kw: Objective(
        _binary_grad, torch.sigmoid,
        init_score=lambda y, w: float(np.log(
            max(np.average(y, weights=w), 1e-9)
            / max(1 - np.average(y, weights=w), 1e-9)))),
    "multiclass": lambda num_class=2, **kw: Objective(
        _multiclass_grad, _softmax, n_scores=num_class),
    "lambdarank": lambda **kw: Objective(None, torch.sigmoid),
}

# aliases (parity with LightGBM names)
OBJECTIVES["l2"] = OBJECTIVES["mse"] = OBJECTIVES["mean_squared_error"] = \
    OBJECTIVES["regression"]
OBJECTIVES["l1"] = OBJECTIVES["mae"] = OBJECTIVES["regression_l1"]
OBJECTIVES["softmax"] = OBJECTIVES["multiclass"]


def get_objective(name: str, **kw) -> Objective:
    if name not in OBJECTIVES:
        raise ValueError(f"unknown objective {name!r}; known: {sorted(OBJECTIVES)}")
    return OBJECTIVES[name](**kw)


# -- eval metrics (host-side numpy; used for early stopping & logging) -------

def _auc(y, p, w):
    order = np.argsort(-p)
    y, w = np.asarray(y)[order], np.asarray(w)[order]
    tp = np.cumsum(y * w)
    fp = np.cumsum((1 - y) * w)
    tot_p, tot_n = tp[-1], fp[-1]
    if tot_p == 0 or tot_n == 0:
        return 0.5
    # trapezoid over ROC
    tpr = np.concatenate([[0], tp / tot_p])
    fpr = np.concatenate([[0], fp / tot_n])
    return float(np.trapezoid(tpr, fpr))


def _binary_logloss(y, p, w):
    p = np.clip(p, 1e-15, 1 - 1e-15)
    return float(np.average(-(y * np.log(p) + (1 - y) * np.log(1 - p)),
                            weights=w))


def _multi_logloss(y, p, w):
    p = np.clip(p, 1e-15, 1.0)
    ll = -np.log(p[np.arange(len(y)), np.asarray(y, dtype=int)])
    return float(np.average(ll, weights=w))


def _ndcg_at(k):
    def f(y, p, w, groups=None):
        if groups is None:
            groups = np.array([len(y)])
        scores, start = [], 0
        for g in groups:
            g = int(g)
            yy, pp = np.asarray(y[start:start + g]), p[start:start + g]
            start += g
            if g == 0:
                continue
            order = np.argsort(-pp)[:k]
            gains = (2.0 ** yy[order] - 1) / np.log2(np.arange(2, len(order) + 2))
            ideal_order = np.argsort(-yy)[:k]
            ideal = (2.0 ** yy[ideal_order] - 1) / np.log2(np.arange(2, len(ideal_order) + 2))
            scores.append(gains.sum() / ideal.sum() if ideal.sum() > 0 else 1.0)
        return float(np.mean(scores)) if scores else 1.0
    return f


METRICS: Dict[str, Tuple[Callable, bool]] = {
    # name -> (fn(y, pred, w), higher_is_better)
    "l2": (lambda y, p, w: float(np.average((p - y) ** 2, weights=w)), False),
    "rmse": (lambda y, p, w: float(np.sqrt(np.average((p - y) ** 2, weights=w))), False),
    "l1": (lambda y, p, w: float(np.average(np.abs(p - y), weights=w)), False),
    "auc": (_auc, True),
    "binary_logloss": (_binary_logloss, False),
    "multi_logloss": (_multi_logloss, False),
    "binary_error": (lambda y, p, w: float(np.average((p > 0.5) != (y > 0.5),
                                                      weights=w)), False),
    "multi_error": (lambda y, p, w: float(np.average(np.argmax(p, 1) != y,
                                                     weights=w)), False),
    "ndcg": (_ndcg_at(10), True),
}

_DEFAULT_METRIC = {"regression": "l2", "regression_l1": "l1", "huber": "l2",
                   "quantile": "l2", "poisson": "l2", "tweedie": "l2",
                   "gamma": "l2", "binary": "binary_logloss",
                   "multiclass": "multi_logloss", "lambdarank": "ndcg"}


def get_metric(name: str, objective: Optional[str] = None):
    if name in ("", "auto", None) and objective:
        name = _DEFAULT_METRIC.get(objective, "l2")
    if name not in METRICS:
        raise ValueError(f"unknown metric {name!r}; known: {sorted(METRICS)}")
    return name, METRICS[name]

"""Batched surrogate regressions for explainers (counterpart of
``mmlspark_tpu/explainers/regression.py``).

Parity surface: the reference's per-row Breeze solvers —
``LassoRegression.scala:88`` / ``LeastSquaresRegression.scala`` /
``RegressionBase.scala:151`` — called once per explained row inside
``LIMEBase.transform`` and ``KernelSHAPBase.transform``.

Every row's fit is one slice of a batched float32 PyTorch computation on
the device (the JAX package ``vmap``s one solve): weighted least squares
as batched ridge-stabilized normal equations (``torch.linalg.solve`` over
the (B, d, d) grams), lasso as ISTA steps of batched matrix-vector
products. ``device=None`` is the CUDA card; inputs may be numpy or
tensors, results come back as numpy.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.device import resolve_device

__all__ = ["batched_weighted_lstsq", "batched_lasso"]


def _f32(a, dev: torch.device) -> torch.Tensor:
    t = a if isinstance(a, torch.Tensor) else torch.from_numpy(
        np.ascontiguousarray(a, dtype=np.float32))
    return t.to(dev, torch.float32)


@torch.no_grad()
def batched_weighted_lstsq(X, y, w, fit_intercept: bool = True,
                           device=None):
    """Solve argmin ||sqrt(w) (X b - y)||² for a batch.

    X: (B, m, d), y: (B, m), w: (B, m) → coefs (B, d), intercept (B,).
    """
    dev = resolve_device(device)
    X, y, w = _f32(X, dev), _f32(y, dev), _f32(w, dev)
    if fit_intercept:
        X = torch.cat([X, X.new_ones(X.shape[:2] + (1,))], dim=2)
    sw = torch.sqrt(torch.clamp(w, min=0.0))
    A = X * sw[..., None]
    At = A.transpose(1, 2)
    # ridge-stabilized normal equations: one batched d×d solve
    G = At @ A + 1e-8 * torch.eye(A.shape[2], device=dev)
    coefs = torch.linalg.solve(G, At @ (y * sw)[..., None])[..., 0]
    coefs = coefs.cpu().numpy()
    if fit_intercept:
        return coefs[:, :-1], coefs[:, -1]
    return coefs, np.zeros(len(coefs))


@torch.no_grad()
def batched_lasso(X, y, w, alpha: float = 0.01, steps: int = 200,
                  device=None):
    """Batched weighted lasso via ISTA.

    X: (B, m, d), y: (B, m), w: (B, m) → coefs (B, d), intercept (B,).
    """
    dev = resolve_device(device)
    X, y, w = _f32(X, dev), _f32(y, dev), _f32(w, dev)
    w = w / torch.clamp(w.sum(dim=1, keepdim=True), min=1e-12)
    # center by weighted means so the intercept drops out of ISTA
    xm = (X * w[..., None]).sum(dim=1)
    ym = (y * w).sum(dim=1)
    Xc = X - xm[:, None]
    yc = y - ym[:, None]
    A = Xc * w[..., None]
    G = Xc.transpose(1, 2) @ A                       # weighted grams
    c = (A.transpose(1, 2) @ yc[..., None])[..., 0]  # weighted correlations
    t = (1.0 / (G.diagonal(dim1=1, dim2=2).sum(dim=1) + 1e-6))[:, None]
    beta = X.new_zeros(X.shape[0], X.shape[2])
    for _ in range(steps):
        z = beta - t * ((G @ beta[..., None])[..., 0] - c)
        beta = torch.sign(z) * torch.clamp(z.abs() - t * alpha, min=0.0)
    intercept = ym - (beta * xm).sum(dim=1)
    return beta.cpu().numpy(), intercept.cpu().numpy()

"""LambdaRank gradients on the device (the JAX package computes them on
the host, ``models/gbdt/train.py``'s ``_lambdarank_grad``).

The formula is the reference's, in float64: per query group, documents
are ranked by score (ties in index order), each pair of documents with
different labels contributes ``rho = 1 / (1 + exp(sigma (s_i - s_j)
S_ij))`` weighted by the pair's |delta NDCG| (gains ``2^y - 1``,
discounts ``1 / log2(rank + 2)``, over the group's ideal DCG), and the
hessians are floored at 1e-9. Groups of one document keep zero
gradients.

The reference pads every group to the largest group's size and works in
chunks of ``4e6 / M^2`` groups on the host. Here :class:`LambdarankPlan`
sorts the groups by size once per run, buckets them by powers of two and
pads each bucket only to its own largest group, with chunks whose pair
tensors stay under ``PAIR_BYTES``; the labels' gains and ideal DCGs are
computed once. :func:`lambdarank_grad` then runs each chunk's (C, M, M)
pair terms on the device with no host read, so the boosting loop can
queue iterations back to back. :func:`lambdarank_grad_plain` is the
reference's numpy function, kept as the plain version the tests and the
card's checks hold the device function to.
"""

from __future__ import annotations

from typing import List, NamedTuple, Tuple

import numpy as np
import torch

__all__ = ["LambdarankPlan", "lambdarank_grad", "lambdarank_grad_plain",
           "PAIR_BYTES"]

#: the bytes a chunk's float64 pair tensors may hold at once
PAIR_BYTES = 1 << 30
#: (C, M, M) float64 tensors alive at once in a chunk
_PAIR_TENSORS = 4


class _Chunk(NamedTuple):
    idx: torch.Tensor       # (C, M) int64 row of each slot (clipped)
    mask: torch.Tensor      # (C, M) bool, the slot holds a document
    gain: torch.Tensor      # (C, M) float64, 2^y - 1 (0 on padding)
    yy: torch.Tensor        # (C, M) float64 labels (0 on padding)
    idcg: torch.Tensor      # (C,) float64, the ideal DCG (>= 1e-12)
    dst: torch.Tensor       # rows written: documents of groups of > 1
    src: torch.Tensor       # their flat slots in (C * M)


class LambdarankPlan:
    """The chunks of one run's query groups on ``device``: ``groups`` (G,)
    document counts of contiguous row runs over ``n`` rows, ``y`` (n,)
    the relevance labels. Rows past the groups' sum keep zero
    gradients."""

    def __init__(self, groups, y: np.ndarray, device, n: int = None):
        groups = np.asarray(groups, dtype=np.int64)
        y = np.asarray(y, dtype=np.float64)
        self.n = len(y) if n is None else int(n)
        self.device = torch.device(device)
        self.chunks: List[_Chunk] = []
        if len(groups) == 0 or int(groups.max()) <= 1:
            return
        offs = np.concatenate([[0], np.cumsum(groups)])[:-1]
        order = np.argsort(groups, kind="stable")
        sizes = groups[order]
        # buckets: group sizes in (2^(k-1), 2^k], each padded to its max
        bucket = np.ceil(np.log2(np.maximum(sizes, 1))).astype(np.int64)
        for b in np.unique(bucket):
            sel = order[bucket == b]
            M = int(groups[sel].max())
            if M <= 1:
                continue
            per = max(1, PAIR_BYTES // (8 * M * M * _PAIR_TENSORS))
            for lo in range(0, len(sel), per):
                self.chunks.append(self._chunk(sel[lo:lo + per], offs,
                                               groups, y, M))

    def _chunk(self, gsel, offs, groups, y, M) -> _Chunk:
        cnt = groups[gsel]
        idx = offs[gsel, None] + np.arange(M)[None, :]
        mask = np.arange(M)[None, :] < cnt[:, None]
        idx = np.minimum(idx, len(y) - 1)
        yy = np.where(mask, y[idx], 0.0)
        gain = np.where(mask, 2.0 ** yy - 1, 0.0)
        # zero-gain padding contributes 0 at any position of the ideal
        ideal = -np.sort(-gain, axis=1) / np.log2(np.arange(2, M + 2))[None]
        idcg = np.maximum(ideal.sum(axis=1), 1e-12)
        multi = (cnt > 1)[:, None] & mask
        dev = self.device

        def put(a, dt):
            return torch.from_numpy(np.ascontiguousarray(a)).to(dev, dt)
        return _Chunk(put(idx, torch.int64), put(mask, torch.bool),
                      put(gain, torch.float64), put(yy, torch.float64),
                      put(idcg, torch.float64),
                      put(idx[multi], torch.int64),
                      put(np.flatnonzero(multi.ravel()), torch.int64))

    def pair_elements(self) -> int:
        """Pair terms each call evaluates (padding included)."""
        return sum(int(c.idx.shape[0]) * int(c.idx.shape[1]) ** 2
                   for c in self.chunks)


def lambdarank_grad(scores: torch.Tensor, plan: LambdarankPlan,
                    sigma: float = 1.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """(g, h) float64 (n,) on the plan's device for ``scores`` (n,) (any
    float dtype; taken to float64), by the reference's formula."""
    s_all = scores.to(torch.float64)
    g = torch.zeros(plan.n, dtype=torch.float64, device=s_all.device)
    h = torch.zeros_like(g)
    for c in plan.chunks:
        C, M = c.idx.shape
        s = torch.where(c.mask, s_all[c.idx], 0.0)
        # ranks: padding sorts last (-inf), ties keep index order
        key = torch.where(c.mask, s, -torch.inf)
        order = torch.sort(key, dim=1, descending=True, stable=True)[1]
        rank = torch.empty_like(order).scatter_(
            1, order, torch.arange(M, device=order.device).expand(C, M))
        disc = torch.where(c.mask, 1.0 / torch.log2(
            rank.to(torch.float64) + 2.0), 0.0)
        Sij = torch.sign(c.yy[:, :, None] - c.yy[:, None, :])
        live = (c.mask[:, :, None] & c.mask[:, None, :]) & (Sij != 0)
        rho = 1.0 / (1.0 + torch.exp(sigma * (s[:, :, None]
                                              - s[:, None, :]) * Sij))
        delta = ((c.gain[:, :, None] - c.gain[:, None, :])
                 * (disc[:, :, None] - disc[:, None, :])).abs_() \
            / c.idcg[:, None, None]
        gi = torch.where(live, -sigma * rho * delta * Sij, 0.0)
        grow = gi.sum(dim=2)
        del gi, Sij
        hi = torch.where(live, sigma * sigma * rho * (1 - rho) * delta, 0.0)
        hrow = hi.sum(dim=2).clamp_min(1e-9)
        del hi, rho, delta, live
        g.index_copy_(0, c.dst, grow.reshape(-1).index_select(0, c.src))
        h.index_copy_(0, c.dst, hrow.reshape(-1).index_select(0, c.src))
    return g, h


def lambdarank_grad_plain(scores: np.ndarray, y: np.ndarray,
                          groups: np.ndarray, sigma: float = 1.0
                          ) -> Tuple[np.ndarray, np.ndarray]:
    """The reference's host function: groups padded to the largest group,
    chunks of ``4e6 / M^2`` groups, numpy float64."""
    g = np.zeros_like(scores)
    h = np.zeros_like(scores)
    groups = np.asarray(groups, dtype=np.int64)
    if len(groups) == 0:
        return g, h
    offs = np.concatenate([[0], np.cumsum(groups)])
    M = int(groups.max())
    if M <= 1:
        return g, h
    nG = len(groups)
    idx = offs[:-1, None] + np.arange(M)[None, :]
    mask = np.arange(M)[None, :] < groups[:, None]
    idx = np.minimum(idx, len(scores) - 1)
    chunk = max(1, int(4e6 / (M * M)))
    for lo in range(0, nG, chunk):
        sl = slice(lo, min(lo + chunk, nG))
        m = mask[sl]
        ix = idx[sl]
        cnt = groups[sl]
        s = np.where(m, scores[ix], 0.0)
        yy = np.where(m, y[ix], 0.0)
        key = np.where(m, s, -np.inf)
        order = np.argsort(-key, axis=1, kind="stable")
        rank = np.empty_like(order)
        np.put_along_axis(rank, order, np.arange(M)[None, :], axis=1)
        gain = np.where(m, 2.0 ** yy - 1, 0.0)
        disc = np.where(m, 1.0 / np.log2(rank + 2.0), 0.0)
        ideal = -np.sort(-gain, axis=1) / np.log2(np.arange(2, M + 2))[None, :]
        idcg = np.maximum(ideal.sum(axis=1), 1e-12)
        pm = m[:, :, None] & m[:, None, :]
        sd = s[:, :, None] - s[:, None, :]
        Sij = np.sign(yy[:, :, None] - yy[:, None, :])
        live = pm & (Sij != 0)
        with np.errstate(over="ignore"):
            rho = 1.0 / (1.0 + np.exp(sigma * sd * Sij))
        delta_ndcg = np.abs((gain[:, :, None] - gain[:, None, :])
                            * (disc[:, :, None] - disc[:, None, :])) \
            / idcg[:, None, None]
        gi = np.where(live, -sigma * rho * delta_ndcg * Sij, 0.0)
        hi = np.where(live, sigma * sigma * rho * (1 - rho) * delta_ndcg, 0.0)
        grow = gi.sum(axis=2)
        hrow = np.maximum(hi.sum(axis=2), 1e-9)
        multi = (cnt > 1)[:, None] & m
        g[ix[multi]] = grow[multi]
        h[ix[multi]] = hrow[multi]
    return g, h

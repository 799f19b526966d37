"""Smart Adaptive Recommendations (SAR) (counterpart of
``mmlspark_tpu/recommendation/sar.py``).

Parity surface: ``SAR:36`` / ``SARModel:22`` (reference
``core/.../recommendation/SAR.scala``): item-item similarity from
co-occurrence (jaccard / lift / cooccurrence counts) + per-user affinity with
exponential time decay; recommendation = affinity · similarity.

The two products run on the model's device (``device=None`` is the CUDA
card): the co-occurrence ``C = Oᵀ·O`` and the scores ``A · S``, float32
matmuls with TF32 off. The co-occurrence counts are integers below 2²⁴, so
``C`` is exact, bitwise the CPU's on either device; the affinity, the
similarity from ``C`` and ``recommend_for_all_users``' sort stay on the
host in numpy, as in the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.dataframe import DataFrame
from ..core.params import ComplexParam, Param
from ..core.pipeline import Estimator, Model
from ..utils.device import OnDevice

__all__ = ["SAR", "SARModel"]


def _on(dev: torch.device, a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dev)


class SAR(OnDevice, Estimator):
    user_col = Param(str, default="user", doc="user id column (int indices)")
    item_col = Param(str, default="item", doc="item id column (int indices)")
    rating_col = Param(str, default="rating", doc="rating column (optional)")
    time_col = Param(str, default=None, doc="timestamp column for decay")
    similarity_function = Param(str, default="jaccard",
                                choices=["jaccard", "lift", "cooccurrence"],
                                doc="item-item similarity")
    support_threshold = Param(int, default=4,
                              doc="min co-occurrence count to keep")
    time_decay_coeff = Param(int, default=30,
                             doc="half-life in days for affinity decay")

    def _fit(self, df: DataFrame) -> "SARModel":
        users = df[self.get("user_col")].astype(np.int64)
        items = df[self.get("item_col")].astype(np.int64)
        n_users = int(users.max()) + 1 if len(users) else 0
        n_items = int(items.max()) + 1 if len(items) else 0

        rcol = self.get_or_none("rating_col")
        ratings = (df[rcol].astype(np.float64) if rcol and rcol in df
                   else np.ones(len(df)))

        # affinity with exponential time decay (reference: user affinity
        # a_u,i = sum_k r_k * 2^(-(t0 - t_k)/T))
        tcol = self.get_or_none("time_col")
        if tcol and tcol in df:
            t = df[tcol].astype(np.float64)
            t0 = t.max()
            half_life_s = self.get("time_decay_coeff") * 86400.0
            decay = np.power(2.0, -(t0 - t) / half_life_s)
        else:
            decay = np.ones(len(df))

        A = np.zeros((n_users, n_items), dtype=np.float32)
        np.add.at(A, (users, items), ratings * decay)
        occ = np.zeros((n_users, n_items), dtype=np.float32)
        np.add.at(occ, (users, items), 1.0)
        occ = (occ > 0).astype(np.float32)

        # (items, items) co-occurrence on the device
        with torch.no_grad():
            O = _on(self.device, occ)
            C = (O.T @ O).cpu().numpy()
            del O
        C = np.where(C >= self.get("support_threshold"), C, 0.0)
        diag = np.diag(C).copy()
        sim_kind = self.get("similarity_function")
        if sim_kind == "cooccurrence":
            S = C
        elif sim_kind == "lift":
            denom = np.outer(diag, diag)
            S = np.divide(C, denom, out=np.zeros_like(C), where=denom > 0)
        else:  # jaccard
            denom = diag[:, None] + diag[None, :] - C
            S = np.divide(C, denom, out=np.zeros_like(C), where=denom > 0)

        m = SARModel(device=self.device)
        m.set(user_col=self.get("user_col"), item_col=self.get("item_col"),
              rating_col=rcol or "rating",
              item_similarity=S.astype(np.float32),
              user_affinity=A)
        return m


class SARModel(OnDevice, Model):
    user_col = Param(str, default="user", doc="user id column")
    item_col = Param(str, default="item", doc="item id column")
    rating_col = Param(str, default="rating", doc="score output column")
    item_similarity = ComplexParam(default=None, doc="(items, items) matrix")
    user_affinity = ComplexParam(default=None, doc="(users, items) matrix")

    def _scores_device(self) -> torch.Tensor:
        """``affinity · similarity`` on the model's device."""
        dev = self.device
        return (_on(dev, self.get("user_affinity"))
                @ _on(dev, self.get("item_similarity")))

    def _scores(self) -> np.ndarray:
        with torch.no_grad():
            return self._scores_device().cpu().numpy()

    def _transform(self, df: DataFrame) -> DataFrame:
        """Score (user, item) pairs: the product on the device, the pairs
        gathered there."""
        users = df[self.get("user_col")].astype(np.int64)
        items = df[self.get("item_col")].astype(np.int64)
        vals = np.zeros(len(df))
        with torch.no_grad():
            scores = self._scores_device()
            ok = (users < scores.shape[0]) & (items < scores.shape[1])
            dev = scores.device
            got = scores[torch.from_numpy(users[ok]).to(dev),
                         torch.from_numpy(items[ok]).to(dev)]
            vals[ok] = got.cpu().numpy()
        return df.with_column("prediction", vals)

    def recommend_for_all_users(self, k: int = 10,
                                remove_seen: bool = True) -> DataFrame:
        """Top-k unseen items per user (reference SARModel.recommendForAllUsers)."""
        scores = self._scores()
        A = np.asarray(self.get("user_affinity"))
        if remove_seen:
            scores[A > 0] = -np.inf
        k = min(k, scores.shape[1])
        top = np.argsort(-scores, axis=1)[:, :k]
        n_users = scores.shape[0]
        recs = np.empty(n_users, dtype=object)
        ratings = np.empty(n_users, dtype=object)
        for u in range(n_users):
            # seen items were masked to -inf; a user with < k unseen items
            # gets a shorter list rather than padded fake recommendations
            keep = [i for i in top[u] if np.isfinite(scores[u, i])]
            recs[u] = [int(i) for i in keep]
            ratings[u] = [float(scores[u, i]) for i in keep]
        return DataFrame({self.get("user_col"): np.arange(n_users),
                          "recommendations": recs, "ratings": ratings})

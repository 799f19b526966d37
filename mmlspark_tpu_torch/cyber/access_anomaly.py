"""Collaborative-filtering access-anomaly detection (counterpart of
``mmlspark_tpu/cyber/access_anomaly.py``).

Parity: ``synapse/ml/cyber/anomaly/collaborative_filtering.py`` —
``AccessAnomaly`` learns per-tenant user/resource latent vectors from access
logs (Spark ALS in the reference, ``:719-780``), normalizes them so training
scores have mean 0 / std 1 per tenant (``ModelNormalizeTransformer:886``),
and scores new (user, resource) pairs by a dot product with special cases
(``AccessAnomalyModel._transform:366-411``): unknown user/resource → null,
cross connected-component pairs → +inf, optionally previously-seen pairs →
0. Lower likelihood ⇒ higher anomaly after normalization the score is
*negated likelihood z-score* exactly like the reference (low dot = unusual).

ALS runs on the estimator's device (``device=None`` is the CUDA card) as
alternating batched ridge solves over dense per-tenant matrices, the JAX
package's formulation: each half-step builds every row's (r×r) normal
matrix and solves them as one batched ``torch.linalg.solve``. Implicit
feedback uses the Hu-Koren-Volinsky confidence trick (C = 1 + alpha·R)
with the shared ``VᵀV``. The JAX package's three-operand einsum
``"yx,xi,xj->yij"`` is one matmul here, ``M @ (X ⊗ X).reshape(n_x, r²)``
(an unplanned einsum would form an (n_y, n_x, r) intermediate), and the
confidence terms, fixed across iterations, are formed once. The solve is
LAPACK ``gesv`` on the CPU and cuSOLVER's batched path on the card (the
JAX package's CPU solve is ``sgetrf`` + two ``strsm``): factors agree to a
tolerance, not bitwise. The initial factors are the same
``np.random.default_rng(seed).normal`` draws in both packages. Everything
around ALS (indexers, scalers, maps, components, scoring) is host numpy,
as in the JAX package.
"""

from __future__ import annotations

import time
from typing import Dict, Optional

import numpy as np
import torch

from ..core.dataframe import DataFrame
from ..core.params import Param
from ..core.pipeline import Estimator, Model
from ..core.schema import py_scalar as _py
from ..utils.device import OnDevice
from .complement_access import ComplementAccessTransformer
from .features import IdIndexer, LinearScalarScaler, MultiIndexer

__all__ = ["AccessAnomaly", "AccessAnomalyModel", "ConnectedComponents"]


# ---------------------------------------------------------------------------
# batched ALS (the Spark-ALS replacement)
# ---------------------------------------------------------------------------

def _als(R: np.ndarray, M: np.ndarray, rank: int, iters: int, reg: float,
         implicit: bool, alpha: float, seed: int,
         device: torch.device = None):
    """R (n_users, n_res) ratings, M mask of observed. Returns (U, V) as
    float32 numpy, computed on ``device``."""
    rng = np.random.default_rng(seed)
    n_u, n_r = R.shape
    # U0 is drawn (and unused: the first half-step solves U from V0) so
    # that V0 is the JAX package's second draw
    rng.normal(0, 0.1, (n_u, rank))
    V0 = rng.normal(0, 0.1, (n_r, rank)).astype(np.float32)
    dev = device if device is not None else torch.device("cpu")

    def on(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dev)

    with torch.no_grad():
        Rd, Md = on(R), on(M)
        eye = torch.eye(rank, dtype=torch.float32, device=dev) * reg

        def side(R, M):
            """The fixed terms of one side's normal equations: the
            per-row weight of the outer products and the right-hand
            side's weights."""
            if implicit:
                CmI = alpha * R * M                     # extra confidence
                return CmI.contiguous(), ((1.0 + CmI) * M).contiguous()
            return M.contiguous(), (R * M).contiguous()

        def solve_side(X, weights, rhs):
            """Solve for the other side's factors given X (n_x, r)."""
            n_x, r = X.shape
            outer = (X[:, :, None] * X[:, None, :]).reshape(n_x, r * r)
            A = (weights @ outer).view(-1, r, r)
            if implicit:
                A = (X.T @ X)[None] + A                 # shared XᵀX
            A = A + eye
            b = rhs @ X
            return torch.linalg.solve(A, b[..., None])[..., 0]

        users, res = side(Rd, Md), side(Rd.T, Md.T)
        del Rd, Md
        V = on(V0)
        U = None
        for _ in range(int(iters)):
            U = solve_side(V, *users)                   # rows index users
            V = solve_side(U, *res)                     # items
        if U is None:
            U = on(np.zeros((n_u, rank)))
        return U.cpu().numpy(), V.cpu().numpy()


class ConnectedComponents:
    """Union-find over the bipartite user-resource graph, per tenant
    (reference ``ConnectedComponents:415-470``)."""

    @staticmethod
    def components(users, resources):
        parent: Dict = {}

        def find(x):
            while parent.setdefault(x, x) != x:
                parent[x] = parent[parent[x]]
                x = parent[x]
            return x

        for u, r in zip(users, resources):
            ru, rr = find(("u", u)), find(("r", r))
            if ru != rr:
                parent[ru] = rr
        user_comp = {u: find(("u", u)) for u in set(users)}
        res_comp = {r: find(("r", r)) for r in set(resources)}
        # canonical integer ids
        ids = {c: i for i, c in enumerate(
            dict.fromkeys(list(user_comp.values()) + list(res_comp.values())))}
        return ({u: ids[c] for u, c in user_comp.items()},
                {r: ids[c] for r, c in res_comp.items()})


class AccessAnomaly(OnDevice, Estimator):
    """Learn normal (tenant, user, resource) access patterns; score outliers."""

    tenant_col = Param(str, default="tenant", doc="tenant column")
    user_col = Param(str, default="user", doc="user column")
    res_col = Param(str, default="res", doc="resource column")
    likelihood_col = Param(str, default="likelihood",
                           doc="access count/likelihood column")
    output_col = Param(str, default="anomaly_score", doc="score column")
    rank_param = Param(int, default=10, doc="latent dimension")
    max_iter = Param(int, default=25, doc="ALS iterations")
    reg_param = Param(float, default=1.0, doc="ridge regularization")
    apply_implicit_cf = Param(bool, default=True,
                              doc="implicit-feedback ALS (confidence "
                                  "weighting) vs explicit with sampled "
                                  "negatives")
    alpha_param = Param(float, default=1.0, doc="implicit confidence slope")
    low_value = Param(float, default=5.0, doc="likelihood rescale lower bound")
    high_value = Param(float, default=10.0, doc="likelihood rescale upper bound")
    complementset_factor = Param(int, default=2,
                                 doc="negative samples per row (explicit mode)")
    neg_score = Param(float, default=1.0, doc="rating for sampled negatives")
    seed = Param(int, default=0, doc="init/sampling seed")

    def _fit(self, df: DataFrame) -> "AccessAnomalyModel":
        t0 = time.perf_counter()
        als_s = 0.0
        tcol, ucol, rcol = (self.get("tenant_col"), self.get("user_col"),
                            self.get("res_col"))
        lcol = self.get("likelihood_col")
        rank = self.get("rank_param")

        indexer = MultiIndexer([
            IdIndexer(input_col=ucol, output_col="__uidx__",
                      partition_key=tcol, reset_per_partition=True),
            IdIndexer(input_col=rcol, output_col="__ridx__",
                      partition_key=tcol, reset_per_partition=True),
        ])
        ix_model = indexer.fit(df)
        idf = ix_model.transform(df)

        if lcol in df.columns:
            scaled = LinearScalarScaler(
                input_col=lcol, output_col="__scaled__", partition_key=tcol,
                min_required_value=self.get("low_value"),
                max_required_value=self.get("high_value")).fit(idf) \
                .transform(idf)
        else:
            scaled = idf.with_column("__scaled__",
                                     np.full(len(idf), self.get("high_value")))

        tenants = scaled[tcol]
        user_maps: Dict = {}
        res_maps: Dict = {}
        stats: Dict = {}
        seen: Dict = {}
        comps: Dict = {}
        for t_raw in dict.fromkeys(tenants):
            t = _py(t_raw)   # plain scalar: keys must survive JSON save
            mask = tenants == t_raw
            sub_u = scaled["__uidx__"][mask]
            sub_r = scaled["__ridx__"][mask]
            sub_s = scaled["__scaled__"][mask].astype(np.float64)
            n_u, n_r = int(sub_u.max()), int(sub_r.max())
            R = np.zeros((n_u, n_r), np.float64)
            M = np.zeros((n_u, n_r), np.float64)
            # duplicate (user, res) rows accumulate (order-independent) —
            # repeated accesses add confidence rather than last-write-wins
            np.add.at(R, (sub_u - 1, sub_r - 1), sub_s)
            M[sub_u - 1, sub_r - 1] = 1.0
            if not self.get("apply_implicit_cf"):
                # explicit mode: sampled complement accesses as negatives
                comp = ComplementAccessTransformer(
                    partition_key=None,
                    indexed_col_names=["__uidx__", "__ridx__"],
                    complementset_factor=self.get("complementset_factor"),
                    seed=self.get("seed")).transform(
                        DataFrame({"__uidx__": sub_u, "__ridx__": sub_r}))
                cu = comp["__uidx__"] - 1
                cr = comp["__ridx__"] - 1
                R[cu, cr] = self.get("neg_score")
                M[cu, cr] = 1.0
            t_als = time.perf_counter()
            U, V = _als(R, M, rank, self.get("max_iter"),
                        self.get("reg_param"),
                        self.get("apply_implicit_cf"),
                        self.get("alpha_param"), self.get("seed"),
                        self.device)
            als_s += time.perf_counter() - t_als
            # normalization (ModelNormalizeTransformer parity): training
            # scores → mean 0 / std 1 per tenant, folded into the factors
            train_scores = np.einsum("ij,ij->i", U[sub_u - 1], V[sub_r - 1])
            mu, sd = float(train_scores.mean()), float(train_scores.std())
            sd = sd if sd > 1e-12 else 1.0
            stats[t] = (mu, sd)

            # raw id → vector maps (names converted once, reused thrice)
            us = [_py(x) for x in df[ucol][mask]]
            rs = [_py(x) for x in df[rcol][mask]]
            user_maps[t] = {name: U[int(idx) - 1]
                            for name, idx in zip(us, sub_u)}
            res_maps[t] = {name: V[int(idx) - 1]
                           for name, idx in zip(rs, sub_r)}
            seen[t] = set(zip(us, rs))
            comps[t] = ConnectedComponents.components(us, rs)

        m = AccessAnomalyModel()
        m.set(tenant_col=tcol, user_col=ucol, res_col=rcol,
              output_col=self.get("output_col"))
        m._state = {"user_maps": user_maps, "res_maps": res_maps,
                    "stats": stats, "seen": seen, "comps": comps}
        # ALS (uploads, solves and the factors' copy back) and the rest
        m.phase_seconds = {"als": als_s,
                           "host": time.perf_counter() - t0 - als_s}
        return m


class AccessAnomalyModel(Model):
    """Scores = z-normalized *negative* likelihood: higher ⇒ more anomalous."""

    tenant_col = Param(str, default="tenant", doc="tenant column")
    user_col = Param(str, default="user", doc="user column")
    res_col = Param(str, default="res", doc="resource column")
    output_col = Param(str, default="anomaly_score", doc="score column")
    preserve_history = Param(bool, default=True,
                             doc="seen (tenant,user,res) triples score 0")

    #: fitted state (maps/stats); persisted via _save_extra
    _state: Optional[dict] = None

    def _transform(self, df: DataFrame) -> DataFrame:
        s = self._state
        assert s is not None, "model has no fitted state"
        tcol, ucol, rcol = (self.get("tenant_col"), self.get("user_col"),
                            self.get("res_col"))
        out = np.empty(len(df), dtype=object)
        for i, (t, u, r) in enumerate(zip(df[tcol], df[ucol], df[rcol])):
            t, u, r = _py(t), _py(u), _py(r)
            umap = s["user_maps"].get(t, {})
            rmap = s["res_maps"].get(t, {})
            if self.get("preserve_history") and (u, r) in s["seen"].get(t, ()):
                out[i] = 0.0
                continue
            uv, rv = umap.get(u), rmap.get(r)
            if uv is None or rv is None:
                out[i] = None
                continue
            ucomp, rcomp = s["comps"][t]
            if ucomp.get(u) != rcomp.get(r):
                out[i] = float("inf")
                continue
            mu, sd = s["stats"][t]
            likelihood_z = (float(np.dot(uv, rv)) - mu) / sd
            out[i] = -likelihood_z   # low likelihood ⇒ high anomaly
        return df.with_column(self.get("output_col"), out)

    # -- persistence of the fitted maps --------------------------------------
    def _save_extra(self, path: str) -> None:
        import json
        import os
        s = self._state
        blob = {
            "stats": [[t, mu, sd] for t, (mu, sd) in s["stats"].items()],
            "seen": [[t, sorted([list(p) for p in pairs])]
                     for t, pairs in s["seen"].items()],
            "comps": [[t, list(c[0].items()), list(c[1].items())]
                      for t, c in s["comps"].items()],
            "user_keys": [[t, list(m.keys())] for t, m in s["user_maps"].items()],
            "res_keys": [[t, list(m.keys())] for t, m in s["res_maps"].items()],
            "factors_format": "ordinal_v2",
        }
        with open(os.path.join(path, "state.json"), "w") as f:
            json.dump(blob, f)
        # arrays keyed by tenant *ordinal* (u_0, r_0, ...): tenant names can
        # contain zip-hostile characters ('/', ...); the tenant order is the
        # order of user_keys/res_keys in state.json
        arrays = {}
        for i, (t, m) in enumerate(s["user_maps"].items()):
            arrays[f"u_{i}"] = np.stack(list(m.values())) if m else np.zeros((0, 1))
        for i, (t, m) in enumerate(s["res_maps"].items()):
            arrays[f"r_{i}"] = np.stack(list(m.values())) if m else np.zeros((0, 1))
        np.savez(os.path.join(path, "factors.npz"), **arrays)

    def _load_extra(self, path: str) -> None:
        import json
        import os
        with open(os.path.join(path, "state.json")) as f:
            blob = json.load(f)
        z = np.load(os.path.join(path, "factors.npz"))
        s = {"user_maps": {}, "res_maps": {}, "stats": {}, "seen": {},
             "comps": {}}
        for t, mu, sd in blob["stats"]:
            s["stats"][t] = (mu, sd)
        for t, pairs in blob["seen"]:
            s["seen"][t] = set(tuple(p) for p in pairs)
        for t, uc, rc in blob["comps"]:
            s["comps"][t] = (dict((k, v) for k, v in uc),
                             dict((k, v) for k, v in rc))
        # explicit format marker — key-presence probing would misroute legacy
        # archives whose tenant names are themselves numeric strings
        ordinal = blob.get("factors_format") == "ordinal_v2"
        for j, (t, keys) in enumerate(blob["user_keys"]):
            U = z[f"u_{j}"] if ordinal else z[f"u_{t}"]
            s["user_maps"][t] = {k: U[i] for i, k in enumerate(keys)}
        for j, (t, keys) in enumerate(blob["res_keys"]):
            V = z[f"r_{j}"] if ordinal else z[f"r_{t}"]
            s["res_maps"][t] = {k: V[i] for i, k in enumerate(keys)}
        self._state = s

"""Synthetic access-log generator for CyberML demos and tests.

Parity: ``synapse/ml/cyber/dataset.py`` ``DataFactory`` — two user/resource
clusters ("HR" and "FIN"); training data stays within clusters,
*intra*-cluster test pairs are unseen-but-normal, *inter*-cluster pairs are
the anomalies a fitted :class:`AccessAnomaly` should score high.

The port's copy of ``mmlspark_tpu/cyber/dataset.py``
(numpy only, host work).
"""

from __future__ import annotations

import numpy as np

from ..core.dataframe import DataFrame, object_col

__all__ = ["DataFactory"]


class DataFactory:
    def __init__(self, num_hr_users: int = 25, num_hr_resources: int = 50,
                 num_fin_users: int = 35, num_fin_resources: int = 75,
                 single_component: bool = True, seed: int = 0):
        self.hr_users = [f"hr_user_{i}" for i in range(num_hr_users)]
        self.hr_res = [f"hr_res_{i}" for i in range(num_hr_resources)]
        self.fin_users = [f"fin_user_{i}" for i in range(num_fin_users)]
        self.fin_res = [f"fin_res_{i}" for i in range(num_fin_resources)]
        self.single_component = single_component
        self.rng = np.random.default_rng(seed)
        self._train_pairs: set = set()

    def _edges(self, users, resources, density) -> list:
        out = []
        for u in users:
            n = max(1, int(density * len(resources)))
            for r in self.rng.choice(resources, size=n, replace=False):
                out.append((u, str(r), float(self.rng.integers(1, 10))))
        return out

    def _to_df(self, tups) -> DataFrame:
        return DataFrame({
            "tenant": object_col(["t0"] * len(tups)),
            "user": object_col([t[0] for t in tups]),
            "res": object_col([t[1] for t in tups]),
            "likelihood": np.array([t[2] for t in tups]),
        })

    def create_clustered_training_data(self, ratio: float = 0.25) -> DataFrame:
        tups = (self._edges(self.hr_users, self.hr_res, ratio)
                + self._edges(self.fin_users, self.fin_res, ratio))
        if self.single_component:
            # one bridging edge keeps the graph connected (so inter-cluster
            # test pairs are scored by the model rather than short-circuited
            # to +inf by the connected-components rule)
            tups.append((self.hr_users[0], self.fin_res[0], 1.0))
        self._train_pairs = {(u, r) for u, r, _ in tups}
        return self._to_df(tups)

    def _unseen(self, users, resources, n) -> list:
        out = []
        attempts = 0
        limit = 100 * n + 1000   # bounded rejection sampling: never hang
        while len(out) < n:
            attempts += 1
            if attempts > limit:
                raise ValueError(
                    f"could not draw {n} unseen pairs from a pool of "
                    f"{len(users) * len(resources)} (training covered too "
                    "much of it); lower n or the training ratio")
            u = str(self.rng.choice(users))
            r = str(self.rng.choice(resources))
            if (u, r) not in self._train_pairs:
                out.append((u, r, 0.0))
        return out

    def create_clustered_intra_test_data(self, n: int = 50) -> DataFrame:
        half = n // 2
        return self._to_df(self._unseen(self.hr_users, self.hr_res, half)
                           + self._unseen(self.fin_users, self.fin_res,
                                          n - half))

    def create_clustered_inter_test_data(self, n: int = 50) -> DataFrame:
        half = n // 2
        return self._to_df(self._unseen(self.hr_users, self.fin_res, half)
                           + self._unseen(self.fin_users, self.hr_res,
                                          n - half))

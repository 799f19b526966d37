"""Serializable ball tree with label-conditioned search.

Parity surface: ``BallTree``/``ConditionalBallTree`` (reference
``core/.../nn/BallTree.scala:31,158``) and ``BoundedPriorityQueue:21``.

The tree is stored as flat numpy arrays (centers, radii, children, point
ranges) so it round-trips through the ComplexParam pytree codec. Search is
host-side branch-and-bound — the device path for bulk queries is the
brute-force matmul in ``knn.py``; the tree serves the
ConditionalKNN case (per-query label filters) the reference runs on the JVM.

The port's copy of ``mmlspark_tpu/nn/balltree.py`` (numpy only).
"""

from __future__ import annotations

# Deliberate host-side float64: the tree is exact branch-and-bound geometry
# on the host (reference-parity with the JVM BallTree); nothing here feeds
# a device, the bulk path in knn.py casts to float32 before the upload.

import heapq
from typing import Dict, List, Optional, Sequence

import numpy as np

__all__ = ["BallTree"]


class BallTree:
    def __init__(self, points: np.ndarray, labels: Optional[Sequence] = None,
                 leaf_size: int = 50):
        self.points = np.asarray(points, dtype=np.float64)
        self.labels = None if labels is None else np.asarray(labels)
        self.leaf_size = int(leaf_size)
        n = len(self.points)
        self.index = np.arange(n)
        centers: List[np.ndarray] = []
        radii: List[float] = []
        lefts: List[int] = []
        rights: List[int] = []
        starts: List[int] = []
        ends: List[int] = []

        def build(lo: int, hi: int) -> int:
            node = len(centers)
            pts = self.points[self.index[lo:hi]]
            center = pts.mean(axis=0)
            d = np.linalg.norm(pts - center, axis=1)
            centers.append(center)
            radii.append(float(d.max()) if len(d) else 0.0)
            lefts.append(-1)
            rights.append(-1)
            starts.append(lo)
            ends.append(hi)
            if hi - lo > self.leaf_size:
                # split on the direction between two far points (cheap 2-means)
                far1 = self.index[lo + int(np.argmax(d))]
                d2 = np.linalg.norm(pts - self.points[far1], axis=1)
                far2 = self.index[lo + int(np.argmax(d2))]
                direction = self.points[far2] - self.points[far1]
                proj = pts @ direction
                order = np.argsort(proj, kind="stable")
                self.index[lo:hi] = self.index[lo:hi][order]
                mid = (lo + hi) // 2
                lefts[node] = build(lo, mid)
                rights[node] = build(mid, hi)
            return node

        if n:
            build(0, n)
        self.centers = np.asarray(centers)
        self.radii = np.asarray(radii)
        self.lefts = np.asarray(lefts, dtype=np.int64)
        self.rights = np.asarray(rights, dtype=np.int64)
        self.starts = np.asarray(starts, dtype=np.int64)
        self.ends = np.asarray(ends, dtype=np.int64)

    # -- persistence (pytree of arrays) -------------------------------------
    def to_tree(self) -> Dict[str, np.ndarray]:
        out = {k: getattr(self, k) for k in
               ("points", "index", "centers", "radii", "lefts", "rights",
                "starts", "ends")}
        out["leaf_size"] = np.asarray(self.leaf_size)
        if self.labels is not None:
            out["labels"] = self.labels
        return out

    @classmethod
    def from_tree(cls, tree: Dict[str, np.ndarray]) -> "BallTree":
        obj = cls.__new__(cls)
        for k in ("points", "index", "centers", "radii", "lefts", "rights",
                  "starts", "ends"):
            setattr(obj, k, np.asarray(tree[k]))
        obj.leaf_size = int(np.asarray(tree["leaf_size"]))
        obj.labels = np.asarray(tree["labels"]) if "labels" in tree else None
        return obj

    # -- search -------------------------------------------------------------
    def query(self, q: np.ndarray, k: int = 1,
              allowed_labels: Optional[set] = None):
        """k nearest neighbours of ``q``; optionally restricted to points
        whose label is in ``allowed_labels`` (ConditionalBallTree.findMaximumInnerProducts
        analogue for the conditional-KNN path)."""
        if len(self.centers) == 0:
            return [], []
        q = np.asarray(q, dtype=np.float64)
        heap: List[tuple] = []  # max-heap via negated distance

        def visit(node: int):
            center_d = np.linalg.norm(q - self.centers[node])
            if len(heap) == k and center_d - self.radii[node] > -heap[0][0]:
                return
            if self.lefts[node] == -1:
                idx = self.index[self.starts[node]:self.ends[node]]
                if allowed_labels is not None:
                    mask = np.isin(self.labels[idx], list(allowed_labels))
                    idx = idx[mask]
                if len(idx) == 0:
                    return
                d = np.linalg.norm(self.points[idx] - q, axis=1)
                for dist, i in zip(d, idx):
                    if len(heap) < k:
                        heapq.heappush(heap, (-dist, int(i)))
                    elif dist < -heap[0][0]:
                        heapq.heapreplace(heap, (-dist, int(i)))
                return
            l, r = int(self.lefts[node]), int(self.rights[node])
            dl = np.linalg.norm(q - self.centers[l])
            dr = np.linalg.norm(q - self.centers[r])
            first, second = (l, r) if dl <= dr else (r, l)
            visit(first)
            visit(second)

        visit(0)
        pairs = sorted([(-nd, i) for nd, i in heap])
        return [i for _, i in pairs], [d for d, _ in pairs]

"""Anomaly-detection service transformers.

Parity: ``cognitive/.../AnomalyDetection.scala`` (249 LoC):
``DetectLastAnomaly`` / ``DetectEntireSeries(DetectAnomalies)`` POST a
``{"series": [{timestamp, value}], "granularity": ...}`` payload;
``SimpleDetectAnomalies`` groups rows by key and attaches per-row results.

The port's copy of ``mmlspark_tpu/services/anomaly.py``. With no ``url``,
``SimpleDetectAnomalies`` runs the local median/MAD z-score detector on
the card: every group at once, float32, bitwise the JAX package's jitted
``jnp.median`` arithmetic (:func:`mad_z`). ``device`` is a keyword, not a
param: ``None`` is the card and raises without one.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..core.dataframe import DataFrame, object_col
from ..core.params import Param
from ..utils.device import resolve_device
from .base import ServiceParam, ServiceTransformer

__all__ = ["AnomalyBase", "DetectLastAnomaly", "DetectAnomalies",
           "SimpleDetectAnomalies", "mad_z"]


def _group_indices(groups) -> "dict":
    """One-pass {group: np.ndarray(row indices)}, insertion-ordered."""
    bucket: dict = {}
    for i, g in enumerate(groups):
        bucket.setdefault(g, []).append(i)
    return {g: np.asarray(ix) for g, ix in bucket.items()}


class AnomalyBase(ServiceTransformer):
    series = ServiceParam(list, is_required=True,
                          doc="list of {timestamp, value} points")
    granularity = ServiceParam(str, default="daily", doc="series granularity")
    max_anomaly_ratio = ServiceParam(float, payload_name="maxAnomalyRatio",
                                     doc="expected max anomaly fraction")
    sensitivity = ServiceParam(int, doc="detector sensitivity 0-99")

    def _payload(self, row: dict):
        p = {"series": self.get_value_opt(row, "series"),
             "granularity": self.get_value_opt(row, "granularity")}
        for extra in ("max_anomaly_ratio", "sensitivity"):
            v = self.get_value_opt(row, extra)
            if v is not None:
                sp = self.params()[extra]
                p[sp.payload_name or extra] = v
        return p


class DetectLastAnomaly(AnomalyBase):
    """Parity: ``DetectLastAnomaly`` — /last endpoint semantics."""


class DetectAnomalies(AnomalyBase):
    """Parity: ``DetectEntireSeries`` — whole-series batch detection."""


class SimpleDetectAnomalies(AnomalyBase):
    """Grouped per-key detection (parity: ``SimpleDetectAnomalies``), with
    the local MAD z-score detector (:func:`mad_z`, on ``device``) when no
    service URL is set."""

    group_col = Param(str, default="group", doc="series grouping column")
    timestamp_col = Param(str, default="timestamp", doc="timestamp column")
    value_col = Param(str, default="value", doc="value column")
    local_threshold = Param(float, default=3.5, doc="local MAD z threshold")

    _device = None          # a loaded stage resolves the card on first use
    #: seconds of the last local transform: host grouping, device, dicts
    phase_seconds: dict = {}

    def __init__(self, device=None, **kw):
        super().__init__(**kw)
        # resolved now when the local detector will run (so no card
        # raises here), else when ``_local_device`` first needs it
        self._device = (resolve_device(device)
                        if device is not None or self.get_or_none("url") is None
                        else None)

    @classmethod
    def load(cls, path: str, device=None):
        stage = super().load(path)
        stage._device = None if device is None else resolve_device(device)
        return stage

    def _local_device(self):
        if self._device is None:
            self._device = resolve_device(None)
        return self._device

    def _transform(self, df: DataFrame) -> DataFrame:
        if self.get_or_none("url") is not None:
            return self._service_transform(df)
        return self._local_transform(df)

    def _service_transform(self, df: DataFrame) -> DataFrame:
        # grouped mode aggregates rows per key, so column-bound service
        # params (other than the synthesized series) cannot be resolved
        for n, p in self._service_params().items():
            tagged = self.get_or_none(n)
            if n != "series" and tagged is not None and tagged["kind"] == "col":
                raise ValueError(
                    f"SimpleDetectAnomalies: service param {n!r} is bound to a "
                    "column; grouped mode only supports scalar params")
        group_rows = _group_indices(df[self.get("group_col")])
        ts = df[self.get("timestamp_col")]
        vals = df[self.get("value_col")]
        series_col = []
        for idxs in group_rows.values():
            series_col.append([{"timestamp": str(ts[i]), "value": float(vals[i])}
                               for i in idxs])
        # ONE batched probe transform: every group's request goes through the
        # same client at the transformer's concurrency
        probe = DetectAnomalies(url=self.get("url"),
                                concurrency=self.get("concurrency"),
                                timeout=self.get("timeout"),
                                key_header=self.get("key_header"),
                                method=self.get("method"),
                                output_col="__out__", error_col="__err__")
        for n in self._service_params():   # scalar service params (key, …)
            if n != "series" and self.get_or_none(n) is not None:
                probe.set(**{n: self.get(n)})
        probe.set_vector_param("series", "__series__")
        res = probe.transform(DataFrame({"__series__": object_col(series_col)}))

        out = np.empty(len(df), dtype=object)
        errs = np.empty(len(df), dtype=object)
        for g_i, idxs in enumerate(group_rows.values()):
            parsed, err = res["__out__"][g_i], res["__err__"][g_i]
            flags = (parsed or {}).get("isAnomaly", [None] * len(idxs))
            for j, i in enumerate(idxs):
                out[i] = {"isAnomaly": flags[j] if j < len(flags) else None}
                errs[i] = err
        return (df.with_column(self.get("output_col"), out)
                  .with_column(self.get("error_col"), errs))

    def _local_transform(self, df: DataFrame) -> DataFrame:
        t0 = time.perf_counter()
        vals = np.asarray(df[self.get("value_col")], dtype=np.float32)
        groups = _group_indices(df[self.get("group_col")])
        gid = np.empty(len(vals), np.int64)
        for g, idxs in enumerate(groups.values()):
            gid[idxs] = g
        t1 = time.perf_counter()
        dev = self._local_device()
        z = mad_z(torch.from_numpy(vals).to(dev),
                  torch.from_numpy(gid).to(dev), len(groups)).cpu().numpy()
        t2 = time.perf_counter()
        thr = self.get("local_threshold")
        out = object_col([{"isAnomaly": s > thr, "score": s}
                          for s in z.tolist()])
        self.phase_seconds = {"host_grouping": t1 - t0, "device": t2 - t1,
                              "result_dicts": time.perf_counter() - t2}
        return (df.with_column(self.get("output_col"), out)
                  .with_column(self.get("error_col"),
                               object_col([None] * len(df))))


def _group_medians(v: "torch.Tensor", gid: "torch.Tensor", start, lo, hi,
                   nan_rows) -> "torch.Tensor":
    """Each group's ``jnp.median`` of ``v``: sort by value, then stably by
    group, so each group's values lie sorted in one run; the median is
    the ``method="midpoint"`` quantile, ``(low + high) * 0.5`` of the
    two middle values (equal for an odd count), NaN where the group
    holds a NaN."""
    order = torch.sort(v, stable=True).indices
    order = order[torch.sort(gid[order], stable=True).indices]
    s = v[order]
    med = (s[start + lo] + s[start + hi]) * 0.5
    return torch.where(nan_rows, torch.full_like(med, float("nan")), med)


def mad_z(v: "torch.Tensor", gid: "torch.Tensor", n_groups: int
          ) -> "torch.Tensor":
    """Per-row ``0.6745 * |v - med| / (median(|v - med|) + 1e-9)`` with
    ``med`` the median of the row's group (``gid``, 0..n_groups-1),
    float32 on ``v``'s device: the arithmetic of the JAX package's
    jitted ``mad_z`` (``jnp.median`` is ``quantile(0.5, "midpoint")``
    over the sorted values, not the lower middle value
    ``torch.median`` returns)."""
    v = v.to(torch.float32)
    counts = torch.bincount(gid, minlength=n_groups)
    start = torch.cumsum(counts, 0) - counts
    lo, hi = (counts - 1) // 2, counts // 2
    nan_rows = torch.bincount(gid, weights=torch.isnan(v).to(torch.float32),
                              minlength=n_groups) > 0
    med = _group_medians(v, gid, start, lo, hi, nan_rows)
    dev = torch.abs(v - med[gid])
    mad = _group_medians(dev, gid, start, lo, hi, nan_rows) + 1e-9
    return 0.6745 * dev / mad[gid]

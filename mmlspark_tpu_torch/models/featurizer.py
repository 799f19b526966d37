"""Transfer-learning image featurization (counterpart of
``mmlspark_tpu/models/featurizer.py``).

Parity: ``deep-learning/.../cntk/ImageFeaturizer.scala`` — wraps an inner
DNN, optionally cutting the head layers (``cutOutputLayers``,
``:100-108``): 0 = full model predictions (logits), 1 = headless features.
Auto-resizes images to the model's input shape and unrolls them into the
tensor feed (``:137-184``), dropping undecodable rows (``:176-180``).

The inner model is an :class:`~.onnx_model.ONNXModel` whose graph carries
both ``logits`` and pre-head ``feat`` outputs, so cutting layers is output
selection on the same graph (the converter prunes the unused head).

Where the work runs: the host decodes each cell to a uint8 HWC array and
nothing more. Rows of one shape are stacked and cross to the model's
device in ONE counted ingest per shape (``site="ingest"``), uint8; there
the port's one resize (:func:`~..image.unroll.resize_uint8`), the gray →
three-channel spread and the BGR → RGB swap run, and the rows land in one
resident ``(N, size, size, C)`` uint8 column in row order. The inner model
reads that column in batches of ``mini_batch_size`` (no h2d in its
runner), with ``transpose_dict`` and ``normalize_dict`` fusing the layout,
the cast and the scale/mean/std into its batch function, as in the JAX
package. A resident uint8 column (the image explainers' masked samples)
skips the host work and the ingest.

``phase_seconds`` keeps the last transform's host clock: ``host`` (decode
and stacking), ``device_prep`` (the pinned copy and the issue of the
ingest and the device prep) and ``model`` (the inner transform, which
ends in the drain's wait).
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional

import numpy as np
import torch

from ..core.dataframe import DataFrame, object_col
from ..core.params import ComplexParam, HasInputCol, HasOutputCol, Param
from ..core.pipeline import Model
from ..core.residency import DeviceColumn, make_put
from ..image.schema import ImageSchema, decode_image
from ..image.unroll import resize_uint8
from ..utils.device import resolve_device
from .onnx_model import ONNXModel

__all__ = ["ImageFeaturizer"]


class ImageFeaturizer(Model, HasInputCol, HasOutputCol):
    onnx_model = ComplexParam(default=None, doc="inner ONNXModel (or bytes)")
    cut_output_layers = Param(int, default=1,
                              doc="0 = logits, 1 = headless features "
                                  "(reference cutOutputLayers semantics)")
    input_size = Param(int, default=224, doc="model input H=W")
    channel_order = Param(str, default="rgb", choices=["rgb", "bgr"],
                          doc="channel order the model expects")
    scale = Param(float, default=1.0 / 255.0, doc="pixel scale factor")
    mean = Param((list, float), default=None, doc="per-channel mean (model order)")
    std = Param((list, float), default=None, doc="per-channel std (model order)")
    drop_na = Param(bool, default=True, doc="drop undecodable image rows")
    mini_batch_size = Param(int, default=64, doc="device batch size")
    feature_output = Param(str, default="feat", doc="graph output for features")
    logits_output = Param(str, default="logits", doc="graph output for logits")

    def __init__(self, onnx_model=None, device=None, **kw):
        """``device``: where an inner model built from bytes runs (``None``
        = the CUDA card); an ``ONNXModel`` passed in keeps its own device,
        and the image prep runs wherever the inner model runs."""
        self._device = (None if isinstance(onnx_model, ONNXModel)
                        else resolve_device(device))
        super().__init__(**kw)
        self._set_default(input_col="image", output_col="features")
        if onnx_model is not None:
            self.set(onnx_model=onnx_model)

    @classmethod
    def load(cls, path: str, device=None) -> "ImageFeaturizer":
        """Load a saved featurizer, its inner model onto ``device``."""
        stage = super().load(path)
        stage._device = resolve_device(device)
        inner = stage.get_or_none("onnx_model")
        if isinstance(inner, ONNXModel):
            inner._device = stage._device
        return stage

    def _load_extra(self, path: str) -> None:
        self._device = None

    def _inner(self) -> ONNXModel:
        m = self.get("onnx_model")
        if isinstance(m, (bytes, bytearray)):
            m = ONNXModel(bytes(m), device=self._device)
            self.set(onnx_model=m)
        if not isinstance(m, ONNXModel):
            raise TypeError("onnx_model must be an ONNXModel or ONNX bytes")
        return m

    @staticmethod
    def _prep_cell(cell) -> Optional[np.ndarray]:
        """image struct / bytes / array → HWC uint8 (BGR as stored), or
        None for a null or undecodable cell. Resize and channel order are
        left to the device."""
        if cell is None:
            return None
        if isinstance(cell, (bytes, bytearray)):
            cell = decode_image(bytes(cell))
            if cell is None:
                return None
        img = np.asarray(cell["data"] if ImageSchema.is_image(cell) else cell,
                         dtype=np.uint8)
        return img[:, :, None] if img.ndim == 2 else img

    def _device_images(self, groups: Dict[tuple, tuple], n: int,
                       device: torch.device) -> torch.Tensor:
        """``{shape: (row indices, stacked (k, H, W, C) uint8, host array
        or tensor)}`` → one ``(n, size, size, C)`` uint8 tensor on
        ``device``: one counted ingest a host shape, then resize, gray
        spread and channel swap there."""
        size = int(self.get("input_size"))
        rgb = self.get("channel_order") == "rgb"
        put = make_put(device)
        out = None
        for rows, host in groups.values():
            if isinstance(host, torch.Tensor):        # resident already
                x = host.to(device)
            else:
                x = DeviceColumn.from_host(host, [(0, len(host))],
                                           put=put).device_array()
            x = resize_uint8(x, size, size)
            if x.shape[-1] == 1:
                x = x.expand(-1, -1, -1, 3)
            if rgb and x.shape[-1] >= 3:
                perm = [2, 1, 0] + list(range(3, x.shape[-1]))
                x = x[..., perm]
            if out is None:
                out = torch.empty((n, size, size, x.shape[-1]),
                                  dtype=torch.uint8, device=device)
            elif out.shape[-1] != x.shape[-1]:
                raise ValueError(
                    f"images with {out.shape[-1]} and {x.shape[-1]} "
                    f"channels in one column")
            if len(groups) == 1:
                out = x
            else:
                out[torch.as_tensor(rows, device=device)] = x
        return out

    def _transform(self, df: DataFrame) -> DataFrame:
        inner = self._inner()
        t0 = time.perf_counter()
        name = self.get("input_col")
        if df.is_resident(name):
            # a resident uint8 (N, H, W, C) column: no host work, no ingest
            x = df.device_column(name).device_array().to(torch.uint8)
            keep = np.ones(len(x), dtype=bool)
            groups = {tuple(x.shape[1:]): (np.arange(len(x)), x)}
        else:
            imgs = [self._prep_cell(c) for c in df[name]]
            keep = np.asarray([t is not None for t in imgs], dtype=bool)
            idx: Dict[tuple, List[int]] = {}
            for i, t in enumerate(t for t in imgs if t is not None):
                idx.setdefault(t.shape, []).append(i)
            kept = [t for t in imgs if t is not None]
            groups = {s: (rows, np.stack([kept[i] for i in rows]))
                      for s, rows in idx.items()}
        cur = df
        if self.get("drop_na"):
            if not keep.all():
                cur = cur.filter(keep)
        elif not keep.all():
            raise ValueError("undecodable image rows present and drop_na=False")
        n = int(keep.sum())
        if n == 0:
            return cur.with_column(self.get("output_col"), object_col([]))
        tensor_col = "__img_tensor__"
        feed_name = list(inner.model_inputs())[0]
        out_name = (self.get("feature_output") if self.get("cut_output_layers") >= 1
                    else self.get("logits_output"))
        t1 = time.perf_counter()
        staged = cur.with_device_column(
            tensor_col, self._device_images(groups, n, inner.device))
        t2 = time.perf_counter()
        norm = {"scale": float(self.get("scale"))}
        if self.get_or_none("mean") is not None:
            norm["mean"] = [float(v) for v in np.atleast_1d(self.get("mean"))]
        if self.get_or_none("std") is not None:
            norm["std"] = [float(v) for v in np.atleast_1d(self.get("std"))]
        inner = inner.copy({"feed_dict": {feed_name: tensor_col},
                            "fetch_dict": {self.get("output_col"): out_name},
                            "mini_batch_size": self.get("mini_batch_size"),
                            # uint8 NHWC resident; layout + normalize fuse
                            # into the batch function on the device
                            "transpose_dict": {feed_name: [0, 3, 1, 2]},
                            "normalize_dict": {feed_name: norm}})
        out = inner.transform(staged)
        self.phase_seconds = {"host": t1 - t0, "device_prep": t2 - t1,
                              "model": time.perf_counter() - t2}
        return out.drop(tensor_col)

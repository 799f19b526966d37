"""Unroll/resize stages and the port's one image resize (counterpart of
``mmlspark_tpu/image/unroll.py``).

Parity: ``core/.../image/UnrollImage.scala:31-152`` (HWC uint8 image →
flat CHW double vector, with ``roll`` inverse), ``UnrollBinaryImage:187``
(decode+resize+unroll straight from compressed bytes), and
``ResizeImageTransformer.scala:59`` (resize without the OpenCV module).

**One resize.** The JAX package resizes with ``cv2.resize`` (bilinear)
when cv2 imports, else with PIL's bicubic: which one runs depends on the
machine. The port has one resize on every device, :func:`resize_uint8`:
bilinear over half-pixel centres with no antialiasing (OpenCV's
``INTER_LINEAR``), computed in float64 with ``F.interpolate`` and rounded
half to even, uint8 in and uint8 out. Float64 makes the card and the CPU
agree to the level. Against ``cv2.resize`` it differs by at most one level
(OpenCV rounds 11-bit fixed-point weights).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..core.dataframe import DataFrame, object_col
from ..core.params import HasInputCol, HasOutputCol, Param
from ..core.pipeline import Transformer
from .schema import decode_image, make_image

__all__ = ["unroll", "roll", "resize_uint8", "UnrollImage",
           "UnrollBinaryImage", "ResizeImageTransformer"]

#: images a resize call interpolates at once (float64 working copies)
_RESIZE_CHUNK = 256


def unroll(image: dict) -> np.ndarray:
    """HWC uint8 → flat float64 vector in CHW order
    (parity: ``UnrollImage.unroll:31-56``)."""
    data = np.asarray(image["data"], dtype=np.uint8)
    return np.transpose(data, (2, 0, 1)).astype(np.float64).ravel()


def roll(values: np.ndarray, like: dict) -> dict:
    """Inverse of :func:`unroll` (parity: ``UnrollImage.roll:58-127``)."""
    h, w, c = like["height"], like["width"], like["nChannels"]
    arr = np.clip(np.round(np.asarray(values, np.float64)), 0, 255)
    chw = arr.reshape(c, h, w).astype(np.uint8)
    return make_image(np.transpose(chw, (1, 2, 0)), like.get("origin", ""))


def resize_uint8(x: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """Bilinear resize of uint8 images on their own device: ``(N, H, W,
    C)`` or ``(H, W, C)`` in, the same layout at ``(height, width)`` out.
    A batch already at the size comes back as it is."""
    if x.dtype != torch.uint8:
        raise TypeError(f"resize_uint8 takes uint8 images, not {x.dtype}")
    single = x.ndim == 3
    if single:
        x = x[None]
    if tuple(x.shape[1:3]) == (height, width):
        return x[0] if single else x
    out = torch.empty((x.shape[0], height, width, x.shape[3]),
                      dtype=torch.uint8, device=x.device)
    for lo in range(0, x.shape[0], _RESIZE_CHUNK):
        y = x[lo:lo + _RESIZE_CHUNK].permute(0, 3, 1, 2).to(torch.float64)
        y = F.interpolate(y, size=(height, width), mode="bilinear",
                          align_corners=False, antialias=False)
        out[lo:lo + _RESIZE_CHUNK] = y.round_().clamp_(0, 255).permute(
            0, 2, 3, 1).to(torch.uint8)
    return out[0] if single else out


def _resize(img: np.ndarray, height: int, width: int) -> np.ndarray:
    """One HWC uint8 host image through :func:`resize_uint8` on the CPU."""
    img = np.asarray(img, dtype=np.uint8)
    if img.ndim == 2:
        img = img[:, :, None]
    return resize_uint8(torch.from_numpy(np.ascontiguousarray(img)),
                        height, width).numpy()


class UnrollImage(Transformer, HasInputCol, HasOutputCol):
    """Image struct column → flat float vector column."""

    def __init__(self, **kw):
        super().__init__(**kw)
        self._set_default(input_col="image", output_col="<image>")

    def _transform(self, df: DataFrame) -> DataFrame:
        col = df[self.get("input_col")]
        return df.with_column(
            self.get("output_col"),
            object_col([None if c is None else unroll(c) for c in col]))


class UnrollBinaryImage(Transformer, HasInputCol, HasOutputCol):
    """Compressed bytes column → decode (+optional resize) → flat vector
    (parity: ``UnrollBinaryImage:187``, ``unrollBytes:129-150``)."""

    height = Param(int, default=None, doc="resize height (optional)")
    width = Param(int, default=None, doc="resize width (optional)")

    def __init__(self, **kw):
        super().__init__(**kw)
        self._set_default(input_col="image", output_col="<image>")

    def _transform(self, df: DataFrame) -> DataFrame:
        h, w = self.get_or_none("height"), self.get_or_none("width")
        out = []
        for c in df[self.get("input_col")]:
            if c is None:
                out.append(None)
                continue
            img = decode_image(bytes(c)) if isinstance(c, (bytes, bytearray)) else c
            if img is None:
                out.append(None)
                continue
            data = img["data"]
            if h is not None and w is not None:
                data = _resize(data, h, w)
            out.append(unroll(make_image(data, img.get("origin", ""))))
        return df.with_column(self.get("output_col"), object_col(out))


class ResizeImageTransformer(Transformer, HasInputCol, HasOutputCol):
    """Resize image structs (parity: ``ResizeImageTransformer.scala:59``)."""

    height = Param(int, doc="target height")
    width = Param(int, doc="target width")

    def __init__(self, **kw):
        super().__init__(**kw)
        self._set_default(input_col="image", output_col="image")

    def _transform(self, df: DataFrame) -> DataFrame:
        h, w = self.get("height"), self.get("width")
        out = []
        for c in df[self.get("input_col")]:
            if c is None:
                out.append(None)
                continue
            if isinstance(c, (bytes, bytearray)):
                c = decode_image(bytes(c))
                if c is None:
                    out.append(None)
                    continue
            out.append(make_image(_resize(np.asarray(c["data"], np.uint8), h, w),
                                  c.get("origin", "")))
        return df.with_column(self.get("output_col"), object_col(out))

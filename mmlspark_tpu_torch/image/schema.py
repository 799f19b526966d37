"""Image struct schema + codecs (the port's copy of
``mmlspark_tpu/image/schema.py``).

Parity: Spark's ``ImageSchema`` rows (origin/height/width/nChannels/mode/data)
used throughout the reference (``core/.../core/schema/ImageSchemaUtils``,
``io/image/ImageUtils.scala``). An image cell here is a dict:

    {"origin": str, "height": int, "width": int, "nChannels": int,
     "mode": int, "data": np.uint8 HWC array (BGR channel order)}

BGR matches OpenCV/Spark so the stage algebra behaves identically.

Decoding needs an image library: ``cv2`` (OpenCV), else ``PIL`` (Pillow),
in the JAX package's order; encoding needs cv2. Unlike the JAX package, a
missing library is not an undecodable image: with neither installed,
:func:`decode_image` raises ``ImportError`` naming both, instead of
turning every row into None (which ``ImageFeaturizer(drop_na=True)`` would
then drop silently). Bytes that a present library cannot decode still
give None.
"""

from __future__ import annotations

import io
from typing import Optional

import numpy as np

__all__ = ["ImageSchema", "make_image", "decode_image", "encode_image",
           "to_nchw_tensor", "to_nhwc_tensor"]

_NO_DECODER = ("no image decoder is installed: decoding needs cv2 "
             "(opencv-python) or PIL (Pillow); pass image structs or uint8 "
             "HWC arrays instead of compressed bytes")


class ImageSchema:
    """Mode constants (subset of OpenCV type codes Spark uses)."""
    OCV_8UC1 = 0
    OCV_8UC3 = 16
    OCV_8UC4 = 24

    FIELDS = ("origin", "height", "width", "nChannels", "mode", "data")

    @staticmethod
    def is_image(value) -> bool:
        return isinstance(value, dict) and {"height", "width", "data"} <= set(value)


def make_image(data: np.ndarray, origin: str = "") -> dict:
    """Wrap an HWC uint8 array (BGR) as an image struct."""
    data = np.asarray(data, dtype=np.uint8)
    if data.ndim == 2:
        data = data[:, :, None]
    h, w, c = data.shape
    mode = {1: ImageSchema.OCV_8UC1, 3: ImageSchema.OCV_8UC3,
            4: ImageSchema.OCV_8UC4}.get(c, ImageSchema.OCV_8UC3)
    return {"origin": origin, "height": h, "width": w, "nChannels": c,
            "mode": mode, "data": data}


def _decoder():
    """``("cv2", module)`` or ``("pil", PIL.Image)``; ImportError naming
    both libraries when neither imports."""
    try:
        import cv2
        return "cv2", cv2
    except ImportError:
        pass
    try:
        from PIL import Image
        return "pil", Image
    except ImportError:
        raise ImportError(_NO_DECODER) from None


def decode_image(raw: bytes, origin: str = "") -> Optional[dict]:
    """Compressed bytes → image struct (parity: ``ImageTransformer.decodeImage``
    ``:309`` / ``ImageUtils.safeRead``). Returns None on undecodable input;
    raises ImportError when no codec is installed."""
    kind, lib = _decoder()
    try:
        if kind == "cv2":
            img = lib.imdecode(np.frombuffer(raw, dtype=np.uint8),
                               lib.IMREAD_UNCHANGED)
            return None if img is None else make_image(img, origin)
        rgb = np.asarray(lib.open(io.BytesIO(raw)).convert("RGB"))
        return make_image(rgb[:, :, ::-1], origin)  # RGB → BGR
    except Exception:
        return None


def encode_image(image: dict, ext: str = ".png") -> bytes:
    """Image struct → compressed bytes (parity: ``encodeImage:408``);
    needs cv2, as in the JAX package."""
    import cv2
    ok, buf = cv2.imencode(ext, image["data"])
    if not ok:
        raise ValueError(f"could not encode image as {ext}")
    return bytes(buf)


def _normalize(batch: np.ndarray, scale: float, mean, std) -> np.ndarray:
    x = batch.astype(np.float32) * np.float32(scale)
    if mean is not None:
        x = x - np.asarray(mean, np.float32)
    if std is not None:
        x = x / np.asarray(std, np.float32)
    return x


def to_nhwc_tensor(images, scale: float = 1.0, mean=None, std=None,
                   bgr_to_rgb: bool = False) -> np.ndarray:
    """Batch of same-shape image structs → (N,H,W,C) float32 on the host."""
    batch = np.stack([im["data"] for im in images])
    if bgr_to_rgb and batch.shape[-1] >= 3:
        batch = batch[..., [2, 1, 0] + list(range(3, batch.shape[-1]))]
    return _normalize(batch, scale, mean, std)


def to_nchw_tensor(images, scale: float = 1.0, mean=None, std=None,
                   bgr_to_rgb: bool = False) -> np.ndarray:
    """Same, transposed to (N,C,H,W) — the ONNX convention (parity with the
    reference's CHW tensor output, ``ImageTransformer.scala:417+``).
    mean/std are per-channel (C,), applied before the transpose."""
    x = to_nhwc_tensor(images, scale, mean, std, bgr_to_rgb)
    return np.ascontiguousarray(np.transpose(x, (0, 3, 1, 2)))

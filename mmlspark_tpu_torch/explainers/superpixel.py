"""SLIC-style superpixel segmentation and image masking (counterpart of
``mmlspark_tpu/explainers/superpixel.py``).

Parity surface: ``Superpixel`` (reference ``core/.../lime/Superpixel.scala:148``
— SLIC-like clustering used to build image interpretable features for
ImageLIME/ImageSHAP): k-means over (x, y, rgb) space.

:func:`slic_superpixels` gives the JAX package's labels bit for bit while
its (pixels × centres) distances run on a device: each distance is the
same float64 operations in the same order (``dy² + dx²`` times the
spatial weight, plus ``(c₀² + c₁²) + c₂²``), one elementwise PyTorch op at
a time, so every value is the same correctly rounded double; the first
minimum wins the argmin as in numpy; the centres are then updated on the
host with ``np.bincount``, whose sums run in the order the JAX package's
masked means sum. :func:`mask_samples` builds an image's masked samples
on a device.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.params import HasInputCol, HasOutputCol, Param
from ..core.pipeline import Transformer
from ..image.schema import ImageSchema
from ..utils.device import OnDevice, resolve_device

__all__ = ["slic_superpixels", "mask_image", "mask_samples",
           "SuperpixelTransformer"]


def slic_superpixels(image: np.ndarray, cell_size: int = 16,
                     modifier: float = 10.0, iters: int = 5,
                     device=None) -> np.ndarray:
    """Segment an (H, W, C) image into superpixels, the distances on
    ``device`` (``None`` = the CUDA card).

    Returns an (H, W) int array of segment labels. ``cell_size`` plays the
    role of the reference's ``cellSize``; ``modifier`` balances color vs
    spatial distance.
    """
    dev = resolve_device(device)
    H, W = image.shape[:2]
    img = image.astype(np.float64)
    if img.ndim == 2:
        img = img[..., None]
    gy = np.arange(cell_size // 2, H, cell_size)
    gx = np.arange(cell_size // 2, W, cell_size)
    # tiny images: degrade to (at least) a single centered cell
    if len(gy) == 0:
        gy = np.array([H // 2])
    if len(gx) == 0:
        gx = np.array([W // 2])
    centers_yx = np.array([(y, x) for y in gy for x in gx], dtype=np.float64)
    k = len(centers_yx)
    centers_rgb = img[centers_yx[:, 0].astype(int), centers_yx[:, 1].astype(int)]

    yy, xx = np.mgrid[0:H, 0:W]
    coords = np.stack([yy.ravel(), xx.ravel()], axis=1).astype(np.float64)
    pix = img.reshape(-1, img.shape[-1])
    s2 = (modifier / cell_size) ** 2
    coords_d = torch.from_numpy(coords).to(dev)
    pix_d = torch.from_numpy(np.ascontiguousarray(pix)).to(dev)

    labels = np.zeros(H * W, dtype=np.int64)
    for _ in range(iters):
        # distance to every center: color + scaled spatial
        cyx = torch.from_numpy(centers_yx).to(dev)
        crgb = torch.from_numpy(centers_rgb).to(dev)
        sp = coords_d[:, 0:1] - cyx[None, :, 0]
        sp = sp * sp
        t = coords_d[:, 1:2] - cyx[None, :, 1]
        sp = sp + t * t
        col = pix_d[:, 0:1] - crgb[None, :, 0]
        col = col * col
        for ch in range(1, pix.shape[1]):
            t = pix_d[:, ch:ch + 1] - crgb[None, :, ch]
            col = col + t * t
        labels = torch.argmin(col + sp * s2, dim=1).cpu().numpy()
        count = np.bincount(labels, minlength=k)
        seen = count > 0
        for centers, vals in ((centers_yx, coords), (centers_rgb, pix)):
            for j in range(vals.shape[1]):
                sums = np.bincount(labels, weights=vals[:, j], minlength=k)
                centers[seen, j] = sums[seen] / count[seen]
    # compact label ids
    _, labels = np.unique(labels, return_inverse=True)
    return labels.reshape(H, W)


def mask_image(image: np.ndarray, segments: np.ndarray, keep: np.ndarray,
               background: float = 0.0) -> np.ndarray:
    """Zero out (or fill) all segments not in ``keep`` (a bool vector over
    segment ids) — the LIME image perturbation, on the host."""
    mask = keep[segments]
    out = np.where(mask[..., None] if image.ndim == 3 else mask,
                   image, background)
    return out.astype(image.dtype)


def mask_samples(image: np.ndarray, segments: np.ndarray, states: np.ndarray,
                 background: float = 0.0, device=None) -> torch.Tensor:
    """:func:`mask_image` of ``image`` for each row of ``states`` (m, k),
    built on ``device`` (``None`` = the CUDA card): an (m,) + image.shape
    tensor, equal to the per-sample host masks bit for bit (the fill is
    cast to the image's dtype as ``mask_image``'s result is)."""
    dev = resolve_device(device)
    fill = np.asarray(background, dtype=np.float64).astype(image.dtype)
    img = torch.from_numpy(np.ascontiguousarray(image)).to(dev)
    seg = torch.from_numpy(np.ascontiguousarray(segments)).to(dev)
    keep = torch.from_numpy(np.ascontiguousarray(states)).to(dev)[:, seg]
    if image.ndim == 3:
        keep = keep[..., None]
    return torch.where(keep, img, torch.from_numpy(fill).to(dev))


class SuperpixelTransformer(OnDevice, Transformer, HasInputCol, HasOutputCol):
    """Decompose each image row into superpixel segment labels (the
    distances on the stage's ``device``).

    Parity surface: ``SuperpixelTransformer``
    (``core/.../lime/SuperpixelTransformer.scala:37-64`` — cellSize/modifier
    params over the SLIC clustering). Output rows are (H, W) int arrays of
    segment ids, the form :func:`mask_image` and the image explainers
    consume (the reference's SuperpixelData cluster lists are the same
    partition, stored the JVM way).
    """

    cell_size = Param(int, default=16, doc="superpixel grid cell size")
    modifier = Param(float, default=10.0,
                     doc="spatial-vs-color distance trade-off")

    def __init__(self, **kw):
        super().__init__(**kw)
        self._set_default(input_col="image", output_col="superpixels")

    def _transform(self, df):
        ic, oc = self.get("input_col"), self.get("output_col")
        cs, mod = int(self.get("cell_size")), float(self.get("modifier"))
        out = np.empty(len(df), dtype=object)
        for i, img in enumerate(df[ic]):
            if img is None:                 # undecodable upstream image rows
                out[i] = None               # propagate, like sibling stages
                continue
            if ImageSchema.is_image(img):
                img = img["data"]
            out[i] = slic_superpixels(np.asarray(img), cs, mod,
                                      device=self.device)
        return df.with_column(oc, out)

"""Explainers (counterpart of ``mmlspark_tpu/explainers/``): LIME, KernelSHAP
and ICE over any inner model, SLIC superpixels, and the batched surrogate
solves they share."""

from .base import LocalExplainer, shapley_kernel_weights
from .ice import ICETransformer
from .lime import ImageLIME, TabularLIME, TextLIME, VectorLIME
from .regression import batched_lasso, batched_weighted_lstsq
from .shap import ImageSHAP, TabularSHAP, TextSHAP, VectorSHAP
from .superpixel import (SuperpixelTransformer, mask_image, mask_samples,
                         slic_superpixels)

__all__ = [
    "LocalExplainer", "shapley_kernel_weights",
    "VectorLIME", "TabularLIME", "TextLIME", "ImageLIME",
    "VectorSHAP", "TabularSHAP", "TextSHAP", "ImageSHAP",
    "ICETransformer",
    "batched_lasso", "batched_weighted_lstsq",
    "slic_superpixels", "mask_image", "mask_samples",
    "SuperpixelTransformer",
]

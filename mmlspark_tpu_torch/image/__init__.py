"""Image pipeline stages (counterpart of ``mmlspark_tpu/image/``).

Parity surface: the reference's ``opencv`` module
(``opencv/.../ImageTransformer.scala``, ``ImageSetAugmenter.scala``) and the
JVM-side image helpers in core
(``image/UnrollImage.scala``, ``image/ResizeImageTransformer.scala``).

Decode and the stage ops run on the host on uint8 HWC arrays, with no
image library but for decoding compressed bytes (:mod:`.schema`); the one
resize (:func:`~.unroll.resize_uint8`) and normalization to float tensors
(:func:`~.transforms.normalize_program`) run on whichever device holds
the batch.
"""

from .schema import (ImageSchema, decode_image, encode_image, make_image,
                     to_nchw_tensor, to_nhwc_tensor)
from .transforms import (Blur, CenterCropImage, ColorFormat, CropImage, Flip,
                         GaussianKernel, ImageTransformer, ResizeImage,
                         Threshold)
from .unroll import (ResizeImageTransformer, UnrollBinaryImage, UnrollImage,
                     resize_uint8)
from .augment import ImageSetAugmenter

__all__ = [
    "ImageSchema", "make_image", "decode_image", "encode_image",
    "to_nchw_tensor", "to_nhwc_tensor", "ImageTransformer", "ResizeImage",
    "CropImage", "CenterCropImage", "ColorFormat", "Blur", "Threshold",
    "GaussianKernel", "Flip", "UnrollImage", "UnrollBinaryImage",
    "ResizeImageTransformer", "ImageSetAugmenter", "resize_uint8",
]

"""Image file ingestion (the port's copy of ``mmlspark_tpu/io/image_io.py``).

Parity: ``io/image/ImageUtils.scala:163`` + the patched Spark image source
(``org/apache/spark/ml/source/image/PatchedImageFileFormat.scala``):
read files/dirs into an image-struct column, silently dropping (or keeping
as null) undecodable files like Spark's ``dropImageFailures``. Decoding
needs cv2 or PIL (:func:`~..image.schema.decode_image` raises ImportError
naming both when neither is installed).
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ..core.dataframe import DataFrame, object_col
from ..image.schema import decode_image
from .binary import read_binary_files

__all__ = ["read_images"]


def read_images(path: str, recursive: bool = True,
                pattern: Optional[str] = None,
                drop_failures: bool = True, sample_ratio: float = 1.0,
                seed: int = 0, npartitions: int = 1,
                image_col: str = "image") -> DataFrame:
    raw = read_binary_files(path, recursive, pattern, sample_ratio, seed,
                            inspect_zip=True, npartitions=npartitions)
    images = [decode_image(b, origin=p)
              for p, b in zip(raw["path"], raw["bytes"])]
    df = DataFrame({"path": raw["path"], image_col: object_col(images)},
                   npartitions=npartitions)
    if drop_failures:
        mask = np.asarray([im is not None for im in images], dtype=bool)
        df = df.filter(mask)
    return df

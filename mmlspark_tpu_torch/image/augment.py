"""Flip-based image-set augmentation (the port's copy of
``mmlspark_tpu/image/augment.py``).

Parity: ``opencv/.../ImageSetAugmenter.scala`` — emits the original rows
plus optional left-right / up-down flipped copies (doubling/tripling the
dataset for training).
"""

from __future__ import annotations

from ..core.dataframe import DataFrame, concat
from ..core.params import HasInputCol, HasOutputCol, Param
from ..core.pipeline import Transformer
from .transforms import Flip, ImageTransformer

__all__ = ["ImageSetAugmenter"]


class ImageSetAugmenter(Transformer, HasInputCol, HasOutputCol):
    flip_left_right = Param(bool, default=True, doc="add LR-flipped copies")
    flip_up_down = Param(bool, default=False, doc="add UD-flipped copies")

    def __init__(self, **kw):
        super().__init__(**kw)
        self._set_default(input_col="image", output_col="image")

    def _transform(self, df: DataFrame) -> DataFrame:
        ic, oc = self.get("input_col"), self.get("output_col")
        base = df.with_column(oc, df[ic]) if oc != ic else df
        parts = [base]
        if self.get("flip_left_right"):
            t = ImageTransformer(input_col=ic, output_col=oc,
                                 stages=[Flip(Flip.FLIP_LEFT_RIGHT)])
            parts.append(t.transform(df))
        if self.get("flip_up_down"):
            t = ImageTransformer(input_col=ic, output_col=oc,
                                 stages=[Flip(Flip.FLIP_UP_DOWN)])
            parts.append(t.transform(df))
        return concat(parts, npartitions=df.npartitions)

"""High-level train wrappers.

Parity surface: ``TrainClassifier`` (reference
``core/.../train/TrainClassifier.scala:50``) and ``TrainRegressor``
(``TrainRegressor.scala:21``): auto-featurize the input columns, index the
label, fit the wrapped learner, and return a model that featurizes + scores in
one transform.

The port's copy of ``mmlspark_tpu/train/train.py``. ``device`` is a
constructor keyword, not a persisted param, and reaches only the default
learner (``LogisticRegression`` / ``LinearRegression``, which fit on the
card): ``None`` is the CUDA card and raises without one, so neither
wrapper falls back to the CPU; tests pass ``"cpu"``. A learner given as
``model`` keeps its own device.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ..core.dataframe import DataFrame
from ..core.params import ComplexParam, HasFeaturesCol, HasLabelCol, Param
from ..core.pipeline import Estimator, Model
from ..core.schema import set_label_metadata
from ..featurize import Featurize
from ..utils.device import resolve_device

__all__ = ["TrainClassifier", "TrainRegressor", "TrainedClassifierModel",
           "TrainedRegressorModel"]


class _TrainBase(Estimator, HasLabelCol, HasFeaturesCol):
    model = ComplexParam(default=None, doc="inner learner (Estimator)")
    num_features = Param(int, default=1 << 8, doc="hash space for text columns")

    _device = None          # a loaded wrapper resolves the card on first use

    def __init__(self, model: Optional[Estimator] = None, device=None, **kw):
        super().__init__(**kw)
        if model is not None:
            self.set(model=model)
        # resolved now when the default learner will run (so no card
        # raises here), else when ``_default_device`` first needs it
        self._device = (resolve_device(device)
                        if model is None or device is not None else None)

    @classmethod
    def load(cls, path: str, device=None):
        stage = super().load(path)
        stage._device = None if device is None else resolve_device(device)
        return stage

    def _default_device(self):
        if self._device is None:
            self._device = resolve_device(None)
        return self._device

    def _feature_cols(self, df: DataFrame):
        label = self.get("label_col")
        return [c for c in df.columns if c != label]

    def _fit_featurizer(self, df: DataFrame):
        feat = Featurize(self._feature_cols(df),
                         output_col=self.get("features_col"),
                         num_features=self.get("num_features"))
        fmodel = feat.fit(df)
        return fmodel, fmodel.transform(df)


class TrainClassifier(_TrainBase):
    """Auto-featurize + index labels + fit a classifier."""

    def _fit(self, df: DataFrame) -> "TrainedClassifierModel":
        from ..models.linear import LogisticRegression
        learner = (self.get("model")
                   or LogisticRegression(device=self._default_device()))
        label = self.get("label_col")

        fmodel, featurized = self._fit_featurizer(df)
        classes, y = np.unique(df[label], return_inverse=True)
        featurized = featurized.with_column(label, y.astype(np.int64))
        featurized = set_label_metadata(featurized, label,
                                        num_classes=len(classes),
                                        classes=classes)
        learner = learner.copy({"features_col": self.get("features_col"),
                                "label_col": label})
        inner = learner.fit(featurized)
        m = TrainedClassifierModel()
        m.set(label_col=label, features_col=self.get("features_col"),
              featurizer=fmodel, inner_model=inner,
              classes=[c.item() if isinstance(c, np.generic) else c
                       for c in classes])
        return m


class TrainedClassifierModel(Model, HasLabelCol, HasFeaturesCol):
    featurizer = ComplexParam(default=None, doc="fitted FeaturizeModel")
    inner_model = ComplexParam(default=None, doc="fitted classifier")
    classes = Param(list, default=[], doc="original label values by index")

    def _transform(self, df: DataFrame) -> DataFrame:
        featurized = self.get("featurizer").transform(df)
        out = self.get("inner_model").transform(featurized)
        inner = self.get("inner_model")
        pred_col = inner.get("prediction_col") if inner.has_param(
            "prediction_col") else "prediction"
        classes = self.get("classes")
        if pred_col in out:
            pred = out[pred_col]
            if pred.dtype != object and np.issubdtype(pred.dtype, np.number):
                idx = np.clip(pred.astype(np.int64), 0, len(classes) - 1)
                mapped = np.asarray([classes[i] for i in idx])
                out = out.with_column(pred_col, mapped)
        return set_label_metadata(out, pred_col, num_classes=len(classes),
                                  classes=classes)


class TrainRegressor(_TrainBase):
    def _fit(self, df: DataFrame) -> "TrainedRegressorModel":
        from ..models.linear import LinearRegression
        learner = (self.get("model")
                   or LinearRegression(device=self._default_device()))
        label = self.get("label_col")
        fmodel, featurized = self._fit_featurizer(df)
        learner = learner.copy({"features_col": self.get("features_col"),
                                "label_col": label})
        inner = learner.fit(featurized)
        m = TrainedRegressorModel()
        m.set(label_col=label, features_col=self.get("features_col"),
              featurizer=fmodel, inner_model=inner)
        return m


class TrainedRegressorModel(Model, HasLabelCol, HasFeaturesCol):
    featurizer = ComplexParam(default=None, doc="fitted FeaturizeModel")
    inner_model = ComplexParam(default=None, doc="fitted regressor")

    def _transform(self, df: DataFrame) -> DataFrame:
        featurized = self.get("featurizer").transform(df)
        return self.get("inner_model").transform(featurized)

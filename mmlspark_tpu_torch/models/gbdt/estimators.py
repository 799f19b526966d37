"""LightGBM-parity estimators over the DataFrame pipeline API (counterpart
of ``models/gbdt/estimators.py``).

``LightGBMClassifier`` (binary, and multiclass when the label has more
than two classes or ``objective="multiclass"``) and ``LightGBMRegressor``
fit a :class:`Booster` through :func:`train` on the card, with the JAX
package's params, defaults and output columns: ``rawPrediction``,
``probability`` and ``prediction`` for the classifier, ``prediction``
for the regressor, the optional ``leaf_prediction_col`` and
``features_shap_col`` (TreeSHAP on the card; a multiclass model's K
blocks of F + 1 side by side), a ``validation_indicator_col`` whose rows
drive early stopping, a weight column, a warm start from
``model_string`` (a model string of either package), a starting margin
from ``init_score_col``, ``feature_importances`` and ``to_onnx``. Every
boosting mode and option of :func:`train` reaches it from the params:
``boosting_type`` (gbdt, goss, dart, rf), ``categorical_feature``,
``monotone_constraints``, ``interaction_constraints``, ``path_smooth``,
``cat_smooth``, ``min_data_per_group``, ``linear_tree`` and
``linear_lambda``; a sparse ``features`` column (scipy rows) trains on
its CSR matrix. The models' ``transform`` applies the booster's
categorical encoder and linear leaves (``Booster.predict``).

The device is a constructor (and :meth:`_LightGBMModelBase.load`)
keyword of the estimators and models, not a persisted param: ``None``
means the CUDA card, and raises without one; tests pass ``"cpu"``.

``extra_trees``, ``feature_fraction_bynode`` and step checkpoints
(``checkpoint_dir``, ``checkpoint_interval``) pass through to
:func:`train`. ``LightGBMRanker`` fits lambdarank over the query runs of
its ``group_col`` (contiguous runs of one id; an id that reappears after
another raises ValueError), and its model's ``prediction`` is the raw
score.

Not ported: ``parallelism`` other than ``"serial"`` raises
``NotImplementedError`` naming ROADMAP.md's item 31 at ``fit``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ...core.dataframe import DataFrame
from ...core.params import (ComplexParam, HasFeaturesCol, HasLabelCol,
                            HasPredictionCol, HasProbabilityCol,
                            HasWeightCol, Param)
from ...core.pipeline import Estimator, Model
from ...core.schema import assemble_features, set_label_metadata
from ...utils.device import resolve_device
from .booster import Booster, _leftover
from .train import train

__all__ = ["LightGBMClassifier", "LightGBMRegressor", "LightGBMRanker",
           "LightGBMClassificationModel", "LightGBMRegressionModel",
           "LightGBMRankerModel"]


def _str_or_str_list(v):
    """One metric name, or a list/tuple of them — anything else (ints,
    dicts, sets) is a typed error, not a silent iteration."""
    if isinstance(v, str):
        return v
    if isinstance(v, (list, tuple)):
        return [str(m) for m in v]
    raise TypeError(f"expected str or list of str, got "
                    f"{type(v).__name__}: {v!r}")


def _margins(df: DataFrame, col: str) -> np.ndarray:
    """A margin column as float64, (n,) or (n, K) (an object column of
    per-row vectors is stacked)."""
    a = df[col]
    if getattr(a, "dtype", None) == object:
        a = np.stack([np.asarray(v, dtype=np.float64) for v in a]) \
            if len(a) else np.zeros((0,))
    return np.asarray(a, dtype=np.float64)


def _object_rows(a: np.ndarray) -> np.ndarray:
    """(n, d) -> an object column of n float64 vectors."""
    out = np.empty(len(a), dtype=object)
    for i, row in enumerate(np.asarray(a, dtype=np.float64)):
        out[i] = row
    return out


class _LightGBMParams(HasFeaturesCol, HasLabelCol, HasWeightCol):
    boosting_type = Param(str, default="gbdt",
                          choices=["gbdt", "gbrt", "goss", "dart", "rf",
                                   "random_forest"],
                          doc="boosting mode (parity: LightGBMParams."
                              "boostingType, LightGBMParams.scala:389-393)")
    top_rate = Param(float, default=0.2, doc="goss: keep fraction by |grad|")
    other_rate = Param(float, default=0.1,
                       doc="goss: sampled fraction of the rest")
    drop_rate = Param(float, default=0.1, doc="dart: tree drop probability")
    max_drop = Param(int, default=50, doc="dart: max dropped trees per iter")
    skip_drop = Param(float, default=0.5,
                      doc="dart: probability of skipping the drop")
    num_iterations = Param(int, default=100, doc="boosting rounds")
    learning_rate = Param(float, default=0.1, doc="shrinkage rate")
    num_leaves = Param(int, default=31, doc="max leaves per tree")
    max_depth = Param(int, default=-1,
                      doc="max tree depth (-1: from num_leaves)")
    lambda_l1 = Param(float, default=0.0, doc="L1 regularization")
    lambda_l2 = Param(float, default=0.0, doc="L2 regularization")
    min_data_in_leaf = Param(int, default=20, doc="min rows per leaf")
    min_sum_hessian_in_leaf = Param(float, default=1e-3,
                                    doc="min hessian per leaf")
    min_gain_to_split = Param(float, default=0.0, doc="min split gain")
    feature_fraction = Param(float, default=1.0,
                             doc="feature subsample per tree")
    bagging_fraction = Param(float, default=1.0, doc="row subsample")
    bagging_freq = Param(int, default=0, doc="bagging every k iterations")
    max_bin = Param(int, default=255, doc="max histogram bins")
    early_stopping_round = Param(int, default=0,
                                 doc="early stopping patience")
    top_k = Param(int, default=20,
                  doc="voting_parallel: local feature nominations per node "
                      "(parity: LightGBMParams.topK)")
    parallelism = Param(str, default="serial",
                        choices=["serial", "data_parallel", "voting_parallel"],
                        doc="tree learner (reference LightGBMParams."
                            "parallelism); only serial is ported")
    metric = Param((str, list), default="auto",
                   converter=_str_or_str_list,
                   doc="eval metric name, or a LIST of names (all logged; "
                       "early stopping follows the first)")
    seed = Param(int, default=0, doc="random seed")
    validation_indicator_col = Param(str, default=None,
                                     doc="bool column marking validation rows")
    model_string = Param(str, default=None,
                         doc="serialized booster for warm start")
    leaf_prediction_col = Param(str, default=None,
                                doc="emit leaf indices here")
    features_shap_col = Param(str, default=None,
                              doc="emit SHAP contributions here")
    checkpoint_dir = Param(str, default=None,
                           doc="directory for step-level checkpoint/resume")
    checkpoint_interval = Param(int, default=0,
                                doc="iterations between checkpoints (0 = off)")
    categorical_feature = Param((list, int), default=[],
                                doc="feature-vector indices treated as "
                                    "categorical (label-ordered ranks)")
    enable_bundle = Param(bool, default=True,
                          doc="EFB: bundle mutually-exclusive sparse "
                              "features (LightGBM enable_bundle; active "
                              "on sparse features columns)")
    max_conflict_rate = Param(float, default=0.0,
                              doc="EFB conflict budget as a fraction of "
                                  "rows (0 = lossless bundling)")
    monotone_constraints = Param((list, int), default=[],
                                 doc="per-feature -1/0/+1 directions the "
                                     "model's predictions must respect "
                                     "(LightGBM monotone_constraints)")
    scale_pos_weight = Param(float, default=1.0,
                             doc="binary: positive-class weight multiplier "
                                 "(LightGBM scale_pos_weight)")
    is_unbalance = Param(bool, default=False,
                         doc="binary: auto-set scale_pos_weight to "
                             "neg/pos (LightGBM is_unbalance)")
    init_score_col = Param(str, default=None,
                           doc="per-row starting margin column (LightGBM "
                               "initScoreCol); predictions exclude it")
    extra_trees = Param(bool, default=False,
                        doc="extremely randomized trees: one random "
                            "threshold candidate per node x feature "
                            "(LightGBM extra_trees)")
    feature_fraction_bynode = Param(float, default=1.0,
                                    doc="feature subsample drawn per NODE "
                                        "(LightGBM feature_fraction_bynode)")
    path_smooth = Param(float, default=0.0,
                        doc="smooth node outputs toward the parent's with "
                            "this many pseudo-counts (LightGBM path_smooth)")
    boost_from_average = Param(bool, default=True,
                               doc="start boosting from the objective's "
                                   "optimal constant (LightGBM "
                                   "boost_from_average)")
    interaction_constraints = Param((list, list), default=[],
                                    doc="allowed feature groups; a branch "
                                        "only combines features sharing a "
                                        "group (LightGBM "
                                        "interaction_constraints)")
    cat_smooth = Param(float, default=10.0,
                       doc="categorical: target-mean smoothing "
                           "pseudo-count (LightGBM cat_smooth)")
    min_data_per_group = Param(int, default=0,
                               doc="categorical: pool categories rarer "
                                   "than this into one shared rank "
                                   "(LightGBM min_data_per_group)")
    linear_tree = Param(bool, default=False,
                        doc="fit a ridge model per leaf over the leaf's "
                            "path features (LightGBM linear_tree)")
    linear_lambda = Param(float, default=0.0,
                          doc="L2 on linear-leaf weights (LightGBM "
                              "linear_lambda)")

    #: where training runs; a loaded estimator (no keyword) trains on
    #: the card
    device = None

    def __init__(self, device=None, **kw):
        super().__init__(**kw)
        self.device = resolve_device(device)

    def _train_params(self, extra: dict) -> dict:
        keys = ["num_iterations", "learning_rate", "num_leaves", "max_depth",
                "lambda_l1", "lambda_l2", "min_data_in_leaf",
                "min_sum_hessian_in_leaf", "min_gain_to_split",
                "feature_fraction", "bagging_fraction", "bagging_freq",
                "max_bin", "early_stopping_round", "metric", "seed",
                "checkpoint_interval", "boosting_type", "top_rate",
                "other_rate", "drop_rate", "max_drop", "skip_drop", "top_k",
                "enable_bundle", "max_conflict_rate", "scale_pos_weight",
                "is_unbalance", "extra_trees", "feature_fraction_bynode",
                "path_smooth", "boost_from_average", "cat_smooth",
                "min_data_per_group", "linear_tree", "linear_lambda"]
        p = {k: self.get(k) for k in keys}
        if self.get_or_none("checkpoint_dir"):
            p["checkpoint_dir"] = self.get("checkpoint_dir")
        p["tree_learner"] = self.parallelism
        if self.categorical_feature:
            p["categorical_feature"] = list(self.categorical_feature)
        if self.monotone_constraints:
            p["monotone_constraints"] = list(self.monotone_constraints)
        if self.interaction_constraints:
            p["interaction_constraints"] = [list(g) for g in
                                            self.interaction_constraints]
        p.update(extra)
        return p

    def _split_valid(self, df: DataFrame):
        vcol = self.get_or_none("validation_indicator_col")
        if vcol and vcol in df:
            mask = np.asarray(df[vcol], dtype=bool)
            return df.filter(~mask), df.filter(mask)
        return df, None

    def _reject_unported(self) -> None:
        """The estimator-level option outside the port; :func:`train`
        rejects the rest of them."""
        if self.parallelism != "serial":
            raise _leftover(f"parallelism={self.parallelism!r} (data- and "
                            f"voting-parallel training)", 31)

    def _fit_core(self, df: DataFrame, extra_params: dict,
                  group_col: Optional[str] = None) -> Booster:
        self._reject_unported()
        train_df, valid_df = self._split_valid(df)
        X = assemble_features(train_df, [self.features_col])
        y = np.asarray(train_df[self.label_col], dtype=np.float64)
        w = (np.asarray(train_df[self.weight_col], dtype=np.float64)
             if self.get_or_none("weight_col") and self.weight_col in train_df
             else None)
        valid_sets = None
        valid_weights = None
        if valid_df is not None and len(valid_df):
            valid_sets = [(assemble_features(valid_df, [self.features_col]),
                           np.asarray(valid_df[self.label_col],
                                      dtype=np.float64))]
            if w is not None and self.weight_col in valid_df:
                # LightGBM's Dataset weights apply to its eval metrics:
                # the validation split's weight rows drive early stopping
                valid_weights = [np.asarray(valid_df[self.weight_col],
                                            dtype=np.float64)]
        group = None
        if group_col is not None:
            gcol = np.asarray(train_df[group_col])
            # lambdarank reads contiguous runs; a group id reappearing
            # after another would silently mix queries
            boundaries = np.flatnonzero(gcol[1:] != gcol[:-1]) + 1
            starts = np.concatenate([[0], boundaries, [len(gcol)]])
            run_ids = gcol[starts[:-1]]
            if len(np.unique(run_ids)) != len(run_ids):
                raise ValueError(
                    f"group column {group_col!r} is not contiguous: the same "
                    "group id appears in separate runs; sort the DataFrame by "
                    "group first")
            group = np.diff(starts)
        init_model = None
        ms = self.get_or_none("model_string")
        if ms:
            init_model = Booster.from_string(ms, device=self.device)
        iscol = self.get_or_none("init_score_col")
        init_score = (_margins(train_df, iscol)
                      if iscol and iscol in train_df else None)
        valid_init_scores = None
        if init_score is not None and valid_sets is not None:
            # the validation split carries its own rows of the margin
            valid_init_scores = [_margins(valid_df, iscol)]
        return train(self._train_params(extra_params), X, y, sample_weight=w,
                     group=group, valid_sets=valid_sets,
                     init_model=init_model,
                     init_score=init_score,
                     valid_init_scores=valid_init_scores,
                     valid_weights=valid_weights, device=self.device)

    def _model_kw(self) -> dict:
        return dict(device=self.device, features_col=self.features_col,
                    prediction_col=self.prediction_col,
                    leaf_prediction_col=self.get_or_none(
                        "leaf_prediction_col"),
                    features_shap_col=self.get_or_none("features_shap_col"))


class _LightGBMModelBase(Model, HasFeaturesCol, HasPredictionCol):
    booster_string = ComplexParam(doc="fitted booster payload")
    leaf_prediction_col = Param(str, default=None,
                                doc="emit leaf indices here")
    features_shap_col = Param(str, default=None,
                              doc="emit SHAP contributions here")

    #: where prediction runs; a model loaded as a pipeline's stage (no
    #: keyword) predicts on the card
    device = None

    def __init__(self, booster: Optional[Booster] = None, device=None, **kw):
        super().__init__(**kw)
        self.device = resolve_device(device)
        self._booster = booster
        if booster is not None:
            self.set(booster_string=booster.to_string().encode())

    @classmethod
    def load(cls, path: str, device=None) -> "_LightGBMModelBase":
        """Load a saved model that predicts on ``device`` (``None`` = the
        CUDA card)."""
        stage = super().load(path)
        stage.device = resolve_device(device)
        return stage

    @property
    def booster(self) -> Booster:
        if getattr(self, "_booster", None) is None:
            self._booster = Booster.from_string(
                self.get("booster_string").decode(), device=self.device)
        return self._booster

    def to_onnx(self) -> bytes:
        """The fitted booster as a spec-compliant ONNX TreeEnsemble graph
        (the counterpart of the reference's onnxmltools LightGBM
        conversion), for ``ONNXModel`` or any other ONNX runtime."""
        from .onnx_export import booster_to_onnx
        return booster_to_onnx(self.booster)

    def _load_extra(self, path):
        self._booster = None

    def _features(self, df: DataFrame) -> np.ndarray:
        return assemble_features(df, [self.features_col]).astype(np.float32)

    def _add_aux_cols(self, df: DataFrame, X: np.ndarray) -> DataFrame:
        lcol = self.get_or_none("leaf_prediction_col")
        if lcol:
            df = df.with_column(lcol,
                                _object_rows(self.booster.predict_leaf(X)))
        scol = self.get_or_none("features_shap_col")
        if scol:
            shap = self.booster.shap_values(X)
            if shap.ndim == 3:
                shap = np.concatenate(list(shap), axis=-1)
            vals = np.empty(len(shap), dtype=object)
            for i, row in enumerate(shap):
                vals[i] = row                       # float32, as the reference
            df = df.with_column(scol, vals)
        return df

    def feature_importances(self, importance_type: str = "split"
                            ) -> np.ndarray:
        return self.booster.feature_importance(importance_type)


class LightGBMClassifier(Estimator, _LightGBMParams, HasPredictionCol,
                         HasProbabilityCol):
    objective = Param(str, default="binary", doc="binary or multiclass")
    prediction_col = Param(str, default="prediction", doc="predicted label")
    probability_col = Param(str, default="probability",
                            doc="class probabilities")
    raw_prediction_col = Param(str, default="rawPrediction", doc="raw scores")

    def _fit(self, df: DataFrame) -> "LightGBMClassificationModel":
        y = np.asarray(df[self.label_col])
        classes = np.unique(y[~np.isnan(y.astype(np.float64))])
        n_classes = len(classes)
        objective = self.objective
        if n_classes > 2 and objective == "binary":
            objective = "multiclass"
        extra = {"objective": objective}
        if objective in ("multiclass", "softmax"):
            extra["num_class"] = n_classes
        booster = self._fit_core(df, extra)
        return LightGBMClassificationModel(
            booster, probability_col=self.probability_col,
            raw_prediction_col=self.get("raw_prediction_col"),
            num_classes=n_classes, **self._model_kw())


class LightGBMClassificationModel(_LightGBMModelBase, HasProbabilityCol):
    raw_prediction_col = Param(str, default="rawPrediction", doc="raw scores")
    num_classes = Param(int, default=2, doc="number of classes")

    def _transform(self, df: DataFrame) -> DataFrame:
        X = self._features(df)
        raw = self.booster.predict(X, raw_score=True)
        prob = self.booster.predict(X)
        if prob.ndim == 1:
            prob2 = np.stack([1 - prob, prob], axis=1)
            raw2 = np.stack([-raw, raw], axis=1)
        else:
            prob2, raw2 = prob, raw
        pred = prob2.argmax(axis=1).astype(np.float64)
        out = (df.with_column(self.get("raw_prediction_col"),
                              _object_rows(raw2))
                 .with_column(self.probability_col, _object_rows(prob2))
                 .with_column(self.prediction_col, pred))
        out = set_label_metadata(out, self.prediction_col,
                                 num_classes=self.num_classes)
        return self._add_aux_cols(out, X)


class LightGBMRegressor(Estimator, _LightGBMParams, HasPredictionCol):
    objective = Param(str, default="regression",
                      doc="regression/l1/huber/quantile/poisson/tweedie/gamma")
    alpha = Param(float, default=0.9, doc="huber/quantile parameter")
    tweedie_variance_power = Param(float, default=1.5, doc="tweedie power")

    def _fit(self, df: DataFrame) -> "LightGBMRegressionModel":
        booster = self._fit_core(df, {
            "objective": self.objective, "alpha": self.alpha,
            "tweedie_variance_power": self.tweedie_variance_power})
        return LightGBMRegressionModel(booster, **self._model_kw())


class LightGBMRegressionModel(_LightGBMModelBase):
    def _transform(self, df: DataFrame) -> DataFrame:
        X = self._features(df)
        pred = self.booster.predict(X).astype(np.float64)
        return self._add_aux_cols(df.with_column(self.prediction_col, pred),
                                  X)


class LightGBMRanker(Estimator, _LightGBMParams, HasPredictionCol):
    """Lambdarank over the query runs of ``group_col``."""
    group_col = Param(str, default="group", doc="query-group column")
    evaluate_at = Param((list, int), default=[5], doc="NDCG@k positions")

    def _fit(self, df: DataFrame) -> "LightGBMRankerModel":
        booster = self._fit_core(df, {"objective": "lambdarank"},
                                 group_col=self.group_col)
        return LightGBMRankerModel(booster, **self._model_kw())


class LightGBMRankerModel(_LightGBMModelBase):
    def _transform(self, df: DataFrame) -> DataFrame:
        X = self._features(df)
        pred = self.booster.predict(X, raw_score=True).astype(np.float64)
        return self._add_aux_cols(df.with_column(self.prediction_col, pred),
                                  X)

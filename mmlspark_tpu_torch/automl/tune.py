"""Hyperparameter search and model selection.

Parity surface: ``TuneHyperparameters`` (reference
``core/.../automl/TuneHyperparameters.scala:36-225`` — parallel random/grid
search across executors with train/validation split) and ``FindBestModel``
(``FindBestModel.scala:50`` — evaluate candidate models, keep the best).

The reference parallelizes trials across Spark executors; here trials run as
threads, matching the model/ensemble-parallel row of SURVEY §2.8.

The port's copy of ``mmlspark_tpu/automl/tune.py``. The trials' learners
keep their own devices: on the card, ``parallelism`` threads fit at once
on one device, each launching on its thread's current stream (the
default stream unless the caller set another). No state of the ported
learners is shared across fits but the kernels' launch counters (counted
under a lock) and their first-use builds (built under a lock), so a
trial's result does not depend on ``parallelism`` beyond K6's float32
atomics (the order of a histogram slot's adds varies from run to run on
the card; on the CPU it is fixed).
"""

from __future__ import annotations

import concurrent.futures
from typing import List, Optional, Sequence

import numpy as np

from ..core.dataframe import DataFrame
from ..core.params import ComplexParam, HasLabelCol, Param
from ..core.pipeline import Estimator, Model, Transformer
from ..train.metrics import ComputeModelStatistics

__all__ = ["TuneHyperparameters", "FindBestModel", "FindBestModelResult"]

_MAXIMIZE = {"accuracy", "precision", "recall", "AUC", "R^2"}


def _evaluate(model: Transformer, df: DataFrame, label_col: str,
              metric: str) -> float:
    scored = model.transform(df)
    pred_col = (model.get("prediction_col")
                if model.has_param("prediction_col") else "prediction")
    prob_col = (model.get("probability_col")
                if model.has_param("probability_col") else "probability")
    stats = ComputeModelStatistics(
        label_col=label_col, scores_col=pred_col,
        scored_probabilities_col=prob_col).transform(scored)
    if metric not in stats:
        raise ValueError(f"metric {metric!r} not in {stats.columns}")
    return float(stats[metric][0])


def _apply_params(est: Estimator, pm: dict) -> Estimator:
    """Copy ``est`` with overrides, routing unknown keys to a wrapped inner
    estimator (``model`` param) — so tuning a ``TrainClassifier(model=lr)``
    can target the learner's hyperparameters directly."""
    own = {k: v for k, v in pm.items() if est.has_param(k)}
    inner_overrides = {k: v for k, v in pm.items() if not est.has_param(k)}
    out = est.copy(own)
    if inner_overrides:
        if not est.has_param("model"):
            unknown = sorted(inner_overrides)
            raise KeyError(f"{type(est).__name__} has no params {unknown} "
                           "and no inner 'model' to route them to")
        inner = out.get("model")
        out.set(model=inner.copy(inner_overrides))
    return out


class TuneHyperparameters(Estimator, HasLabelCol):
    """Hyperparameter search over an estimator.

    ``search_strategy='full'`` (default) fits every candidate at full
    budget — the reference's behavior (``TuneHyperparameters.scala:36-225``).
    ``'halving'`` is successive halving (beyond the reference): all
    candidates start at ``min_resource`` of ``resource_param``; each rung
    keeps the top ``1/halving_factor`` and multiplies the resource by
    ``halving_factor`` until ``max_resource`` — total compute grows with
    log(candidates) instead of linearly, which is what makes wide sweeps
    affordable on a single chip.
    """

    model = ComplexParam(default=None, doc="estimator to tune")
    search_space = ComplexParam(default=None,
                                doc="GridSpace or RandomSpace instance")
    number_of_iterations = Param(int, default=10,
                                 doc="trial budget (random and tpe "
                                     "strategies; grids enumerate fully)")
    evaluation_metric = Param(str, default="accuracy", doc="selection metric")
    train_fraction = Param(float, default=0.8, doc="train/validation split")
    parallelism = Param(int, default=4, doc="concurrent trials")
    seed = Param(int, default=0, doc="split seed")
    search_strategy = Param(str, default="full",
                            choices=["full", "halving", "tpe"],
                            doc="full = fit every candidate at full budget; "
                                "halving = successive halving rungs; "
                                "tpe = adaptive Parzen-estimator proposals "
                                "(needs a dict/RandomSpace search space)")
    tpe_startup_trials = Param(int, default=5,
                               doc="tpe: random trials before the model "
                                   "starts proposing")
    tpe_gamma = Param(float, default=0.25,
                      doc="tpe: top fraction of trials modeled as 'good'")
    resource_param = Param(str, default="num_iterations",
                           doc="halving: estimator param that scales cost")
    min_resource = Param(int, default=4, doc="halving: first-rung resource")
    max_resource = Param(int, default=64, doc="halving: final-rung resource")
    halving_factor = Param(int, default=3,
                           doc="halving: keep top 1/factor, grow resource "
                               "by factor, per rung")

    best_metric: Optional[float] = None
    best_params: Optional[dict] = None

    def _fit(self, df: DataFrame) -> Model:
        from .hyperparam import GridSpace, RandomSpace
        space = self.get("search_space")
        if isinstance(space, dict):
            space = RandomSpace(space, seed=self.get("seed"))
        tpe = self.get("search_strategy") == "tpe"
        if tpe:
            # validated BEFORE any candidate materialization: a large grid
            # would enumerate its whole Cartesian product just to be
            # rejected, and a RandomSpace would draw maps tpe never uses
            if isinstance(space, GridSpace):
                raise ValueError("tpe needs a dict/RandomSpace search "
                                 "space (it proposes NEW points; a grid "
                                 "is a fixed candidate list)")
            if int(self.get("number_of_iterations")) < 1:
                raise ValueError("tpe needs number_of_iterations >= 1 "
                                 "(its total trial budget)")
            param_maps = None
        elif isinstance(space, GridSpace):
            param_maps = list(space.param_maps())
        else:
            param_maps = list(space.param_maps(self.get("number_of_iterations")))
        if not tpe and not param_maps:
            raise ValueError("empty search space")

        shuffled = df.shuffle(self.get("seed"))
        n_train = int(round(self.get("train_fraction") * len(df)))
        train = shuffled.take(np.arange(n_train))
        valid = shuffled.take(np.arange(n_train, len(df)))

        est: Estimator = self.get("model")
        metric = self.get("evaluation_metric")
        maximize = metric in _MAXIMIZE

        def run_rung(maps, extra=None):
            def trial(pm: dict):
                eff = {**pm, **(extra or {})}
                model = _apply_params(est, eff).fit(train)
                return (_evaluate(model, valid, self.get("label_col"),
                                  metric), model, pm)
            with concurrent.futures.ThreadPoolExecutor(
                    max_workers=max(1, self.get("parallelism"))) as ex:
                return list(ex.map(trial, maps))

        if tpe:
            from .tpe import TPESampler
            sampler = TPESampler(space.space, seed=self.get("seed"),
                                 gamma=float(self.get("tpe_gamma")),
                                 n_startup=int(self.get(
                                     "tpe_startup_trials")),
                                 maximize=maximize)
            budget = int(self.get("number_of_iterations"))
            batch = max(1, int(self.get("parallelism")))
            results = []
            while len(results) < budget:
                maps = sampler.propose(min(batch, budget - len(results)))
                for score, model, pm in run_rung(maps):
                    sampler.tell(pm, score)
                    results.append((score, model, pm))
        elif self.get("search_strategy") == "halving":
            eta = int(self.get("halving_factor"))
            rp = self.get("resource_param")
            r = int(self.get("min_resource"))
            R = int(self.get("max_resource"))
            if eta < 2:
                raise ValueError(f"halving_factor must be >= 2, got {eta}")
            if not (1 <= r <= R):
                raise ValueError(f"need 1 <= min_resource <= max_resource, "
                                 f"got min_resource={r}, max_resource={R}")
            if any(rp in pm for pm in param_maps):
                # eff = {**pm, rp: r} would silently clobber the sampled
                # value, and best_params would report a config that never ran
                raise ValueError(
                    f"search space samples {rp!r}, which halving controls as "
                    f"the resource; remove it from the space or change "
                    f"resource_param")
            survivors = param_maps
            while r < R and len(survivors) > 1:
                results = run_rung(survivors, {rp: r})
                results.sort(key=lambda t: t[0], reverse=maximize)
                survivors = [pm for _s, _m, pm in
                             results[:max(1, len(survivors) // eta)]]
                r = min(R, r * eta)
            results = run_rung(survivors, {rp: R})
        else:
            results = run_rung(param_maps)

        best = (max if maximize else min)(results, key=lambda t: t[0])
        self.best_metric, best_model, self.best_params = best
        return best_model


class FindBestModelResult(Model):
    best_model = ComplexParam(default=None, doc="winning fitted model")
    all_model_metrics = Param(list, default=[], doc="[(index, metric)] per candidate")

    def _transform(self, df: DataFrame) -> DataFrame:
        return self.get("best_model").transform(df)


class FindBestModel(Estimator, HasLabelCol):
    """Evaluate pre-fitted candidate models on the given frame; keep the best."""

    models = ComplexParam(default=[], doc="candidate fitted models")
    evaluation_metric = Param(str, default="accuracy", doc="selection metric")

    def __init__(self, models: Optional[Sequence[Transformer]] = None, **kw):
        super().__init__(**kw)
        if models is not None:
            self.set(models=list(models))

    def _fit(self, df: DataFrame) -> FindBestModelResult:
        metric = self.get("evaluation_metric")
        maximize = metric in _MAXIMIZE
        scores: List[float] = []
        for m in self.get("models"):
            scores.append(_evaluate(m, df, self.get("label_col"), metric))
        best_i = int(np.argmax(scores) if maximize else np.argmin(scores))
        res = FindBestModelResult()
        res.set(best_model=self.get("models")[best_i],
                all_model_metrics=[[i, s] for i, s in enumerate(scores)])
        return res

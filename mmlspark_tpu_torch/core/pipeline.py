"""Transformer / Estimator / Pipeline — the stage algebra (the port's copy
of ``mmlspark_tpu/core/pipeline.py``, without the JAX package's profiling
spans).

Parity surface: Spark ML's ``Transformer``/``Estimator``/``Pipeline`` as used
throughout the reference (every feature ships as one of these; see
``SURVEY.md`` §1 L3/L4). Stages here are eager (DataFrames are materialized
columns), configured via the Param system, and serializable via
``mmlspark_tpu_torch.core.serialize``.

Telemetry parity: ``BasicLogging`` (reference
``core/.../logging/BasicLogging.scala:26-71``) logs a JSON envelope per
fit/transform — here a stdlib logger emits the same shape.
"""

from __future__ import annotations

import json
import logging
import time
from typing import List, Optional, Sequence

from .dataframe import DataFrame
from .params import ComplexParam, Params

__all__ = ["PipelineStage", "Transformer", "DeviceTransformer", "Estimator",
           "Model", "Pipeline", "PipelineModel"]

_telemetry = logging.getLogger("mmlspark_tpu_torch.telemetry")


def _log_event(stage: "PipelineStage", method: str, **extra):
    payload = {"uid": stage.uid, "className": type(stage).__qualname__,
               "method": method, **extra}
    _telemetry.debug(json.dumps(payload))


class PipelineStage(Params):
    """Common base: params + save/load + telemetry."""

    def save(self, path: str, overwrite: bool = True) -> None:
        from . import serialize
        serialize.save_stage(self, path, overwrite=overwrite)

    @classmethod
    def load(cls, path: str) -> "PipelineStage":
        from . import serialize
        stage = serialize.load_stage(path)
        if cls is not PipelineStage and not isinstance(stage, cls):
            raise TypeError(f"loaded {type(stage).__name__}, expected {cls.__name__}")
        return stage

    # Hooks for stages carrying non-param state (e.g. fitted arrays).
    def _save_extra(self, path: str) -> None:
        pass

    def _load_extra(self, path: str) -> None:
        pass


class Transformer(PipelineStage):
    """A stage mapping DataFrame → DataFrame."""

    def transform(self, df: DataFrame, params: Optional[dict] = None) -> DataFrame:
        stage = self.copy(params) if params else self
        t0 = time.perf_counter()
        out = stage._transform(df)
        _log_event(stage, "transform", rows=len(df),
                   millis=round(1e3 * (time.perf_counter() - t0), 3))
        return out

    def _transform(self, df: DataFrame) -> DataFrame:
        raise NotImplementedError

    def __call__(self, df: DataFrame) -> DataFrame:
        return self.transform(df)


class DeviceTransformer(Transformer):
    """A Transformer whose compute runs on **device-resident** columns.

    Subclasses implement :meth:`_transform_device` over a dict of
    ``torch.Tensor`` inputs and return device tensors; the base class stages
    inputs at most once (``DataFrame.device_put`` is idempotent — the first
    stage of a chain pays the single ingest h2d, later stages count
    residency hits and move nothing) and attaches outputs as device-born
    resident columns. A chain of these therefore costs one h2d at ingest
    and one d2h when the caller finally exits via ``DataFrame.to_host`` —
    the residency contract the bench's device-resident leg measures.

    ``device`` (a keyword, not a persisted param) is where inputs are
    staged: ``None`` means the CUDA card; tests pass ``"cpu"``.
    """

    input_cols = ComplexParam(default=[],
                              doc="columns staged and passed to "
                                  "_transform_device; [] = every dense "
                                  "numeric column")

    def __init__(self, input_cols: Optional[Sequence[str]] = None,
                 device=None, **kw):
        super().__init__(**kw)
        if input_cols is not None:
            self.set(input_cols=list(input_cols))
        self.device = device

    def _transform_device(self, arrays: dict) -> dict:
        """``{col: torch.Tensor} -> {col: torch.Tensor}`` — stays on
        device."""
        raise NotImplementedError

    def _transform(self, df: DataFrame) -> DataFrame:
        names = list(self.get("input_cols") or [])
        from .residency import make_put
        staged = df.device_put(names or None,
                               put=make_put(getattr(self, "device", None)))
        arrays = {n: staged.device_column(n).device_array()
                  for n in (names or staged.resident_columns)}
        out = staged
        for name, arr in (self._transform_device(arrays) or {}).items():
            out = out.with_device_column(name, arr)
        return out


class Estimator(PipelineStage):
    """A stage whose ``fit`` produces a :class:`Model` (a Transformer)."""

    def fit(self, df: DataFrame, params: Optional[dict] = None) -> "Model":
        est = self.copy(params) if params else self
        t0 = time.perf_counter()
        model = est._fit(df)
        _log_event(est, "fit", rows=len(df),
                   millis=round(1e3 * (time.perf_counter() - t0), 3))
        return model

    def _fit(self, df: DataFrame) -> "Model":
        raise NotImplementedError

    def fit_multiple(self, df: DataFrame, param_maps: Sequence[dict]) -> List["Model"]:
        """Fit one model per param override; AutoML entry point (reference
        ``VowpalWabbitContextualBandit.fitMultiple`` / ``TuneHyperparameters``)."""
        return [self.fit(df, dict(m)) for m in param_maps]


class Model(Transformer):
    """A fitted Transformer, optionally keeping a pointer to its parent."""

    parent: Optional[Estimator] = None


class Pipeline(Estimator):
    """Sequential composition of stages (reference: Spark ML Pipeline)."""

    stages = ComplexParam(default=[], doc="ordered list of pipeline stages")

    def __init__(self, stages: Optional[Sequence[PipelineStage]] = None, **kw):
        super().__init__(**kw)
        if stages is not None:
            self.set(stages=list(stages))

    def _fit(self, df: DataFrame) -> "PipelineModel":
        fitted: List[Transformer] = []
        cur = df
        stages = self.get("stages")
        for i, stage in enumerate(stages):
            if isinstance(stage, Estimator):
                model = stage.fit(cur)
                fitted.append(model)
                if i < len(stages) - 1:
                    cur = model.transform(cur)
            elif isinstance(stage, Transformer):
                fitted.append(stage)
                if i < len(stages) - 1:
                    cur = stage.transform(cur)
            else:
                raise TypeError(f"pipeline stage {stage!r} is neither "
                                "Estimator nor Transformer")
        return PipelineModel(fitted)


class PipelineModel(Model):
    stages = ComplexParam(default=[], doc="ordered list of fitted transformers")

    def __init__(self, stages: Optional[Sequence[Transformer]] = None, **kw):
        super().__init__(**kw)
        if stages is not None:
            self.set(stages=list(stages))

    def _transform(self, df: DataFrame) -> DataFrame:
        cur = df
        for stage in self.get("stages"):
            cur = stage.transform(cur)
        return cur

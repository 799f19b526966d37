"""Parameter system for pipeline stages (the port's copy of
``mmlspark_tpu/core/params.py``).

Plays the role of Spark ML's ``Param``/``Params`` machinery in the reference
(``core/src/main/scala/com/microsoft/azure/synapse/ml/core/contracts/Params.scala:1-207``
and the 21 custom param types under ``org/apache/spark/ml/param/``), redesigned
for a Python-first framework:

* Params are declared as class attributes (descriptors), so every stage gets
  typed, documented, introspectable configuration for free.
* ``ComplexParam`` covers non-JSON values (ndarrays, nested stages, callables,
  model bytes) with pluggable save/load — the equivalent of the reference's
  ``ComplexParamsSerializer`` (``org/apache/spark/ml/ComplexParamsSerializer.scala``).
* Shared mixin traits (``HasInputCol`` etc.) mirror the reference's contracts.
"""

from __future__ import annotations

import copy as _copy
from typing import Any, Callable, Dict, Optional

import numpy as np

__all__ = [
    "Param",
    "ComplexParam",
    "Params",
    "ParamMap",
    "identity",
    "HasInputCol",
    "HasOutputCol",
    "HasInputCols",
    "HasOutputCols",
    "HasLabelCol",
    "HasFeaturesCol",
    "HasWeightCol",
    "HasPredictionCol",
    "HasProbabilityCol",
    "HasBatchSize",
    "HasErrorCol",
    "HasSeed",
]


def identity(x):
    return x


# ---------------------------------------------------------------------------
# Type converters
# ---------------------------------------------------------------------------

def _to_int(v):
    import numbers
    if isinstance(v, np.generic):
        v = v.item()
    if isinstance(v, bool):
        raise TypeError(f"expected int, got bool {v!r}")
    if isinstance(v, numbers.Integral):
        return int(v)
    if isinstance(v, float) and v.is_integer():
        return int(v)
    raise TypeError(f"expected int, got {type(v).__name__}: {v!r}")


def _to_float(v):
    import numbers
    if isinstance(v, np.generic):
        v = v.item()
    if isinstance(v, bool):
        raise TypeError(f"expected float, got bool {v!r}")
    if isinstance(v, numbers.Real):
        return float(v)
    raise TypeError(f"expected float, got {type(v).__name__}: {v!r}")


def _to_bool(v):
    if isinstance(v, np.bool_):
        v = bool(v)
    if isinstance(v, bool):
        return v
    raise TypeError(f"expected bool, got {type(v).__name__}: {v!r}")


def _to_str(v):
    if isinstance(v, str):
        return v
    raise TypeError(f"expected str, got {type(v).__name__}: {v!r}")


def _to_list_of(conv):
    def convert(v):
        if isinstance(v, (list, tuple)):
            return [conv(x) for x in v]
        raise TypeError(f"expected list, got {type(v).__name__}: {v!r}")

    return convert


def _to_dict(v):
    if isinstance(v, dict):
        return dict(v)
    raise TypeError(f"expected dict, got {type(v).__name__}: {v!r}")


_CONVERTERS: Dict[Any, Callable[[Any], Any]] = {
    int: _to_int,
    float: _to_float,
    bool: _to_bool,
    str: _to_str,
    dict: _to_dict,
    list: lambda v: list(v) if isinstance(v, (list, tuple)) else (_ for _ in ()).throw(
        TypeError(f"expected list, got {type(v).__name__}")),
    None: identity,
}


class Param:
    """A declared, typed, documented parameter of a pipeline stage.

    Declared as a class attribute::

        class MyStage(Transformer):
            batch_size = Param(int, default=10, doc="rows per minibatch")

    Reads go through the descriptor protocol (``stage.batch_size``); writes via
    ``stage.set(batch_size=...)`` or the constructor.
    """

    #: marker for "no default"
    _NO_DEFAULT = object()

    def __init__(self, dtype=None, default: Any = _NO_DEFAULT, doc: str = "",
                 converter: Optional[Callable[[Any], Any]] = None,
                 choices: Optional[list] = None):
        self.dtype = dtype
        self.doc = doc
        self.choices = choices
        if converter is not None:
            self._convert = converter
        elif dtype in _CONVERTERS:
            self._convert = _CONVERTERS[dtype]
        elif isinstance(dtype, tuple) and len(dtype) == 2 and dtype[0] is list:
            self._convert = _to_list_of(_CONVERTERS.get(dtype[1], identity))
        else:
            self._convert = identity
        self.default = default if (default is Param._NO_DEFAULT
                                   or default is None) \
            else self._convert(default)
        self.name: str = "<unbound>"
        self.owner: Optional[type] = None

    def __set_name__(self, owner, name):
        self.name = name
        self.owner = owner

    @property
    def has_default(self) -> bool:
        return self.default is not Param._NO_DEFAULT

    def convert(self, value):
        if value is None:
            # None is only a legal value for optional params (default None);
            # for typed params with a real default it would bypass validation
            if self.default is None:
                return None
            raise TypeError(f"param {self.name} does not accept None")
        v = self._convert(value)
        if self.choices is not None and v not in self.choices:
            raise ValueError(f"param {self.name}: {v!r} not in {self.choices}")
        return v

    # -- descriptor protocol ------------------------------------------------
    def __get__(self, obj, objtype=None):
        if obj is None:
            return self
        return obj.get(self.name)

    def __set__(self, obj, value):
        obj.set(**{self.name: value})

    # -- (de)serialization of values ---------------------------------------
    def json_value(self, value):
        """Value → JSON-compatible object. ComplexParam overrides."""
        return value

    def from_json_value(self, value, load_dir=None):
        return self.convert(value)

    def __repr__(self):
        return f"Param({self.name!r}, dtype={self.dtype}, default={self.default!r})"


class ComplexParam(Param):
    """A param whose value is not JSON-serializable (ndarray, stage, fn, bytes).

    ``saver(value, path)`` / ``loader(path)`` hooks persist the value into the
    stage's save directory. Stages with callables that cannot be persisted can
    pass ``saver=None`` to mark the param transient (skipped on save; must be
    re-set after load).
    """

    def __init__(self, default: Any = Param._NO_DEFAULT, doc: str = "",
                 saver="default", loader="default"):
        super().__init__(None, default, doc, converter=identity)
        self.saver = saver
        self.loader = loader

    def json_value(self, value):  # handled out-of-band by the serializer
        raise TypeError(f"ComplexParam {self.name} has no JSON form")


class ParamMap(dict):
    """A {param_name: value} override map, used by fit/transform and AutoML."""


class _ParamsMeta(type):
    def __new__(mcls, name, bases, ns):
        cls = super().__new__(mcls, name, bases, ns)
        declared: Dict[str, Param] = {}
        for base in reversed(cls.__mro__):
            for k, v in vars(base).items():
                if isinstance(v, Param):
                    declared[k] = v
        cls._declared_params = declared
        return cls


class Params(metaclass=_ParamsMeta):
    """Base for everything configurable. Holds explicit values + defaults."""

    _declared_params: Dict[str, Param] = {}
    _uid_counter = [0]

    def __init__(self, **kwargs):
        Params._uid_counter[0] += 1
        self.uid = f"{type(self).__name__}_{Params._uid_counter[0]:08x}"
        self._param_values: Dict[str, Any] = {}
        self.set(**kwargs)

    # -- core accessors -----------------------------------------------------
    @classmethod
    def params(cls) -> Dict[str, Param]:
        return dict(cls._declared_params)

    def param(self, name: str) -> Param:
        try:
            return self._declared_params[name]
        except KeyError:
            raise KeyError(
                f"{type(self).__name__} has no param {name!r}; "
                f"known: {sorted(self._declared_params)}") from None

    def has_param(self, name: str) -> bool:
        return name in self._declared_params

    def is_set(self, name: str) -> bool:
        return name in self._param_values

    def is_defined(self, name: str) -> bool:
        return self.is_set(name) or self.param(name).has_default

    def get(self, name: str, default=Param._NO_DEFAULT):
        if name in self._param_values:
            return self._param_values[name]
        p = self.param(name)
        if p.has_default:
            # mutable defaults are class-shared; hand out copies
            if isinstance(p.default, (list, dict)):
                return _copy.copy(p.default)
            return p.default
        if default is not Param._NO_DEFAULT:
            return default
        raise ValueError(f"param {name!r} of {self.uid} is not set and has no default")

    def get_or_none(self, name: str):
        return self.get(name, default=None)

    def set(self, **kwargs) -> "Params":
        for k, v in kwargs.items():
            p = self.param(k)
            if v is None and not p.has_default:
                # allow explicit clearing of optional params
                self._param_values.pop(k, None)
                continue
            self._param_values[k] = p.convert(v) if not isinstance(p, ComplexParam) else v
        return self

    def clear(self, name: str) -> "Params":
        self._param_values.pop(name, None)
        return self

    def explain_params(self) -> str:
        lines = []
        for name, p in sorted(self._declared_params.items()):
            cur = self._param_values.get(name, p.default if p.has_default else "<unset>")
            lines.append(f"{name}: {p.doc} (current: {cur!r})")
        return "\n".join(lines)

    def extract_param_map(self) -> ParamMap:
        m = ParamMap()
        for name, p in self._declared_params.items():
            if self.is_defined(name):
                m[name] = self.get(name)
        return m

    def copy(self, extra: Optional[dict] = None) -> "Params":
        other = _copy.copy(self)
        other._param_values = dict(self._param_values)
        if extra:
            other.set(**extra)
        return other

    def _set_default(self, **kwargs):
        """Adjust per-instance defaults (e.g. subclasses tightening a default)."""
        for k, v in kwargs.items():
            p = self.param(k)
            if k not in self._param_values:
                self._param_values[k] = p.convert(v) if not isinstance(p, ComplexParam) else v

    def __repr__(self):
        set_vals = {k: v for k, v in self._param_values.items()
                    if not isinstance(self.param(k), ComplexParam)}
        return f"{type(self).__name__}(uid={self.uid}, {set_vals})"


# ---------------------------------------------------------------------------
# Shared contracts (reference: core/contracts/Params.scala:1-207)
# ---------------------------------------------------------------------------

class HasInputCol(Params):
    input_col = Param(str, default="input", doc="name of the input column")


class HasOutputCol(Params):
    output_col = Param(str, default="output", doc="name of the output column")


class HasInputCols(Params):
    input_cols = Param((list, str), default=[], doc="names of the input columns")


class HasOutputCols(Params):
    output_cols = Param((list, str), default=[], doc="names of the output columns")


class HasLabelCol(Params):
    label_col = Param(str, default="label", doc="name of the label column")


class HasFeaturesCol(Params):
    features_col = Param(str, default="features", doc="name of the features column")


class HasWeightCol(Params):
    weight_col = Param(str, default=None, converter=identity,
                       doc="name of the sample-weight column (optional)")


class HasPredictionCol(Params):
    prediction_col = Param(str, default="prediction", doc="name of the prediction column")


class HasProbabilityCol(Params):
    probability_col = Param(str, default="probability", doc="name of the probability column")


class HasBatchSize(Params):
    batch_size = Param(int, default=10, doc="rows per minibatch fed to the device")


class HasErrorCol(Params):
    error_col = Param(str, default="error", doc="column to receive per-row errors")


class HasSeed(Params):
    seed = Param(int, default=0, doc="PRNG seed")

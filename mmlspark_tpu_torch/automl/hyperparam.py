"""Hyperparameter spaces.

Parity surface: ``HyperparamBuilder``, ``RandomSpace``/``GridSpace``
(reference ``core/.../automl/ParamSpace.scala:25,34``, ``HyperparamBuilder``),
``DiscreteHyperParam``/``RangeHyperParam``.

The port's copy of ``mmlspark_tpu/automl/hyperparam.py`` (numpy streams
only; the same seed draws the same maps).
"""

from __future__ import annotations

import itertools
from typing import Dict, Iterator, List, Sequence

import numpy as np

__all__ = ["DiscreteHyperParam", "RangeHyperParam", "HyperparamBuilder",
           "GridSpace", "RandomSpace"]


class DiscreteHyperParam:
    def __init__(self, values: Sequence):
        self.values = list(values)

    def sample(self, rng: np.random.Generator):
        return self.values[int(rng.integers(len(self.values)))]

    def grid(self) -> List:
        return list(self.values)


class RangeHyperParam:
    def __init__(self, low, high, is_log: bool = False, is_int: bool = False):
        self.low, self.high = low, high
        self.is_log, self.is_int = is_log, is_int

    def sample(self, rng: np.random.Generator):
        if self.is_log:
            v = float(np.exp(rng.uniform(np.log(self.low), np.log(self.high))))
        else:
            v = float(rng.uniform(self.low, self.high))
        return int(round(v)) if self.is_int else v

    def grid(self, n: int = 5) -> List:
        if self.is_log:
            vals = np.exp(np.linspace(np.log(self.low), np.log(self.high), n))
        else:
            vals = np.linspace(self.low, self.high, n)
        return [int(round(v)) if self.is_int else float(v) for v in vals]


class HyperparamBuilder:
    def __init__(self):
        self._space: Dict[str, object] = {}

    def add_hyperparam(self, name: str, param) -> "HyperparamBuilder":
        self._space[name] = param
        return self

    def build(self) -> Dict[str, object]:
        return dict(self._space)


class GridSpace:
    """Cartesian product of every hyperparam's grid."""

    def __init__(self, space: Dict[str, object]):
        self.space = space

    def param_maps(self) -> Iterator[dict]:
        names = list(self.space)
        grids = [p.grid() if isinstance(p, DiscreteHyperParam) else p.grid()
                 for p in self.space.values()]
        for combo in itertools.product(*grids):
            yield dict(zip(names, combo))


class RandomSpace:
    """Independent random draws from every hyperparam."""

    def __init__(self, space: Dict[str, object], seed: int = 0):
        self.space = space
        self.seed = seed

    def param_maps(self, n: int) -> Iterator[dict]:
        rng = np.random.default_rng(self.seed)
        for _ in range(n):
            yield {k: p.sample(rng) for k, p in self.space.items()}

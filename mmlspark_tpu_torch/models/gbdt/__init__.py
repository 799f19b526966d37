"""Histogram GBDT (counterpart of ``models/gbdt/``): ``train`` fits a
:class:`Booster` on the card, its per-level histograms built by the
hand-written kernel K6 (``ops/histogram.py``). The DataFrame estimators
are not ported yet (ROADMAP.md, slice-3 leftovers)."""

from .binning import BinMapper
from .booster import Booster
from .train import train

__all__ = ["BinMapper", "Booster", "train"]

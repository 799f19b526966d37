"""TorchModel — run any PyTorch callable as a pipeline stage (counterpart of
``mmlspark_tpu/models/jax_model.py``'s ``JaxModel``).

The reference ships two graph runners with one shape, ``ONNXModel`` and
``CNTKModel`` (``deep-learning/.../cntk/CNTKModel.scala:250-330``: the
feed/fetch dict API, input coercion ``:387-434``, broadcast +
``mapPartitions`` evaluate). The JAX package's ``JaxModel`` is the
non-ONNX runner for native JAX functions; this is its PyTorch twin, over
the same :class:`~.runner.BatchRunner` as :class:`~.onnx_model.ONNXModel`:
minibatches padded to buckets, prefetch on a worker, async h2d, one drain,
per-partition device pinning, resident columns fed without a transfer.

A model is either

* a callable ``apply_fn(params, {feed: tensor}) -> {name: tensor} |
  tensor`` with ``model_params`` a pytree (dicts/lists) of arrays, moved
  to the device once and cached there; or
* an ``nn.Module`` as ``apply_fn`` (``model_params`` unused): a copy is
  moved to each device it runs on, in ``compute_dtype``, and called as
  ``module(*feeds)`` in ``feed_dict`` order.

Float feeds and params are cast to ``compute_dtype`` on the device. Save
and load keep the params (an npz pytree) and a module-level function of
this package by import path; other callables are transient (re-set
``apply_fn`` after loading). ``device`` is a constructor (and ``load``)
keyword, not a param: ``None`` is the CUDA card and raises without one.
``tuning="auto"`` consults the observation store as ``ONNXModel`` does,
under the signature ``torch:<apply_fn path>:<compute_dtype>``;
``mesh_sharded`` raises ``NotImplementedError``; as the port's
``ONNXModel``, partitions go round-robin over the local
cards when the device names no index (the JAX package's ``pin_devices``
is not a param here).
"""

from __future__ import annotations

import copy
import threading
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from ..core.dataframe import DataFrame
from ..core.params import ComplexParam, Param
from ..core.pipeline import Model
from ..ops.compile_cache import StageCounters, warm_up_model
from ..parallel.mesh import feed_placement, local_devices
from ..utils.device import resolve_device
from .runner import BatchRunner, StagingSlabPool

__all__ = ["TorchModel"]

_TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
                 "float16": torch.float16}


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


class TorchModel(Model):
    """Run ``apply_fn(params, {feed: tensor}) -> {name: tensor} | tensor``
    (or an ``nn.Module``) over DataFrame columns in device minibatches."""

    apply_fn = ComplexParam(default=None,
                            doc="callable (params, feeds) -> outputs, or an "
                                "nn.Module called as module(*feeds); "
                                "module-level functions of this package "
                                "survive save/load by import path, other "
                                "callables are transient")
    model_params = ComplexParam(default=None,
                                doc="pytree of arrays passed as first arg")
    feed_dict = Param(dict, default={}, doc="{feed name: dataframe column}; "
                                            "empty = first column as 'input'")
    fetch_dict = Param(dict, default={}, doc="{output column: output name}; "
                                             "empty = every output under its "
                                             "own name")
    mini_batch_size = Param(int, default=64, doc="rows per device batch")
    compute_dtype = Param(str, default="float32",
                          choices=sorted(_TORCH_DTYPES),
                          doc="float feeds/params cast to this on device "
                              "(bfloat16 recommended on the card)")
    mesh_sharded = Param(bool, default=False,
                         doc="not ported: SPMD inference over a device mesh")
    prefetch_depth = Param(int, default=2,
                           doc="prepared batches coerced/padded ahead on a "
                               "background worker while the current batch "
                               "dispatches; 0 = prepare inline")
    buckets = Param((list, int), default=[],
                    doc="custom padding-bucket ladder (sorted batch sizes); "
                        "empty = next-power-of-two")
    tuning = Param(str, default="", choices=["", "auto"],
                   doc="'auto' consults the measurement-driven tuning store "
                       "(MMLSPARK_TPU_TUNING_DIR): the fitted cost model "
                       "picks mini_batch_size, prefetch_depth and the "
                       "bucket ladder; a cold store keeps the defaults")

    def __init__(self, apply_fn: Optional[Callable] = None,
                 model_params=None, device=None, **kw):
        self._init_state(resolve_device(device))
        super().__init__(**kw)
        if apply_fn is not None:
            self.set(apply_fn=apply_fn)
        if model_params is not None:
            self.set(model_params=model_params)

    def _init_state(self, device: Optional[torch.device]) -> None:
        self._device = device
        self._fn = None
        self._device_params: Dict[tuple, object] = {}
        self._params_lock = threading.Lock()
        self._counters = StageCounters()
        self._staging: Dict[str, StagingSlabPool] = {}
        self._tuning_decisions: Dict[tuple, object] = {}

    @classmethod
    def load(cls, path: str, device=None) -> "TorchModel":
        """Load a saved model onto ``device`` (``None`` = the CUDA card)."""
        stage = super().load(path)
        stage._device = resolve_device(device)
        return stage

    def _load_extra(self, path: str) -> None:
        self._init_state(None)

    @property
    def device(self) -> torch.device:
        if self._device is None:
            self._device = resolve_device(None)
        return self._device

    @property
    def stage_counters(self) -> StageCounters:
        """coerce/pad/h2d/dispatch/d2h instrumentation, cumulative over
        every transform/warm_up on this instance."""
        return self._counters

    def set(self, **kwargs):
        out = super().set(**kwargs)
        # any reconfiguration drops the batch function, the cached device
        # params (under the lock, as ONNXModel) and the tuning decisions
        if kwargs and hasattr(self, "_params_lock"):
            self._fn = None
            with self._params_lock:
                self._device_params = {}
        if kwargs and getattr(self, "_tuning_decisions", None) is not None:
            self._tuning_decisions.clear()
        return out

    # -- tuning --------------------------------------------------------------
    def tuning_signature(self) -> str:
        """Stable identity for the observation store: the apply_fn's
        import path (a module's class path) plus the compute dtype."""
        fn = self.get_or_none("apply_fn")
        if isinstance(fn, torch.nn.Module):
            fn = type(fn)
        name = (f"{getattr(fn, '__module__', '?')}."
                f"{getattr(fn, '__qualname__', repr(fn))}" if fn is not None
                else "unset")
        return f"torch:{name}:{self.compute_dtype}"

    def _resolve_tuning(self, histogram: Dict[int, int]):
        """The store's pick for this histogram (None = off or cold store);
        resolved sig-wide so warm-up and every partition share one ladder,
        from rows of the single-device layout (``mesh_sharded`` is not
        ported)."""
        if self.get_or_none("tuning") != "auto":
            return None
        key = (tuple(sorted(histogram.items())), "single")
        if key not in self._tuning_decisions:
            from ..tuning.cost_model import resolve_tuning
            self._tuning_decisions[key] = resolve_tuning(
                self.tuning_signature(), "default", histogram,
                defaults=(self.mini_batch_size, self.prefetch_depth),
                mesh_shape="single")
        return self._tuning_decisions[key]

    def _runner_config(self, n_rows: int):
        ladder = tuple(self.buckets) if self.get_or_none("buckets") else None
        decision = self._resolve_tuning({int(n_rows): 1})
        if decision is None:
            return self.mini_batch_size, self.prefetch_depth, ladder
        return (decision.mini_batch_size, decision.prefetch_depth,
                decision.buckets)

    # -- the batch function ----------------------------------------------
    def _ensure_fn(self):
        if self._fn is None:
            fn = self.get_or_none("apply_fn")
            if fn is None:
                raise ValueError(
                    f"{self.uid}: apply_fn is unset (a closure param does "
                    f"not survive save/load; re-set it after loading)")
            compute_dt = _TORCH_DTYPES[self.compute_dtype]
            fetch = dict(self.fetch_dict)
            module = isinstance(fn, torch.nn.Module)
            order = list(self.feed_dict) or ["input"]

            def run(params, feeds):
                feeds = {k: (v.to(compute_dt) if v.is_floating_point()
                             and v.dtype != compute_dt else v)
                         for k, v in feeds.items()}
                out = (params(*[feeds[k] for k in order]) if module
                       else fn(params, feeds))
                if not isinstance(out, dict):
                    out = {"output": out}
                if fetch:
                    return {col: out[name] for col, name in fetch.items()}
                return out

            self._fn = run
        return self._fn

    def _params_for_device(self, device: torch.device):
        """The params (or the module's copy) on ``device`` in
        ``compute_dtype``, staged once per device under the lock."""
        key = (str(device), self.compute_dtype)
        with self._params_lock:
            if key not in self._device_params:
                dt = _TORCH_DTYPES[self.compute_dtype]
                fn = self.get_or_none("apply_fn")
                if isinstance(fn, torch.nn.Module):
                    m = copy.deepcopy(fn).to(device).eval()
                    staged = m.to(dt) if dt != torch.float32 else m
                else:
                    def put(v):
                        t = (v if isinstance(v, torch.Tensor) else
                             torch.from_numpy(np.ascontiguousarray(v)))
                        t = t.to(device)
                        return t.to(dt) if t.is_floating_point() else t
                    params = self.get_or_none("model_params")
                    staged = None if params is None else _tree_map(put, params)
                self._device_params[key] = staged
            return self._device_params[key]

    # -- execution ----------------------------------------------------------
    @staticmethod
    def _coerce_col(col):
        if isinstance(col, torch.Tensor):
            return col.float() if col.dtype == torch.float64 else col
        if col.dtype == object:
            col = np.stack([np.asarray(v) for v in col])
        arr = np.asarray(col)
        if arr.dtype == np.float64:
            arr = arr.astype(np.float32)
        return arr

    def _n_placements(self) -> int:
        """Placements real traffic can hit: every local card when the
        device names no index (partitions round-robin), else one."""
        dev = self.device
        if dev.type == "cuda" and dev.index is None:
            return max(1, len(local_devices()))
        return 1

    def _placement_params(self, pidx: int):
        placement = feed_placement(self.mesh_sharded, pidx, self.device)
        return placement, self._params_for_device(placement.device)

    def _staging_for(self, device: torch.device) -> StagingSlabPool:
        with self._params_lock:
            pool = self._staging.get(str(device))
            if pool is None:
                pool = self._staging[str(device)] = StagingSlabPool(
                    pin=device.type == "cuda")
            return pool

    def _run_batches(self, part: DataFrame, pidx: int) -> DataFrame:
        with torch.inference_mode():
            return self._run_partition(part, pidx)

    def _run_partition(self, part: DataFrame, pidx: int) -> DataFrame:
        fn = self._ensure_fn()
        feed = dict(self.feed_dict) or {"input": part.columns[0]}
        placement, params = self._placement_params(pidx)
        resident = {col_name: part.device_column(col_name).device_array()
                    for col_name in feed.values()
                    if part.is_resident(col_name)}

        def coerce(sl: slice) -> Dict[str, object]:
            out = {}
            for feed_name, col_name in feed.items():
                dev = resident.get(col_name)
                out[feed_name] = self._coerce_col(
                    dev[sl] if dev is not None else part[col_name][sl])
            return out

        mbs, depth, ladder = self._runner_config(len(part))
        runner = BatchRunner(fn, params, coerce, placement.device,
                             shards=placement.shards,
                             mini_batch_size=mbs,
                             prefetch_depth=depth,
                             counters=self._counters,
                             staging=self._staging_for(placement.device),
                             buckets=ladder,
                             model_sig=self.tuning_signature(),
                             placement_key=str(placement.key))
        pending = runner.run_and_drain(len(part))
        if not pending:
            return part
        out = part
        for col_name in pending[0][0]:
            out = out.with_column(col_name, np.concatenate(
                [outs[col_name][:b] for outs, b in pending]))
        return out

    # -- warm-up -------------------------------------------------------------
    def warm_up(self, input_specs: Dict[str, tuple],
                batch_sizes: Optional[List[int]] = None,
                background: bool = False):
        """Run one zero batch of every padding-bucket shape on every
        placement before first traffic. ``input_specs`` is required (the
        callable has no graph metadata): {feed name: (dtype, per-row
        shape)}. Returns as :meth:`ONNXModel.warm_up`."""
        fn = self._ensure_fn()
        specs = {name: (np.dtype(dt), tuple(shape))
                 for name, (dt, shape) in input_specs.items()}
        sizes = [int(b) for b in (batch_sizes or [self.mini_batch_size])]
        ladder = tuple(self.buckets) if self.get_or_none("buckets") else None
        decision = self._resolve_tuning({s: 1 for s in sizes})
        if decision is not None:
            sizes = list(decision.warm_up_sizes) or sizes
            ladder = decision.buckets
        return warm_up_model(self, fn, specs, sizes, background=background,
                             buckets=ladder)

    def _transform(self, df: DataFrame) -> DataFrame:
        self._ensure_fn()
        return df.map_partitions(self._run_batches)

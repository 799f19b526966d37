"""ONNXModel — batched ONNX inference through the DataFrame API (counterpart
of ``mmlspark_tpu/models/onnx_model.py``).

Parity surface, as in the JAX package: ``feed_dict`` {model input →
column} / ``fetch_dict`` {column → model output}, ``softmax_dict`` /
``argmax_dict`` post-ops, minibatch → coerce → run per partition →
flatten, and device selection per partition (round-robin over the local
cards). The graph runs as PyTorch ops (:mod:`..onnx.convert`); batches are
padded to power-of-two buckets (``ops/padding.py``), so the set of shapes
cuDNN chooses algorithms for stays small.

Input prep runs on the device after the transfer, in the reference's
order: ``transpose_dict`` permutes (a uint8 NHWC batch permuted by
[0, 3, 1, 2] is an NCHW view whose memory is already channels-last, so no
copy is made), then a cast to ``compute_dtype``, then ``* scale``,
``- mean`` and ``/ std``, each in that dtype. On the card, 4-D float
params are held ``channels_last`` too, so convolutions run in cuDNN's
NHWC layout end to end.

The device is a constructor (and :meth:`ONNXModel.load`) keyword, not a
persisted param: ``None`` means the CUDA card(s), and raises without one.
``quantize="int8"`` holds every 2-D float weight on the card as int8
codes with a per-column scale, computed from the ``compute_dtype`` values,
and dequantizes them on the card each batch before the graph runs
(weight-only: activations and sums stay in ``compute_dtype``). The 8-bit
weights of a quantized graph (QLinear* ops) are placed on the card once
with the float params. ``external_data_dir`` names the directory of the
sidecar files of a model saved with external data (its initializers are
read from there, paths resolved under it). ``weights_override`` (an npz
of fine-tuned params, as ``ONNXEstimator.fit`` writes it) is layered
over the graph's initializers before they are placed; a name the graph
does not have raises ValueError. ``tuning="auto"`` consults the
observation store (:mod:`..tuning.cost_model`) at transform and warm-up
for ``(mini_batch_size, prefetch_depth, ladder)``; ``mesh_sharded``
raises when a batch is placed.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional

import numpy as np
import torch

from ..core.dataframe import DataFrame
from ..core.params import ComplexParam, Param
from ..core.pipeline import Model
from ..core.residency import DeviceColumn
from ..onnx.convert import ConvertedModel, convert_model
from ..ops.compile_cache import (StageCounters, resolve_input_specs,
                                 warm_up_model)
from ..parallel.mesh import feed_placement, local_devices
from ..utils.device import resolve_device
from .runner import BatchRunner, StagingSlabPool

__all__ = ["ONNXModel"]

_TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
                 "float16": torch.float16}


class ONNXModel(Model):
    model_bytes = ComplexParam(doc="serialized ONNX ModelProto")
    feed_dict = Param(dict, default={},
                      doc="{model input name: dataframe column}")
    fetch_dict = Param(dict, default={},
                       doc="{output column: model output name}")
    mini_batch_size = Param(int, default=64, doc="rows per device batch")
    softmax_dict = Param(dict, default={}, doc="{output col: col to softmax}")
    argmax_dict = Param(dict, default={}, doc="{output col: col to argmax}")
    compute_dtype = Param(str, default="float32",
                          choices=sorted(_TORCH_DTYPES),
                          doc="cast float inputs/params to this dtype "
                              "(bfloat16 recommended on the card)")
    normalize_dict = Param(dict, default={},
                           doc="{model input: {scale, mean, std}} applied on "
                               "device after the dtype cast; mean/std "
                               "broadcast over the channel axis (axis 1)")
    transpose_dict = Param(dict, default={},
                           doc="{model input: permutation} applied on device "
                               "before normalization, e.g. NHWC uint8 images "
                               "to the NCHW the graph expects: [0, 3, 1, 2]")
    mesh_sharded = Param(bool, default=False,
                         doc="not ported: SPMD inference over a device mesh")
    external_data_dir = Param(str, default="",
                              doc="directory holding the sidecar files of a "
                                  "model saved with external data")
    weights_override = ComplexParam(default=None,
                                    doc="npz of fine-tuned params layered "
                                        "over the initializers (set by "
                                        "ONNXEstimator.fit)")
    quantize = Param(str, default="", choices=["", "int8"],
                     doc="weight-only quantization: 2-D float weights live "
                         "on the card as symmetric per-column int8 + scale "
                         "and dequantize there each batch; activations "
                         "stay in compute_dtype")
    prefetch_depth = Param(int, default=2,
                           doc="prepared batches coerced/padded ahead on a "
                               "background worker while the current batch "
                               "dispatches; 0 = prepare inline")
    output_device = Param(bool, default=False,
                          doc="keep fetch outputs device-resident (attached "
                              "as DeviceColumns, no drain) so a downstream "
                              "device stage or sink pays the single d2h; "
                              "outputs keep their device dtypes (bf16 stays "
                              "bf16) until DataFrame.to_host materializes "
                              "them")
    buckets = Param((list, int), default=[],
                    doc="custom padding-bucket ladder (sorted batch sizes); "
                        "empty = next-power-of-two. Warm-up and the runner "
                        "derive every padded shape through the same ladder")
    tuning = Param(str, default="", choices=["", "auto"],
                   doc="'auto' consults the measurement-driven tuning store "
                       "(MMLSPARK_TPU_TUNING_DIR) at transform/warm_up: the "
                       "fitted cost model picks mini_batch_size, "
                       "prefetch_depth and the bucket ladder for the "
                       "observed row counts; a cold store keeps the "
                       "defaults and this run's measurements train it")

    def __init__(self, model_bytes: Optional[bytes] = None, device=None,
                 **kw):
        self._init_state(resolve_device(device))
        super().__init__(**kw)
        if model_bytes is not None:
            self.set(model_bytes=model_bytes)

    def _init_state(self, device: Optional[torch.device]) -> None:
        self._device = device
        self._converted: Optional[ConvertedModel] = None
        self._fn = None
        self._fn_sig = None
        self._fused_cols: set = set()
        self._argmax_cols: set = set()
        self._out_col_names: List[str] = []
        self._device_params: Dict[tuple, dict] = {}
        self._params_lock = threading.Lock()
        self._counters = StageCounters()
        self._staging: Dict[str, StagingSlabPool] = {}
        self._tuning_sig: Optional[str] = None
        self._tuning_decisions: Dict[tuple, object] = {}

    @classmethod
    def load(cls, path: str, device=None) -> "ONNXModel":
        """Load a saved model onto ``device`` (``None`` = the CUDA card)."""
        stage = super().load(path)
        stage._device = resolve_device(device)
        return stage

    @property
    def device(self) -> torch.device:
        """The device the model runs on; a model loaded inside a pipeline
        resolves ``None`` (the card) on first use."""
        if self._device is None:
            self._device = resolve_device(None)
        return self._device

    @property
    def stage_counters(self) -> StageCounters:
        """coerce/pad/h2d/dispatch/d2h (and warm-up ``compile``)
        instrumentation, cumulative over every transform/warm_up on this
        instance."""
        return self._counters

    # -- tuning --------------------------------------------------------------
    def tuning_signature(self) -> str:
        """Stable identity for the observation store: content hash of the
        graph plus the knobs that change its cost profile (the JAX
        package's format, so both packages name a graph alike)."""
        sig = getattr(self, "_tuning_sig", None)
        if sig is None:
            from ..onnx.proto import model_content_digest
            mb = self.get_or_none("model_bytes") or b""
            h = model_content_digest(bytes(mb))[:16]
            sig = f"onnx:{h}:{self.compute_dtype}:{self.quantize or 'fp'}"
            self._tuning_sig = sig
        return sig

    def _resolve_tuning(self, histogram: Dict[int, int]):
        """The store's pick for this histogram (None = off or cold store).
        Resolved sig-wide (placement "default"): one vocabulary serves every
        card, so warm-up and every partition agree on the ladder."""
        if self.get_or_none("tuning") != "auto":
            return None
        key = tuple(sorted(histogram.items()))
        if key not in self._tuning_decisions:
            from ..tuning.cost_model import resolve_tuning
            self._tuning_decisions[key] = resolve_tuning(
                self.tuning_signature(), "default", histogram,
                defaults=(self.mini_batch_size, self.prefetch_depth))
        return self._tuning_decisions[key]

    def _runner_config(self, n_rows: int):
        """Effective ``(mini_batch_size, prefetch_depth, ladder)``: the
        params unless ``tuning="auto"`` found a measured pick."""
        ladder = tuple(self.buckets) if self.get_or_none("buckets") else None
        decision = self._resolve_tuning({int(n_rows): 1})
        if decision is None:
            return self.mini_batch_size, self.prefetch_depth, ladder
        return (decision.mini_batch_size, decision.prefetch_depth,
                decision.buckets)

    # -- metadata (proto-only, no session) ----------------------------------
    def _ensure_converted(self) -> ConvertedModel:
        if self._converted is None:
            self._converted = convert_model(
                self.get("model_bytes"),
                external_data_dir=self.external_data_dir or None)
        return self._converted

    def _fetch_map(self, cm: ConvertedModel) -> Dict[str, str]:
        return dict(self.fetch_dict) or {n: n for n in cm.output_names}

    def _ensure_fn(self):
        """One callable: model graph + softmax/argmax post-ops, so outputs
        cross to the host exactly once."""
        cm = self._ensure_converted()
        fetch = self._fetch_map(cm)
        softmax = {k: v for k, v in self.softmax_dict.items() if v in fetch}
        argmax = {k: v for k, v in self.argmax_dict.items() if v in fetch}
        normalize = dict(self.normalize_dict)
        transpose = dict(self.transpose_dict)
        float_inputs = {vi.name for vi in cm.inputs
                        if np.issubdtype(vi.numpy_dtype, np.floating)}
        bad_norm = set(normalize) - float_inputs
        if bad_norm:
            # normalizing an integer-typed model input would silently zero it
            raise ValueError(
                f"normalize_dict targets non-float model inputs "
                f"{sorted(bad_norm)}; normalization requires a float-typed "
                f"graph input")
        compute_dt = _TORCH_DTYPES[self.compute_dtype]
        sig = (tuple(sorted(fetch.items())), tuple(sorted(softmax.items())),
               tuple(sorted(argmax.items())),
               tuple(sorted((k, str(v)) for k, v in normalize.items())),
               tuple(sorted((k, tuple(v)) for k, v in transpose.items())),
               str(compute_dt), self.quantize)
        if self._fn is None or self._fn_sig != sig:
            if set(fetch.values()) != set(cm.output_names):
                # dead-node elimination from the requested outputs
                cm = cm.pruned(sorted(set(fetch.values())))

            def prep(name, x):
                """On-device input prep: layout, dtype cast, normalization.
                Feeds cross the link in the column's own dtype (uint8 images
                are 4x smaller than float32)."""
                perm = transpose.get(name)
                if perm is not None:
                    x = x.permute(*perm)
                if name in float_inputs and x.dtype != compute_dt:
                    x = x.to(compute_dt)
                spec = normalize.get(name)
                if spec:
                    shape = (1, -1) + (1,) * (x.ndim - 2)
                    scale = spec.get("scale")
                    if scale is not None:
                        x = x * torch.tensor(scale, dtype=x.dtype)
                    mean = spec.get("mean")
                    if mean is not None:
                        x = x - _constant(mean, x).reshape(shape)
                    std = spec.get("std")
                    if std is not None:
                        x = x / _constant(std, x).reshape(shape)
                return x

            quantized = self.quantize == "int8"

            def run(params, feeds):
                feeds = {k: prep(k, v) for k, v in feeds.items()}
                if quantized:
                    params = _unpack_params(params, compute_dt)
                outs = cm(params, feeds)
                cols = {col: outs[name] for col, name in fetch.items()}
                for out_col, src in softmax.items():
                    cols[out_col] = torch.softmax(cols[src].float(), dim=-1)
                for out_col, src in argmax.items():
                    cols[out_col] = torch.argmax(cols[src], dim=-1).to(
                        torch.int32)
                return cols

            self._fn = run
            self._fn_sig = sig
            self._fused_cols = set(softmax) | set(argmax)
            self._argmax_cols = set(argmax)
            self._out_col_names = list(fetch) + \
                [c for c in self._fused_cols if c not in fetch]
        return self._fn

    def model_inputs(self) -> Dict[str, tuple]:
        cm = self._ensure_converted()
        return {vi.name: (vi.numpy_dtype, tuple(vi.shape)) for vi in cm.inputs}

    def model_outputs(self) -> Dict[str, tuple]:
        cm = self._ensure_converted()
        return {vi.name: (vi.numpy_dtype, tuple(vi.shape))
                for vi in cm.outputs}

    # -- column coercion (parity: ONNXModel.coerceBatchedDf :564-584) -------
    def _coerce(self, col, dtype, shape, device_prepped: bool = False):
        """A column slice → the feed array. Host arrays: floats cross the
        link as they are (float64 halved to float32), ints untouched, the
        cast to compute_dtype happens on device. Device tensors: the same
        policy as device ops, so the column never leaves the device."""
        want = np.dtype(dtype)
        if isinstance(col, torch.Tensor):
            arr = col
            if want.kind == "f":
                if arr.dtype == torch.float64:
                    arr = arr.float()
            elif arr.dtype != torch.from_numpy(np.zeros(0, want)).dtype:
                arr = arr.to(torch.from_numpy(np.zeros(0, want)).dtype)
        else:
            if col.dtype == object:
                col = np.stack([np.asarray(v) for v in col])
            arr = np.asarray(col)
            if want.kind == "f":
                if arr.dtype == np.float64 or arr.dtype.kind not in "fiu":
                    arr = arr.astype(np.float32)
            elif arr.dtype != want:
                arr = arr.astype(want)
        if device_prepped:
            return arr  # layout handled on device; shape is not NCHW yet
        # reshape flat rows to the model's per-row shape if one is declared
        row_shape = [d for d in shape[1:] if isinstance(d, int)]
        if row_shape and list(arr.shape[1:]) != row_shape \
                and int(np.prod(arr.shape[1:])) == int(np.prod(row_shape)):
            arr = arr.reshape((arr.shape[0],) + tuple(row_shape))
        return arr

    def _params_for_device(self, device: torch.device) -> dict:
        """Float params on ``device`` in ``compute_dtype`` (moved as float32,
        cast on the device), then packed to int8 where ``quantize="int8"``
        (:func:`_pack_params`, from the cast values, as the reference packs
        after its cast); the 8-bit weights of a quantized graph beside
        them. Cached per device and dtype; 4-D tensors ``channels_last`` on
        the card."""
        key = (str(device), self.compute_dtype)
        with self._params_lock:
            # staging stays under the lock: first touch per device is
            # single-flight, so racing partitions do not both copy the
            # weights
            if key not in self._device_params:
                cm = self._ensure_converted()
                dt = _TORCH_DTYPES[self.compute_dtype]
                quantize = self.quantize == "int8"
                out = {}
                for k, v in {**self._effective_params(cm),
                             **_quantized_weights(cm)}.items():
                    t = torch.from_numpy(np.ascontiguousarray(v)).to(device)
                    if t.is_floating_point():
                        t = t.to(dt)
                        if quantize and _quantizable(t):
                            out[k] = _pack(t)
                            continue
                    if device.type == "cuda" and t.ndim == 4:
                        t = t.contiguous(memory_format=torch.channels_last)
                    out[k] = t
                self._device_params[key] = out
            return self._device_params[key]

    def _effective_params(self, cm: ConvertedModel) -> dict:
        """The graph's initializers with the ``weights_override`` npz
        layered on top."""
        ov = self.get_or_none("weights_override")
        if not ov:
            return cm.params
        import io
        with np.load(io.BytesIO(ov)) as z:
            override = {k: z[k] for k in z.files}
        unknown = sorted(set(override) - set(cm.params))
        if unknown:
            raise ValueError(
                f"weights_override names unknown params {unknown[:5]} "
                "(the override must come from this graph's fine-tune)")
        return {**cm.params, **override}

    #: params whose change invalidates the cached device params
    _PARAM_CACHE_KEYS = ("weights_override", "quantize", "compute_dtype")

    def set(self, **kwargs):
        if any(k in kwargs for k in self._PARAM_CACHE_KEYS) \
                and getattr(self, "_device_params", None):
            # the cached params embed the previous packing and cast
            with self._params_lock:
                self._device_params.clear()
        if kwargs and getattr(self, "_tuning_decisions", None) is not None:
            # any reconfiguration may change the model signature or the
            # defaults the tuner compares against
            self._tuning_decisions.clear()
            self._tuning_sig = None
        return super().set(**kwargs)

    # -- execution ----------------------------------------------------------
    def _n_placements(self) -> int:
        """Placements real traffic can hit: every local card when the
        device names no index, else one."""
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
        """One partition through the shared feed/drain pipeline. Inference
        mode is entered here, in the partition's own thread (it is
        thread-local)."""
        with torch.inference_mode():
            return self._run_partition(part, pidx)

    def _run_partition(self, part: DataFrame, pidx: int) -> DataFrame:
        cm = self._ensure_converted()
        fn = self._ensure_fn()
        feed = self.feed_dict or {cm.input_names[0]: part.columns[0]}
        in_meta = {vi.name: vi for vi in cm.inputs}
        placement, params = self._placement_params(pidx)

        # resident input columns feed device slices straight through — no
        # host coercion, no staging slab, zero h2d payload; one concat per
        # partition, then every batch slice is a view
        resident = {col_name: part.device_column(col_name).device_array()
                    for col_name in feed.values()
                    if part.is_resident(col_name)}

        def coerce(sl: slice) -> Dict[str, object]:
            out = {}
            for input_name, col_name in feed.items():
                meta = in_meta[input_name]
                dev = resident.get(col_name)
                col = dev[sl] if dev is not None else part[col_name][sl]
                out[input_name] = self._coerce(
                    col, meta.numpy_dtype, meta.shape,
                    device_prepped=input_name in self.transpose_dict)
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
        if self.output_device:
            # keep outputs resident: no drain — the sink (DataFrame.to_host
            # or a downstream device stage) decides when to cross back
            pending = runner.run(len(part))
            out = part
            for col_name in self._out_col_names:
                chunks = [outs[col_name][:b] for outs, b in pending if b]
                if not chunks:
                    chunks = [torch.zeros((0,), dtype=torch.float32,
                                          device=placement.device)]
                out = out.with_device_column(
                    col_name, DeviceColumn.from_device(chunks))
            return out
        pending = runner.run_and_drain(len(part))

        out = part
        for col_name in self._out_col_names:
            chunks = [outs[col_name][:b] for outs, b in pending]
            arr = np.concatenate(chunks) if chunks \
                else np.zeros((0,), dtype=np.float32)
            if col_name in self._argmax_cols:
                arr = arr.astype(np.int64)
            out = out.with_column(col_name, arr)
        return out

    # -- warm-up -------------------------------------------------------------
    def warm_up(self, batch_sizes: Optional[List[int]] = None,
                input_specs: Optional[Dict[str, tuple]] = None,
                background: bool = False):
        """Run one zero batch of every padding-bucket shape through the
        graph on every placement real traffic can hit, before timing or
        serving: cuDNN's algorithm choice, lazy module loading and the
        allocator's growth happen here instead of in the first batches.

        ``batch_sizes`` defaults to ``[mini_batch_size]``; pass the expected
        ragged sizes too to warm their buckets. ``input_specs`` maps a
        model input to its fed ``(dtype, per-row shape)`` and is required
        when a column feeds a different dtype/layout than the graph
        declares (uint8 HWC images into a float NCHW input via
        ``transpose_dict``) or when the declared shape is symbolic.
        ``background=True`` warms on a daemon thread and returns it;
        otherwise returns ``{"buckets", "compiles", "seconds",
        "placements"}`` (``compiles``: buckets run). With
        ``tuning="auto"`` and a decision in the store, exactly the chosen
        vocabulary runs.
        """
        cm = self._ensure_converted()
        fn = self._ensure_fn()
        fed = dict(self.feed_dict) or {cm.input_names[0]: None}
        specs = resolve_input_specs(cm.inputs, fed, self.transpose_dict,
                                    overrides=input_specs)
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
        out = df.map_partitions(self._run_batches)
        # host fallback for post-ops whose source column does not come out
        # of the graph (parity: softMaxTransform/argMaxTransform :519-562)
        for out_col, src_col in self.softmax_dict.items():
            if out_col in self._fused_cols:
                continue
            out = out.with_column(out_col, _host_softmax(out[src_col]))
        for out_col, src_col in self.argmax_dict.items():
            if out_col in self._fused_cols:
                continue
            out = out.with_column(out_col, _host_argmax(out[src_col]))
        return out

    # -- persistence: rebuild run state after load --------------------------
    def _load_extra(self, path: str) -> None:
        # the device is not persisted: ``load(path, device=...)`` sets it,
        # a stage loaded inside a pipeline resolves the card on first use
        self._init_state(None)


# -- int8 weight-only quantization ---------------------------------------------

#: the smallest dimension a 2-D weight needs to be packed
_QUANT_MIN_DIM = 16


def _quantizable(t: torch.Tensor) -> bool:
    """2-D float weights (the matmul bulk of transformer and MLP graphs);
    conv kernels (4-D) and vectors stay in ``compute_dtype``."""
    return t.ndim == 2 and t.is_floating_point() and \
        min(t.shape) >= _QUANT_MIN_DIM


#: 1/127 rounded to float32: the reference's jitted pack divides by the
#: constant 127, which XLA compiles to this multiply
_INV_127 = float(np.float32(1.0 / 127.0))


def _pack(t: torch.Tensor) -> dict:
    """Symmetric per-column int8 on ``t``'s device: ``{"q": int8 codes,
    "s": float32 (1, columns) scales}``, codes round(t / s) half to even,
    s = max |column| · f32(1/127) (1 for an all-zero column)."""
    v32 = t.to(torch.float32)
    s = torch.amax(torch.abs(v32), dim=0, keepdim=True) * _INV_127
    s = torch.where(s == 0, torch.ones_like(s), s)
    q = torch.clamp(torch.round(v32 / s), -127, 127).to(torch.int8)
    return {"q": q, "s": s}


def _unpack_params(params: dict, dt: torch.dtype) -> dict:
    """Packed weights dequantized on their device, q · s in ``dt``."""
    return {k: (v["q"].to(dt) * v["s"].to(dt)) if isinstance(v, dict) else v
            for k, v in params.items()}


def _quantized_weights(cm: ConvertedModel) -> Dict[str, np.ndarray]:
    """The 8-bit weights (rank 2 and up) of a quantized graph: integer
    initializers are host constants of the converter, which would copy
    these to the device on every batch."""
    return {k: v for k, v in cm.const_params.items()
            if v.dtype in (np.int8, np.uint8) and v.ndim >= 2}


def _constant(values, x: torch.Tensor) -> torch.Tensor:
    """A normalization constant in ``x``'s dtype on ``x``'s device."""
    return torch.tensor(values, dtype=torch.float32).to(x.device,
                                                        non_blocking=True
                                                        ).to(x.dtype)


def _host_softmax(col: np.ndarray) -> np.ndarray:
    if col.dtype != object:
        v = np.asarray(col, dtype=np.float64)
        e = np.exp(v - v.max(axis=-1, keepdims=True))
        return e / e.sum(axis=-1, keepdims=True)
    probs = np.empty(len(col), dtype=object)
    for i, v in enumerate(col):
        v = np.asarray(v, dtype=np.float64)
        e = np.exp(v - v.max(axis=-1, keepdims=True))
        probs[i] = e / e.sum(axis=-1, keepdims=True)
    return probs


def _host_argmax(col: np.ndarray) -> np.ndarray:
    if col.dtype != object:
        return np.argmax(np.asarray(col), axis=-1).astype(np.int64)
    return np.asarray([int(np.argmax(np.asarray(v))) for v in col],
                      dtype=np.int64)

"""ONNXEstimator — fine-tune an ONNX graph as a pipeline Estimator
(counterpart of ``models/onnx_estimator.py``).

``fit(df)`` runs optimizer steps over the imported graph's params on the
card (:mod:`..onnx.train`) and returns a fitted :class:`ONNXModel` whose
``weights_override`` carries the tuned weights (the model bytes stay as
they were: a standard ONNX file plus a weight delta). Two objectives, as
in the JAX package:

* the graph carries its own loss output (e.g. a SoftmaxCrossEntropyLoss
  node): set ``loss_output`` and ``label_input``;
* or one is computed here: ``objective='softmax_cross_entropy' | 'mse'``
  over ``target_output`` against ``label_col``.

``trainable_prefix`` freezes every param outside the prefixes;
``lora_rank`` trains rank-r adapters over the 2-D weights instead (the
override then holds only the adapted matrices, merged).
``validation_indicator_col`` rows are held out and scored once an epoch;
with ``early_stopping_epochs`` the best epoch's params win. Batches are
drawn with the JAX package's ``np.random.default_rng(seed)`` calls, so
both packages train on the same batches in the same order. Training runs
in float32 on the estimator's device (a constructor keyword, ``None`` =
the CUDA card), and so does the fitted model.
"""

from __future__ import annotations

import io
from typing import Dict, Optional

import numpy as np
import torch

from ..core.dataframe import DataFrame
from ..core.params import ComplexParam, Param
from ..core.pipeline import Estimator
from ..utils.device import resolve_device
from .onnx_model import ONNXModel

__all__ = ["ONNXEstimator"]

_INFERENCE_KEYS = ["feed_dict", "fetch_dict", "mini_batch_size",
                   "softmax_dict", "argmax_dict", "compute_dtype",
                   "normalize_dict", "transpose_dict", "mesh_sharded",
                   "external_data_dir"]


class ONNXEstimator(Estimator):
    model_bytes = ComplexParam(doc="serialized ONNX ModelProto")
    feed_dict = Param(dict, default={},
                      doc="{model input name: dataframe column}")
    fetch_dict = Param(dict, default={},
                       doc="{output column: model output name} for the "
                           "fitted model")
    label_col = Param(str, default="label", doc="label column")
    label_input = Param(str, default=None,
                        doc="graph input the labels feed (graph-carried "
                            "loss mode)")
    loss_output = Param(str, default=None,
                        doc="graph output that IS the scalar loss")
    objective = Param(str, default="softmax_cross_entropy",
                      choices=["softmax_cross_entropy", "mse"],
                      doc="loss computed here when the graph has none")
    target_output = Param(str, default=None,
                          doc="graph output the objective scores "
                              "(default: the graph's only output)")
    optimizer = Param(str, default="adam", choices=["adam", "sgd"],
                      doc="optimizer (optax's adam / sgd defaults)")
    learning_rate = Param(float, default=1e-3, doc="step size")
    epochs = Param(int, default=1, doc="passes over the frame")
    batch_size = Param(int, default=64, doc="rows per training step")
    shuffle = Param(bool, default=True, doc="reshuffle rows every epoch")
    seed = Param(int, default=0, doc="shuffle seed")
    validation_indicator_col = Param(str, default=None,
                                     doc="bool column marking validation "
                                         "rows (enables early stopping)")
    early_stopping_epochs = Param(int, default=0,
                                  doc="stop after this many epochs without "
                                      "validation-loss improvement (0 = "
                                      "off); the best epoch's params win")
    trainable_prefix = Param((list, str), default=[],
                             doc="train only params whose name starts "
                                 "with one of these (empty = all)")
    lora_rank = Param(int, default=0,
                      doc="LoRA: train rank-r adapters over the 2-D "
                          "weights instead of the weights themselves "
                          "(0 = full fine-tuning)")
    lora_alpha = Param(float, default=0.0,
                       doc="LoRA delta scale alpha (alpha/rank * a@b); "
                           "0 = rank (scale 1)")
    mini_batch_size = Param(int, default=64,
                            doc="fitted model's inference batch size")
    softmax_dict = Param(dict, default={}, doc="fitted model passthrough")
    argmax_dict = Param(dict, default={}, doc="fitted model passthrough")
    compute_dtype = Param(str, default="float32",
                          doc="fitted model passthrough")
    normalize_dict = Param(dict, default={}, doc="fitted model passthrough")
    transpose_dict = Param(dict, default={}, doc="fitted model passthrough")
    pin_devices = Param(bool, default=True,
                        doc="fitted model passthrough (the port's ONNXModel "
                            "places batches itself)")
    mesh_sharded = Param(bool, default=False, doc="fitted model passthrough")
    external_data_dir = Param(str, default="", doc="fitted model passthrough")

    #: where training runs and the fitted model serves (a keyword, not a
    #: persisted param)
    device = None

    def __init__(self, model_bytes: Optional[bytes] = None,
                 eval_log: Optional[list] = None, device=None, **kw):
        if isinstance(kw.get("trainable_prefix"), str):
            kw["trainable_prefix"] = [kw["trainable_prefix"]]
        super().__init__(**kw)
        self.device = resolve_device(device)
        if model_bytes is not None:
            self.set(model_bytes=model_bytes)
        #: live list the per-step losses (floats) and per-epoch validation
        #: losses ({"epoch", "val_loss"}) append to during fit
        self._eval_log = eval_log

    def _column_feed(self, df: DataFrame, col: str) -> np.ndarray:
        c = df[col]
        if c.dtype == object:
            return np.stack([np.asarray(v) for v in c])
        return np.asarray(c)

    def _loss_fn(self, output_names):
        obj = self.get("objective")
        target = self.get_or_none("target_output")
        if target is None:
            if len(output_names) != 1:
                raise ValueError(
                    f"graph has outputs {list(output_names)}; pass "
                    "target_output to pick the one the objective scores")
            target = output_names[0]

        def loss_fn(outputs, feeds):
            out = outputs[target]
            y = feeds["__labels__"]
            if obj == "mse":
                # an (N, 1) head against (N,) labels would broadcast to an
                # (N, N) difference: align first
                if out.shape != y.shape:
                    out = out.reshape(y.shape)
                return ((out - y) ** 2).mean()
            lp = torch.log_softmax(out, dim=-1)
            return -lp.gather(-1, y[..., None].to(torch.int64)).mean()
        return loss_fn

    def _fit(self, df: DataFrame) -> ONNXModel:
        from ..onnx.convert import convert_model
        from ..onnx import train as T

        dev = self.device
        cm = convert_model(self.get("model_bytes"),
                           external_data_dir=self.external_data_dir or None)
        feeds_cols: Dict[str, np.ndarray] = {
            inp: self._column_feed(df, col)
            for inp, col in self.feed_dict.items()}
        vcol = self.get_or_none("validation_indicator_col")
        val_feeds = None
        y_val = None
        if vcol and vcol not in df:
            # a silent fallthrough would train on the intended holdout
            raise ValueError(f"validation_indicator_col {vcol!r} not in "
                             f"the frame (columns: {list(df.columns)})")
        if vcol:
            mask = np.asarray(df[vcol], dtype=bool)
            val_feeds = {k: v[mask] for k, v in feeds_cols.items()}
            y_val = np.asarray(df[self.label_col])[mask]
            feeds_cols = {k: v[~mask] for k, v in feeds_cols.items()}
            df = df.filter(~mask)
        y = np.asarray(df[self.label_col])
        n = len(df)
        patience = int(self.early_stopping_epochs)
        if patience and val_feeds is None:
            raise ValueError("early_stopping_epochs needs "
                             "validation_indicator_col rows")
        if n < int(self.batch_size):
            raise ValueError(
                f"fewer rows ({n}) than batch_size ({self.batch_size}); "
                "no training step would run")

        loss_output = self.get_or_none("loss_output")
        label_input = self.get_or_none("label_input")
        if loss_output is not None:
            if label_input is None:
                raise ValueError("loss_output mode needs label_input (the "
                                 "graph input the labels feed)")
            loss_fn = None
        else:
            loss_fn = self._loss_fn(cm.output_names)

        opt = (T.adam if self.optimizer == "adam" else T.sgd)(
            float(self.learning_rate))
        prefixes = list(self.trainable_prefix)
        trainable = (None if not prefixes else
                     (lambda name: any(name.startswith(p)
                                       for p in prefixes)))
        lora_rank = int(self.lora_rank)
        lora_names = None
        if lora_rank > 0:
            # adapters train instead of the weights; trainable_prefix
            # narrows which matrices get them
            lora_names = T.lora_targets(cm, lora_rank, trainable)
            lora = T.init_lora(cm, lora_rank, targets=lora_names,
                               seed=int(self.seed), device=dev)
            alpha = float(self.lora_alpha) or float(lora_rank)
            l_step, l_init = T.make_lora_train_step(
                cm, opt, alpha=alpha, loss_fn=loss_fn, output=loss_output,
                device=dev)
            base = {k: torch.from_numpy(np.array(v)).to(dev)
                    for k, v in cm.params.items()}
            opt_state = l_init(lora)
            state = opt_state.leaves

            def do_step(state, opt_state, feeds):
                return l_step(base, state, opt_state, feeds)

            def params_of(state):
                with torch.no_grad():
                    return T.lora_merge(base, state, alpha)
        else:
            step, init = T.make_train_step(cm, opt, loss_fn=loss_fn,
                                           output=loss_output,
                                           trainable=trainable, device=dev)
            opt_state = init(cm.params)
            state = opt_state.leaves
            do_step = step

            def params_of(state):
                return state

        val_loss_fn = None
        if val_feeds is not None:
            vf = {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
                  for k, v in val_feeds.items()}
            vf[label_input if loss_output is not None
               else "__labels__"] = torch.from_numpy(
                   np.ascontiguousarray(y_val)).to(dev)

            def val_loss_fn(params):
                with torch.no_grad():
                    if loss_output is not None:
                        return cm(params, vf)[loss_output]
                    return loss_fn(cm(params, vf), vf)

        bs = int(self.batch_size)
        rng = np.random.default_rng(int(self.seed))
        log = getattr(self, "_eval_log", None)
        best_val = np.inf
        best_params = None
        since_best = 0
        lab_key = label_input if loss_output is not None else "__labels__"
        for ep in range(int(self.epochs)):
            # full batches only, as the reference draws them: shuffled
            # epochs fold the remainder into the next permutation,
            # unshuffled ones rotate the start offset
            if self.shuffle:
                order = rng.permutation(n)
            else:
                order = np.roll(np.arange(n), -(ep * bs) % max(n, 1))
            for lo in range(0, n - bs + 1, bs):
                sel = order[lo:lo + bs]
                feeds = {k: v[sel] for k, v in feeds_cols.items()}
                feeds[lab_key] = y[sel]
                state, opt_state, val = do_step(state, opt_state, feeds)
                if log is not None:
                    log.append(float(val))
            if val_loss_fn is not None:
                vl = float(val_loss_fn(params_of(state)))
                if log is not None:
                    log.append({"epoch": ep, "val_loss": vl})
                if vl < best_val - 1e-12:
                    best_val = vl
                    since_best = 0
                    if patience:
                        # LoRA snapshots are the small adapter tree
                        best_params = _snapshot(state)
                else:
                    since_best += 1
                    if patience and since_best >= patience:
                        break
        if best_params is not None:
            state = best_params
        params = params_of(state)
        if lora_names is not None:
            # the override needs only the adapted matrices; the rest layer
            # from the graph's own initializers
            params = {k: params[k] for k in lora_names}

        buf = io.BytesIO()
        np.savez(buf, **{k: v.detach().cpu().numpy()
                         for k, v in params.items()})
        inference = {k: self.get(k) for k in _INFERENCE_KEYS}
        if loss_output is not None and not inference["fetch_dict"]:
            # the default fetch would include the loss, whose labels input
            # is never fed at inference: serve the other outputs
            inference["fetch_dict"] = {o: o for o in cm.output_names
                                       if o != loss_output}
        m = ONNXModel(self.get("model_bytes"), device=dev, **inference)
        m.set(weights_override=buf.getvalue())
        return m


def _snapshot(state: Dict) -> Dict:
    """Detached copies of a params dict or an adapter tree."""
    return {k: (_snapshot(v) if isinstance(v, dict)
                else v.detach().clone()) for k, v in state.items()}

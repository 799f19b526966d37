"""ONNX fine-tuning in the port (``onnx/train.py``,
``models/onnx_estimator.py``, ``ONNXModel(weights_override=)``) against
the JAX package's, following ``tests/test_onnx_train.py``: the same
graphs and data through both, losses and gradients within the stated
tolerances, optimizer steps with optax's defaults, LoRA from the same
adapters, the estimator's logs, early stopping and refusals, and the
fitted override served by both ``ONNXModel``s."""

import io
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mmlspark_tpu.core import DataFrame as JDF
from mmlspark_tpu.models.onnx_estimator import ONNXEstimator as JEstimator
from mmlspark_tpu.models.onnx_model import ONNXModel as JModel
from mmlspark_tpu.onnx import train as jt
from mmlspark_tpu.onnx.convert import convert_model as jconvert
from mmlspark_tpu_torch.core import DataFrame as PDF
from mmlspark_tpu_torch.models.onnx_estimator import ONNXEstimator as PEstimator
from mmlspark_tpu_torch.models.onnx_model import ONNXModel as PModel
from mmlspark_tpu_torch.models.zoo.bert_onnx import (BertOnnxConfig,
                                                     export_bert_onnx,
                                                     init_bert_params)
from mmlspark_tpu_torch.onnx import train as pt
from mmlspark_tpu_torch.onnx.convert import convert_model as pconvert

from test_onnx_train import mlp_with_loss, toy_data

torch.set_num_threads(1)  # one a worker: README, "Testing & benchmarks"

sys.path.insert(0, __file__.rsplit("/tests/", 1)[0])
from chip_smoke import fused_bert_onnx  # noqa: E402


def _close_grads(gj, gp):
    """Each gradient within 1e-5 of its max |g| + 1e-7."""
    assert set(gp) == set(gj)
    for k, g in gj.items():
        g = np.asarray(g)
        np.testing.assert_allclose(gp[k].numpy(), g, rtol=0,
                                   atol=1e-5 * np.abs(g).max() + 1e-7,
                                   err_msg=k)


def _col(X):
    col = np.empty(len(X), dtype=object)
    col[:] = list(X)
    return col


@pytest.fixture(scope="module")
def mlp():
    mb = mlp_with_loss()
    return mb, jconvert(mb), pconvert(mb)


def test_value_and_grad_mlp(mlp):
    _, cj, cp = mlp
    X, y = toy_data(32)
    feeds = {"x": X, "labels": y}
    vj, gj = jt.value_and_grad(cj, output="loss")(cj.params, feeds)
    vp, gp = pt.value_and_grad(cp, output="loss", device="cpu")(cp.params,
                                                                 feeds)
    assert abs(float(vp) - float(vj)) <= 1e-5 * abs(float(vj))
    _close_grads(gj, gp)
    with pytest.raises(ValueError, match="several outputs"):
        pt.value_and_grad(cp, device="cpu")(cp.params, feeds)


@pytest.fixture(scope="module")
def bert():
    """A 2-layer BERT, fused (ORT contrib ops, a CLS head and a graph
    loss) and decomposed (``export_bert_onnx(opset=17)``), with padded
    rows."""
    cfg = BertOnnxConfig(layers=2)
    params = init_bert_params(cfg, seed=1)
    rng = np.random.default_rng(2)
    head = (rng.normal(0, 0.02, (cfg.d_model, 2)).astype(np.float32),
            np.zeros(2, np.float32))
    B, S = 4, 16
    ids = rng.integers(0, cfg.vocab, (B, S)).astype(np.int64)
    mask = (np.arange(S)[None] < rng.integers(6, S + 1, (B, 1))).astype(
        np.int64)
    feeds = {"input_ids": ids, "attention_mask": mask,
             "labels": rng.integers(0, 2, B).astype(np.int64)}
    return (cfg, params, head, feeds, fused_bert_onnx(cfg, params, head=head),
            export_bert_onnx(cfg, opset=17, params=params))


def test_value_and_grad_fused_bert(bert):
    """Through EmbedLayerNormalization, Attention (the port's
    ``_attention_core``), SkipLayerNormalization, BiasGelu, Gather and
    SoftmaxCrossEntropyLoss."""
    *_, feeds, fused, _dec = bert
    cj, cp = jconvert(fused), pconvert(fused)
    vj, gj = jt.value_and_grad(cj, output="loss")(cj.params, feeds)
    vp, gp = pt.value_and_grad(cp, output="loss", device="cpu")(cp.params,
                                                                 feeds)
    assert abs(float(vp) - float(vj)) <= 1e-5 * abs(float(vj))
    _close_grads(gj, gp)


def test_value_and_grad_decomposed_bert(bert):
    """A loss over an output (``loss_fn``): the CLS row through a head."""
    _cfg, _p, head, feeds, _fused, dec = bert
    w, b = head

    def lf_j(o, f):
        lp = jax.nn.log_softmax(o["last_hidden_state"][:, 0] @ w + b, -1)
        return -jnp.take_along_axis(lp, f["labels"][:, None], 1).mean()

    def lf_p(o, f):
        lg = o["last_hidden_state"][:, 0] @ torch.from_numpy(w) + \
            torch.from_numpy(b)
        return -torch.log_softmax(lg, -1).gather(1, f["labels"][:, None]
                                                 ).mean()
    cj, cp = jconvert(dec), pconvert(dec)
    vj, gj = jt.value_and_grad(cj, loss_fn=lf_j)(cj.params, feeds)
    vp, gp = pt.value_and_grad(cp, loss_fn=lf_p, device="cpu")(cp.params,
                                                                feeds)
    assert abs(float(vp) - float(vj)) <= 1e-5 * abs(float(vj))
    _close_grads(gj, gp)


@pytest.mark.parametrize("name", ["adam", "sgd"])
def test_steps_match_optax(name, mlp):
    """Five steps, ``w1`` frozen: losses within 1e-4, params within
    0.05 * lr of optax's (Adam's first step is about lr * sign(g)), the
    frozen param bitwise unchanged."""
    _, cj, cp = mlp
    lr = 1e-2 if name == "adam" else 0.1
    X, y = toy_data(32)
    feeds = {"x": X, "labels": y}
    frozen = lambda k: k != "w1"  # noqa: E731
    sj, ij = jt.make_train_step(cj, getattr(optax, name)(lr), output="loss",
                                trainable=frozen)
    sp, ip = pt.make_train_step(cp, getattr(pt, name)(lr), output="loss",
                                trainable=frozen, device="cpu")
    pj = {k: jnp.asarray(v) for k, v in cj.params.items()}
    oj = ij(pj)
    op = ip(cp.params)
    pp = op.leaves
    for _ in range(5):
        pj, oj, lj = sj(pj, oj, feeds)
        pp, op, lp = sp(pp, op, feeds)
        assert abs(float(lp) - float(lj)) <= 1e-4
    for k in pj:
        np.testing.assert_allclose(pp[k].detach().numpy(), np.asarray(pj[k]),
                                   rtol=0, atol=0.05 * lr, err_msg=k)
    np.testing.assert_array_equal(pp["w1"].detach().numpy(),
                                  cp.params["w1"])
    assert not pp["w1"].requires_grad


def test_fine_tune_loop_and_functional_params(mlp):
    _, _, cp = mlp
    X, y = toy_data(256)
    feeds = {"x": X, "labels": y}
    params, losses = pt.fine_tune(cp, iter([feeds] * 30),
                                  optimizer=pt.adam(5e-2), output="loss",
                                  device="cpu")
    assert len(losses) == 30 and losses[-1] < 0.5 * losses[0]
    acc = (cp(params, feeds)["logits"].argmax(1).numpy() == y).mean()
    assert acc > 0.85
    # a step given plain values starts from them, as the reference's does
    step, init = pt.make_train_step(cp, pt.sgd(0.1), output="loss",
                                    device="cpu")
    state = init(cp.params)
    a, _, la = step(cp.params, state, feeds)
    b, _, lb = step(cp.params, state, feeds)
    assert float(la) == float(lb)


@pytest.fixture(scope="module")
def lora_steps(mlp):
    """Five LoRA steps in both packages from the JAX package's adapters."""
    _, cj, cp = mlp
    X, y = toy_data(64, seed=2)
    feeds = {"x": X, "labels": y}
    lj = jt.init_lora(cj, 2, seed=3)
    lp = pt.init_lora(cp, 2, seed=3, device="cpu")
    lora_np = {k: {n: np.asarray(t) for n, t in ab.items()}
               for k, ab in lj.items()}
    sj, ij = jt.make_lora_train_step(cj, optax.adam(1e-2), output="loss")
    sp, ip = pt.make_lora_train_step(cp, pt.adam(1e-2), output="loss",
                                     device="cpu")
    base_j = {k: jnp.asarray(v) for k, v in cj.params.items()}
    base_p = {k: torch.from_numpy(np.array(v)) for k, v in cp.params.items()}
    snap = {k: v.clone() for k, v in base_p.items()}
    oj, op = ij(lj), ip(lora_np)
    aj, ap = lj, op.leaves
    losses = []
    for _ in range(5):
        aj, oj, vj = sj(base_j, aj, oj, feeds)
        ap, op, vp = sp(base_p, ap, op, feeds)
        losses.append((float(vj), float(vp)))
    return lj, lp, aj, ap, base_p, snap, losses


def test_lora_matches_the_reference(lora_steps):
    lj, lp, aj, ap, base_p, snap, losses = lora_steps
    for k in lj:
        # the port's threefry normals, within a few ulps of jax.random's
        np.testing.assert_allclose(lp[k]["a"].numpy(), np.asarray(lj[k]["a"]),
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_array_equal(lp[k]["b"].numpy(), 0.0)
        for n in ("a", "b"):
            np.testing.assert_allclose(ap[k][n].detach().numpy(),
                                       np.asarray(aj[k][n]), rtol=0,
                                       atol=0.05 * 1e-2, err_msg=f"{k}.{n}")
    for vj, vp in losses:
        assert abs(vp - vj) <= 1e-4
    for k in snap:                      # the base is never written
        assert torch.equal(base_p[k], snap[k])


def test_lora_merge_and_targets(mlp, lora_steps):
    _, cj, cp = mlp
    lj, _, aj, ap, *_ = lora_steps
    assert pt.lora_targets(cp, 2) == jt.lora_targets(cj, 2) == ["w1", "w2"]
    assert pt.lora_targets(cp, 4) == ["w1"]
    mj = jt.lora_merge(dict(cj.params), aj, 4.0)
    mp = pt.lora_merge(dict(cp.params), {k: {n: t.detach() for n, t in
                                             ab.items()}
                                         for k, ab in ap.items()}, 4.0)
    for k in mj:
        np.testing.assert_allclose(np.asarray(mp[k]), np.asarray(mj[k]),
                                   rtol=0, atol=1e-3)
    assert mp["b1"] is cp.params["b1"]          # not adapted: passed on
    zero = pt.lora_merge(dict(cp.params), pt.init_lora(cp, 2,
                                                       device="cpu"), 2.0)
    for k in cp.params:
        np.testing.assert_array_equal(np.asarray(zero[k]), cp.params[k])
    for kw, match in (({"rank": 0}, "rank"),
                      ({"rank": 2, "targets": ["nope"]}, "unknown"),
                      ({"rank": 100}, "no 2-D"),
                      ({"rank": 2, "targets": ["b1"]}, "2-D")):
        with pytest.raises(ValueError, match=match):
            pt.init_lora(cp, device="cpu", **kw)


def test_lora_fine_tune_loop(mlp):
    _, _, cp = mlp
    X, y = toy_data(256, seed=2)
    before = {k: v.copy() for k, v in cp.params.items()}
    merged, lora, losses = pt.lora_fine_tune(
        cp, iter([{"x": X, "labels": y}] * 40), rank=3,
        optimizer=pt.adam(5e-2), output="loss", device="cpu")
    assert losses[-1] < 0.5 * losses[0]
    for k, v in cp.params.items():
        np.testing.assert_array_equal(v, before[k])
    np.testing.assert_array_equal(np.asarray(merged["b1"]), before["b1"])
    assert sorted(lora) == ["w1"]          # w2 (8, 3) is not wider than 3


# -- the estimator -------------------------------------------------------------

EST = dict(feed_dict={"x": "features"}, fetch_dict={"logits": "logits"},
           loss_output="loss", label_input="labels", batch_size=32,
           learning_rate=5e-2)


@pytest.fixture(scope="module")
def fitted():
    """The graph-carried-loss estimator, both packages, with a validation
    split and early stopping (the same batches: one shuffle stream)."""
    X, y = toy_data(200, seed=20)
    val = np.zeros(200, bool)
    val[150:] = True
    cols = {"features": _col(X), "label": y, "val": val}
    out = {}
    for name, est_cls, frame, kw in (("jax", JEstimator, JDF, {}),
                                     ("port", PEstimator, PDF,
                                      {"device": "cpu"})):
        log = []
        m = est_cls(mlp_with_loss(), eval_log=log, epochs=40,
                    validation_indicator_col="val", early_stopping_epochs=2,
                    **{**EST, "learning_rate": 0.3}, **kw).fit(frame(cols))
        out[name] = (m, log)
    return cols, out


def test_estimator_eval_log_and_early_stopping(fitted):
    _, out = fitted
    (_, lj), (mp, lp) = out["jax"], out["port"]
    steps_j = [e for e in lj if not isinstance(e, dict)]
    steps_p = [e for e in lp if not isinstance(e, dict)]
    ep_j = [e for e in lj if isinstance(e, dict)]
    ep_p = [e for e in lp if isinstance(e, dict)]
    assert len(steps_p) == len(steps_j) and len(ep_p) == len(ep_j) < 40
    # the first steps as the optimizer test holds them; over the run (lr
    # 0.3, ~80 Adam steps) float32 rounding differences grow, so the
    # rest within 1e-3
    np.testing.assert_allclose(steps_p[:5], steps_j[:5], rtol=0, atol=1e-4)
    np.testing.assert_allclose(steps_p, steps_j, rtol=0, atol=1e-3)
    np.testing.assert_allclose([e["val_loss"] for e in ep_p],
                               [e["val_loss"] for e in ep_j], rtol=0,
                               atol=1e-3)
    best = [int(np.argmin([e["val_loss"] for e in ep])) for ep in (ep_j,
                                                                   ep_p)]
    assert best[0] == best[1]


def test_weights_override_serves_as_the_reference(fitted):
    """The JAX estimator's override through both ``ONNXModel``s: the same
    logits; the port estimator's own model serves its override."""
    cols, out = fitted
    mj, mp = out["jax"][0], out["port"][0]
    ov = mj.get("weights_override")
    kw = dict(feed_dict={"x": "features"}, fetch_dict={"logits": "logits"})
    frame = {"features": cols["features"]}
    oj = np.stack(list(JModel(mlp_with_loss(), weights_override=ov, **kw)
                       .transform(JDF(frame))["logits"]))
    op = np.stack(list(PModel(mlp_with_loss(), weights_override=ov,
                              device="cpu", **kw)
                       .transform(PDF(frame))["logits"]))
    np.testing.assert_allclose(op, oj, rtol=1e-5, atol=1e-6)
    base = np.stack(list(PModel(mlp_with_loss(), device="cpu", **kw)
                         .transform(PDF(frame))["logits"]))
    assert not np.allclose(op, base)
    own = np.stack(list(mp.transform(PDF(frame))["logits"]))
    with np.load(io.BytesIO(mp.get("weights_override"))) as z:
        params = {**pconvert(mlp_with_loss()).params,
                  **{k: z[k] for k in z.files}}
    cm = pconvert(mlp_with_loss())
    direct = cm.pruned(["logits"])(
        {k: torch.from_numpy(v) for k, v in params.items()},
        {"x": torch.from_numpy(np.stack(list(cols["features"])))})["logits"]
    np.testing.assert_allclose(own, direct.numpy(), rtol=1e-6, atol=1e-6)
    bad = io.BytesIO()
    np.savez(bad, nope=np.zeros(3, np.float32))
    for model in (JModel(mlp_with_loss(), weights_override=bad.getvalue(),
                         **kw),
                  PModel(mlp_with_loss(), weights_override=bad.getvalue(),
                         device="cpu", **kw)):
        frame_cls = JDF if isinstance(model, JModel) else PDF
        with pytest.raises(ValueError, match="unknown params"):
            model.transform(frame_cls(frame))


def test_estimator_objective_mode_and_frozen_prefix():
    """No loss node: the objective is computed here; ``w1`` frozen (its
    override entry is the graph's own), losses as the reference's."""
    import mmlspark_tpu_torch.onnx as PO
    rng = np.random.default_rng(7)
    g = PO.make_graph(
        [PO.make_node("MatMul", ["x", "w1"], ["h"]),
         PO.make_node("Relu", ["h"], ["hr"]),
         PO.make_node("MatMul", ["hr", "w2"], ["logits"])],
        "plain",
        inputs=[PO.make_tensor_value_info("x", np.float32, ["N", 6])],
        outputs=[PO.make_tensor_value_info("logits", np.float32, ["N", 3])],
        initializers={"w1": rng.normal(0, 0.5, (6, 8)).astype(np.float32),
                      "w2": rng.normal(0, 0.5, (8, 3)).astype(np.float32)})
    mb = PO.make_model(g)
    X, y = toy_data(96, seed=6)
    cols = {"features": _col(X), "label": y}
    logs = {}
    for name, cls, frame, kw in (("jax", JEstimator, JDF, {}),
                                 ("port", PEstimator, PDF,
                                  {"device": "cpu"})):
        log = []
        for objective in ("softmax_cross_entropy", "mse"):
            yy = y if objective != "mse" else None
            if yy is None:
                continue
            m = cls(mb, feed_dict={"x": "features"},
                    fetch_dict={"logits": "logits"}, objective=objective,
                    target_output="logits", trainable_prefix="w2",
                    epochs=4, batch_size=32, learning_rate=5e-2,
                    eval_log=log, **kw).fit(frame(cols))
        logs[name] = (log, m)
    np.testing.assert_allclose(logs["port"][0], logs["jax"][0], rtol=0,
                               atol=1e-4)
    with np.load(io.BytesIO(logs["port"][1].get("weights_override"))) as z:
        ov = {k: z[k] for k in z.files}
    cm = pconvert(mb)
    np.testing.assert_array_equal(ov["w1"], cm.params["w1"])
    assert np.abs(ov["w2"] - cm.params["w2"]).max() > 0


def test_estimator_mse_objective_matches_reference():
    """mse over an (N, 1) head against (N,) labels (aligned, not
    broadcast to (N, N))."""
    import mmlspark_tpu_torch.onnx as PO
    rng = np.random.default_rng(8)
    g = PO.make_graph(
        [PO.make_node("MatMul", ["x", "w"], ["out"])], "reg",
        inputs=[PO.make_tensor_value_info("x", np.float32, ["N", 6])],
        outputs=[PO.make_tensor_value_info("out", np.float32, ["N", 1])],
        initializers={"w": rng.normal(0, 0.5, (6, 1)).astype(np.float32)})
    mb = PO.make_model(g)
    X, _ = toy_data(64, seed=8)
    y = (X @ np.arange(6, dtype=np.float32) / 6).astype(np.float32)
    cols = {"features": _col(X), "label": y}
    logs = []
    for cls, frame, kw in ((JEstimator, JDF, {}),
                           (PEstimator, PDF, {"device": "cpu"})):
        log = []
        cls(mb, feed_dict={"x": "features"}, objective="mse", epochs=3,
            batch_size=16, optimizer="sgd", learning_rate=0.05,
            eval_log=log, **kw).fit(frame(cols))
        logs.append(log)
    np.testing.assert_allclose(logs[1], logs[0], rtol=1e-5, atol=1e-6)


def test_estimator_default_fetch_small_frame_and_patience():
    X, y = toy_data(64, seed=9)
    cols = {"features": _col(X), "label": y}
    model = PEstimator(mlp_with_loss(), device="cpu",
                       feed_dict={"x": "features"}, loss_output="loss",
                       label_input="labels", epochs=1,
                       batch_size=32).fit(PDF(cols))
    out = model.transform(PDF({"features": cols["features"]}))
    assert "loss" not in out.columns
    assert np.asarray(out["logits"][0]).shape == (3,)
    small = PEstimator(mlp_with_loss(), device="cpu",
                       feed_dict={"x": "features"}, loss_output="loss",
                       label_input="labels", trainable_prefix="w2",
                       batch_size=32)
    assert small.get("trainable_prefix") == ["w2"]
    with pytest.raises(ValueError, match="fewer rows"):
        small.fit(PDF(cols).head(8))
    with pytest.raises(ValueError, match="validation_indicator_col"):
        PEstimator(mlp_with_loss(), device="cpu",
                   feed_dict={"x": "features"}, loss_output="loss",
                   label_input="labels", early_stopping_epochs=2,
                   batch_size=32).fit(PDF(cols))
    with pytest.raises(ValueError, match="label_input"):
        PEstimator(mlp_with_loss(), device="cpu",
                   feed_dict={"x": "features"}, loss_output="loss",
                   batch_size=32).fit(PDF(cols))


def test_estimator_lora_mode_matches_reference():
    X, y = toy_data(128, seed=7)
    cols = {"features": _col(X), "label": y}
    logs, models = [], []
    for cls, frame, kw in ((JEstimator, JDF, {}),
                           (PEstimator, PDF, {"device": "cpu"})):
        log = []
        models.append(cls(mlp_with_loss(), epochs=3, lora_rank=2,
                          eval_log=log, **EST, **kw).fit(frame(cols)))
        logs.append(log)
    np.testing.assert_allclose(logs[1], logs[0], rtol=0, atol=1e-4)
    with np.load(io.BytesIO(models[1].get("weights_override"))) as z:
        assert sorted(z.files) == ["w1", "w2"]

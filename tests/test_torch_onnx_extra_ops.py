"""The port's ``onnx/extra_ops.py`` against the JAX converter on the CPU:
every case of ``tests/test_onnx_extra_ops.py``.

Each graph is written once with the port's builder and fed the same
seeded numpy inputs through both converters (the JAX one eagerly, its
feeds as jax arrays), then held to the JAX test's own independent
reference (numpy, scipy, ``torch.nn.functional``, Hugging Face T5) where
it has one. Tolerances:

* integer and boolean outputs (the bitwise ops, ``MatMulInteger``,
  ``ConvInteger``, ``DynamicQuantizeLinear``'s codes and zero point),
  bitwise;
* float outputs within 1e-5 · max|ref| + 1e-6 of the JAX converter's
  (``tests/test_torch_onnx_ops.py``'s bound), and the JAX test's own
  tolerance against its reference;
* each refusal of the JAX handler is a refusal of the port's;
* the ``Random*`` ops draw from the port's own generator, so they are held
  by their moments, their range and their determinism only.

Size-like inputs (a window size, ``MelWeightMatrix``'s arguments) are
initializers here: the port refuses them fed, as device tensors
(:func:`test_fed_size_is_refused`), where the JAX test feeds some.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import mmlspark_tpu.onnx as J
import mmlspark_tpu_torch.onnx as O
from mmlspark_tpu.onnx.convert import UnsupportedOp as JaxUnsupported
from mmlspark_tpu_torch.onnx.convert import UnsupportedOp

torch.set_num_threads(1)  # one a worker: README, "Testing & benchmarks"


def _model(nodes, feeds, outs, inits=None, opset=18):
    g = O.make_graph(
        nodes, "g",
        [O.make_tensor_value_info(k, np.asarray(v).dtype, list(np.shape(v)))
         for k, v in feeds.items()],
        [O.make_tensor_value_info(o, np.float32, ["?"]) for o in outs],
        initializers=inits or {})
    return O.make_model(g, opset=opset, extra_opsets={"com.microsoft": 1})


def _port(data, feeds, outs):
    pm = O.convert_model(data)
    res = pm({k: torch.from_numpy(v) for k, v in pm.params.items()},
             {k: torch.from_numpy(np.array(v)) for k, v in feeds.items()})
    return [res[o].numpy() for o in outs]


def _jax(data, feeds, outs):
    jm = J.convert_model(data)
    res = jm(jm.params, {k: jnp.asarray(v) for k, v in feeds.items()})
    return [np.asarray(res[o]) for o in outs]


def _hold(got, want, what):
    assert got.shape == want.shape, (what, got.shape, want.shape)
    assert got.dtype.kind == want.dtype.kind, (what, got.dtype, want.dtype)
    if want.dtype.kind != "f":
        np.testing.assert_array_equal(got, want, err_msg=what)
        return
    tol = 1e-5 * float(np.abs(want).max(initial=0.0)) + 1e-6
    err = float(np.abs(got.astype(np.float64) - want).max(initial=0.0))
    assert err <= tol, f"{what}: max |port - jax| {err} > {tol}"


def run(nodes, feeds, outs, initializers=None):
    """Both converters; every output held; the port's outputs returned."""
    data = _model(nodes, feeds, outs, initializers)
    got, want = _port(data, feeds, outs), _jax(data, feeds, outs)
    for o, g, w in zip(outs, got, want):
        _hold(g, w, o)
    return got


def refused(nodes, feeds, outs, initializers=None, match=None):
    data = _model(nodes, feeds, outs, initializers)
    with pytest.raises(JaxUnsupported, match=match):
        _jax(data, feeds, outs)
    with pytest.raises(UnsupportedOp, match=match):
        _port(data, feeds, outs)


# -- small ops --------------------------------------------------------------

def test_reduce_log_sum():
    x = np.abs(np.random.default_rng(0).normal(1, 1, (3, 4))).astype(
        np.float32)
    (y,) = run([O.make_node("ReduceLogSum", ["x", "ax"], ["y"])],
               {"x": x}, ["y"], {"ax": np.array([1], np.int64)})
    np.testing.assert_allclose(y, np.log(x.sum(1, keepdims=True)), rtol=1e-5)


@pytest.mark.parametrize("op,ref", [
    ("BitwiseAnd", np.bitwise_and), ("BitwiseOr", np.bitwise_or),
    ("BitwiseXor", np.bitwise_xor)])
def test_bitwise_binary(op, ref):
    a = np.array([0b1100, 0b1010, -7], np.int32)
    b = np.array([0b1010, 0b0110, 12], np.int32)
    (y,) = run([O.make_node(op, ["a", "b"], ["y"])], {"a": a, "b": b},
               ["y"])
    np.testing.assert_array_equal(y, ref(a, b))


def test_bitwise_not():
    a = np.array([0b1100, 0b1010, -7], np.int32)
    (y,) = run([O.make_node("BitwiseNot", ["a"], ["y"])], {"a": a}, ["y"])
    np.testing.assert_array_equal(y, ~a)
    u = np.array([0, 7, 255], np.uint8)
    (z,) = run([O.make_node("BitwiseNot", ["a"], ["y"])], {"a": u}, ["y"])
    np.testing.assert_array_equal(z, ~u)


def test_det():
    x = np.random.default_rng(1).normal(0, 1, (4, 3, 3)).astype(np.float32)
    (y,) = run([O.make_node("Det", ["x"], ["y"])], {"x": x}, ["y"])
    np.testing.assert_allclose(y, np.linalg.det(x), rtol=2e-4)


def test_mvn():
    x = np.random.default_rng(2).normal(3, 2, (2, 3, 4, 5)).astype(
        np.float32)
    (y,) = run([O.make_node("MeanVarianceNormalization", ["x"], ["y"])],
               {"x": x}, ["y"])
    mean = x.mean(axis=(0, 2, 3), keepdims=True)
    std = x.std(axis=(0, 2, 3), keepdims=True)
    np.testing.assert_allclose(y, (x - mean) / (std + 1e-7), rtol=1e-3,
                               atol=1e-4)


@pytest.mark.parametrize("size", [3, 4])
def test_lrn_matches_reference_loop(size):
    x = np.random.default_rng(3).normal(0, 1, (2, 7, 4, 4)).astype(
        np.float32)
    alpha, beta, bias = 2e-4, 0.6, 1.5
    (y,) = run([O.make_node("LRN", ["x"], ["y"], size=size, alpha=alpha,
                            beta=beta, bias=bias)], {"x": x}, ["y"])
    C = x.shape[1]
    ref = np.empty_like(x)
    lo = (size - 1) // 2
    hi = size - 1 - lo
    for c in range(C):
        s = x[:, max(0, c - lo):min(C, c + hi + 1)] ** 2
        denom = (bias + (alpha / size) * s.sum(axis=1)) ** beta
        ref[:, c] = x[:, c] / denom
    np.testing.assert_allclose(y, ref, rtol=1e-5, atol=1e-6)


def test_lp_pool_and_global():
    x = np.random.default_rng(4).normal(0, 1, (1, 2, 6)).astype(np.float32)
    (y,) = run([O.make_node("LpPool", ["x"], ["y"], kernel_shape=[2],
                            strides=[2], p=2)], {"x": x}, ["y"])
    np.testing.assert_allclose(y, np.sqrt((x.reshape(1, 2, 3, 2) ** 2)
                                          .sum(-1)), rtol=1e-5)
    (g,) = run([O.make_node("GlobalLpPool", ["x"], ["g"], p=1)], {"x": x},
               ["g"])
    np.testing.assert_allclose(g, np.abs(x).sum(-1, keepdims=True),
                               rtol=1e-5)
    x2 = np.random.default_rng(5).normal(0, 1, (1, 2, 5, 5)).astype(
        np.float32)
    run([O.make_node("LpPool", ["x"], ["y"], kernel_shape=[3, 2],
                     strides=[2, 1], pads=[1, 0, 1, 1], p=3)],
        {"x": x2}, ["y"])
    run([O.make_node("GlobalLpPool", ["x"], ["g"], p=2)], {"x": x2}, ["g"])


def test_max_unpool():
    x = np.array([[[5.0, 8.0]]], np.float32)
    idx = np.array([[[1, 3]]], np.int64)
    (y,) = run([O.make_node("MaxUnpool", ["x", "i"], ["y"],
                            kernel_shape=[2], strides=[2])],
               {"x": x, "i": idx}, ["y"])
    np.testing.assert_allclose(y, [[[0, 5, 0, 8]]])
    (z,) = run([O.make_node("MaxUnpool", ["x", "i", "shape"], ["y"],
                            kernel_shape=[2], strides=[2])],
               {"x": x, "i": idx}, ["y"],
               {"shape": np.array([1, 1, 5], np.int64)})
    np.testing.assert_allclose(z, [[[0, 5, 0, 8, 0]]])


# -- integer quantization ---------------------------------------------------

def test_matmul_integer():
    rng = np.random.default_rng(5)
    a = rng.integers(0, 255, (3, 4)).astype(np.uint8)
    b = rng.integers(-127, 127, (4, 2)).astype(np.int8)
    (y,) = run([O.make_node("MatMulInteger", ["a", "b", "azp", "bzp"],
                            ["y"])], {"a": a, "b": b}, ["y"],
               {"azp": np.uint8(128).reshape(()),
                "bzp": np.int8(3).reshape(())})
    ref = (a.astype(np.int32) - 128) @ (b.astype(np.int32) - 3)
    np.testing.assert_array_equal(y, ref)


def test_matmul_integer_per_row_and_column_zero_points():
    rng = np.random.default_rng(15)
    a = rng.integers(0, 255, (2, 5, 64)).astype(np.uint8)
    b = rng.integers(-128, 127, (64, 3)).astype(np.int8)
    azp = rng.integers(0, 255, 5).astype(np.uint8)
    bzp = rng.integers(-5, 5, 3).astype(np.int8)
    (y,) = run([O.make_node("MatMulInteger", ["a", "b", "azp", "bzp"],
                            ["y"])], {"a": a, "b": b}, ["y"],
               {"azp": azp, "bzp": bzp})
    ref = ((a.astype(np.int64) - azp.astype(np.int64)[:, None])
           @ (b.astype(np.int64) - bzp.astype(np.int64)[None, :]))
    np.testing.assert_array_equal(y, ref)
    refused([O.make_node("MatMulInteger", ["a", "b", "azp"], ["y"])],
            {"a": a[0], "b": b}, ["y"],
            {"azp": np.zeros((1, 5), np.uint8)}, match="zero_point rank")


def test_conv_integer():
    rng = np.random.default_rng(6)
    x = rng.integers(0, 20, (1, 1, 5, 5)).astype(np.uint8)
    w = rng.integers(-5, 5, (1, 1, 3, 3)).astype(np.int8)
    (y,) = run([O.make_node("ConvInteger", ["x", "w", "xzp"], ["y"])],
               {"x": x}, ["y"], {"w": w, "xzp": np.uint8(2).reshape(())})
    import torch.nn.functional as F
    ref = F.conv2d(torch.tensor(x.astype(np.float32) - 2),
                   torch.tensor(w.astype(np.float32))).numpy()
    np.testing.assert_array_equal(y, ref.astype(np.int32))


def test_conv_integer_padded_strided_with_weight_zero_point():
    rng = np.random.default_rng(16)
    x = rng.integers(0, 255, (2, 3, 9, 8)).astype(np.uint8)
    w = rng.integers(-128, 127, (4, 3, 3, 3)).astype(np.int8)
    run([O.make_node("ConvInteger", ["x", "w", "xzp", "wzp"], ["y"],
                     pads=[1, 0, 1, 2], strides=[2, 1])],
        {"x": x}, ["y"], {"w": w, "xzp": np.uint8(131).reshape(()),
                          "wzp": np.int8(-3).reshape(())})
    refused([O.make_node("ConvInteger", ["x", "w", "", "wzp"], ["y"])],
            {"x": x}, ["y"], {"w": w, "wzp": np.zeros(4, np.int8)},
            match="per-channel")


@pytest.mark.parametrize("seed", [0, 1])
def test_dynamic_quantize_linear(seed):
    x = (np.array([0.0, 2.0, -3.0, 1.5], np.float32) if seed == 0 else
         np.random.default_rng(17).normal(0.5, 2, (6, 7)).astype(np.float32))
    y, scale, zp = run(
        [O.make_node("DynamicQuantizeLinear", ["x"], ["y", "s", "z"])],
        {"x": x}, ["y", "s", "z"])
    assert y.dtype == np.uint8 and zp.dtype == np.uint8
    if seed == 0:
        np.testing.assert_allclose(scale, 5.0 / 255.0, rtol=1e-6)
    deq = (y.astype(np.float32) - zp.astype(np.float32)) * scale
    np.testing.assert_allclose(deq, x, atol=float(scale) * 0.51)


# -- RNN --------------------------------------------------------------------

def _rnn_ref(X, W, R, B, h0, reverse=False):
    H = W.shape[0]
    h = h0.copy()
    ys = []
    ts = range(X.shape[0] - 1, -1, -1) if reverse else range(X.shape[0])
    for t in ts:
        h = np.tanh(X[t] @ W.T + B[:H] + h @ R.T + B[H:])
        ys.append(h)
    if reverse:
        ys = ys[::-1]
    return np.stack(ys), h


def test_rnn_forward():
    rng = np.random.default_rng(7)
    T, Bt, I, H = 5, 2, 3, 4
    X = rng.normal(0, 1, (T, Bt, I)).astype(np.float32)
    W = rng.normal(0, 0.5, (1, H, I)).astype(np.float32)
    R = rng.normal(0, 0.5, (1, H, H)).astype(np.float32)
    B = rng.normal(0, 0.1, (1, 2 * H)).astype(np.float32)
    Y, Yh = run([O.make_node("RNN", ["x", "w", "r", "b"], ["Y", "Yh"],
                             hidden_size=H)], {"x": X}, ["Y", "Yh"],
                {"w": W, "r": R, "b": B})
    ys, h = _rnn_ref(X, W[0], R[0], B[0], np.zeros((Bt, H), np.float32))
    np.testing.assert_allclose(Y[:, 0], ys, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(Yh[0], h, rtol=1e-5, atol=1e-6)


def test_rnn_bidirectional_with_h0():
    rng = np.random.default_rng(8)
    T, Bt, I, H = 4, 3, 2, 3
    X = rng.normal(0, 1, (T, Bt, I)).astype(np.float32)
    W = rng.normal(0, 0.5, (2, H, I)).astype(np.float32)
    R = rng.normal(0, 0.5, (2, H, H)).astype(np.float32)
    B = rng.normal(0, 0.1, (2, 2 * H)).astype(np.float32)
    h0 = rng.normal(0, 1, (2, Bt, H)).astype(np.float32)
    Y, Yh = run([O.make_node("RNN", ["x", "w", "r", "b", "", "h0"],
                             ["Y", "Yh"], hidden_size=H,
                             direction="bidirectional")],
                {"x": X}, ["Y", "Yh"], {"w": W, "r": R, "b": B, "h0": h0})
    fy, _ = _rnn_ref(X, W[0], R[0], B[0], h0[0])
    ry, rh = _rnn_ref(X, W[1], R[1], B[1], h0[1], reverse=True)
    np.testing.assert_allclose(Y[:, 0], fy, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(Y[:, 1], ry, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(Yh[1], rh, rtol=1e-5, atol=1e-6)


def test_gru_tanh_gates_rejected():
    rng = np.random.default_rng(20)
    H, I = 3, 2
    refused([O.make_node("GRU", ["x", "w", "r"], ["Y", "Yh"], hidden_size=H,
                         activations=["Tanh", "Tanh"])],
            {"x": rng.normal(0, 1, (4, 1, I)).astype(np.float32)}, ["Y"],
            {"w": rng.normal(0, 0.5, (1, 3 * H, I)).astype(np.float32),
             "r": rng.normal(0, 0.5, (1, 3 * H, H)).astype(np.float32)},
            match="activations")


def test_rnn_sigmoid_rejected():
    rng = np.random.default_rng(21)
    refused([O.make_node("RNN", ["x", "w", "r"], ["Y", "Yh"], hidden_size=3,
                         activations=["Sigmoid"])],
            {"x": rng.normal(0, 1, (4, 1, 2)).astype(np.float32)}, ["Y"],
            {"w": rng.normal(0, 0.5, (1, 3, 2)).astype(np.float32),
             "r": rng.normal(0, 0.5, (1, 3, 3)).astype(np.float32)},
            match="activations")


# -- losses -----------------------------------------------------------------

@pytest.mark.parametrize("reduction", ["mean", "sum", "none"])
def test_nll_loss_vs_torch(reduction):
    import torch.nn.functional as F
    rng = np.random.default_rng(9)
    logp = np.log(rng.dirichlet(np.ones(5), size=6)).astype(np.float32)
    tgt = rng.integers(0, 5, 6).astype(np.int64)
    w = rng.random(5).astype(np.float32)
    (y,) = run([O.make_node("NegativeLogLikelihoodLoss", ["x", "t", "w"],
                            ["y"], reduction=reduction)],
               {"x": logp, "t": tgt}, ["y"], {"w": w})
    ref = F.nll_loss(torch.tensor(logp), torch.tensor(tgt), torch.tensor(w),
                     reduction=reduction).numpy()
    np.testing.assert_allclose(y, ref, rtol=1e-5, atol=1e-6)


def test_nll_ignore_index():
    import torch.nn.functional as F
    rng = np.random.default_rng(10)
    logp = np.log(rng.dirichlet(np.ones(4), size=5)).astype(np.float32)
    tgt = np.array([0, 1, 2, 3, 2], np.int64)
    (y,) = run([O.make_node("NegativeLogLikelihoodLoss", ["x", "t"], ["y"],
                            reduction="mean", ignore_index=2)],
               {"x": logp, "t": tgt}, ["y"])
    ref = F.nll_loss(torch.tensor(logp), torch.tensor(tgt),
                     ignore_index=2).numpy()
    np.testing.assert_allclose(y, ref, rtol=1e-5)


def test_softmax_cross_entropy_vs_torch():
    import torch.nn.functional as F
    rng = np.random.default_rng(11)
    scores = rng.normal(0, 2, (7, 4)).astype(np.float32)
    tgt = rng.integers(0, 4, 7).astype(np.int64)
    y, logp = run([O.make_node("SoftmaxCrossEntropyLoss", ["x", "t"],
                               ["y", "lp"])], {"x": scores, "t": tgt},
                  ["y", "lp"])
    np.testing.assert_allclose(
        y, F.cross_entropy(torch.tensor(scores), torch.tensor(tgt)).numpy(),
        rtol=1e-5)
    np.testing.assert_allclose(
        logp, F.log_softmax(torch.tensor(scores), dim=1).numpy(), rtol=1e-5,
        atol=1e-6)
    # a spatial target, a weight and an ignored class, loss only
    s4 = rng.normal(0, 2, (3, 4, 5)).astype(np.float32)
    t4 = rng.integers(0, 4, (3, 5)).astype(np.int64)
    run([O.make_node("SoftmaxCrossEntropyLoss", ["x", "t", "w"],
                     ["y"], ignore_index=1, reduction="sum")],
        {"x": s4, "t": t4}, ["y"], {"w": rng.random(4).astype(np.float32)})


# -- random (the port's own generator: distributional) -----------------------

def _port_only(nodes, feeds, outs, inits=None):
    return _port(_model(nodes, feeds, outs, inits), feeds, outs)


def test_random_normal_stats_and_determinism():
    node = O.make_node("RandomNormal", [], ["y"], shape=[2000], mean=1.0,
                       scale=2.0, seed=7.0)
    feeds = {"dummy": np.zeros(1, np.float32)}
    (a,) = _port_only([node], feeds, ["y"])
    (b,) = _port_only([node], feeds, ["y"])
    np.testing.assert_array_equal(a, b)            # fixed seed, fixed draw
    assert a.shape == (2000,) and a.dtype == np.float32
    # 5 sigma of the sample mean and standard deviation at n = 2000
    assert abs(a.mean() - 1.0) < 5 * 2.0 / np.sqrt(2000)
    assert abs(a.std() - 2.0) < 5 * 2.0 / np.sqrt(2 * 2000)
    # the JAX draw holds the same moments (its test's bound)
    (j,) = _jax(_model([node], feeds, ["y"]), feeds, ["y"])
    assert abs(j.mean() - 1.0) < 0.2 and abs(j.std() - 2.0) < 0.2


def test_random_uniform_like_range_and_moments():
    x = np.zeros((4000,), np.float32)
    (y,) = _port_only([O.make_node("RandomUniformLike", ["x"], ["y"],
                                   low=2.0, high=3.0)], {"x": x}, ["y"])
    assert y.shape == x.shape and y.dtype == np.float32
    assert (y >= 2.0).all() and (y < 3.0).all()
    assert abs(y.mean() - 2.5) < 5 * np.sqrt(1 / 12 / 4000)
    # ten equal bins: chi-square with 9 degrees of freedom under 27.88
    # (p = 0.001)
    counts = np.histogram(y, bins=10, range=(2.0, 3.0))[0]
    assert ((counts - 400.0) ** 2 / 400.0).sum() < 27.88


def test_random_normal_like_and_uniform_dtypes_and_streams():
    x = np.zeros((3, 500), np.float32)
    (n,) = _port_only([O.make_node("RandomNormalLike", ["x"], ["y"],
                                   seed=3.0)], {"x": x}, ["y"])
    assert n.shape == (3, 500) and abs(n.mean()) < 5 / np.sqrt(1500)
    nodes = [O.make_node("RandomUniform", [], ["a"], shape=[1000], seed=1.0),
             O.make_node("RandomUniform", [], ["b"], shape=[1000], seed=1.0),
             O.make_node("RandomUniform", [], ["c"], shape=[1000],
                         seed=1.0, dtype=11)]
    a, b, c = _port_only(nodes, {"x": x}, ["a", "b", "c"])
    assert not np.array_equal(a, b)       # one stream per output name
    # dtype DOUBLE is float32 on the device (64-bit types off, as in the
    # reference)
    assert c.dtype == np.float32
    assert ((a >= 0) & (a < 1)).all() and abs(a.mean() - 0.5) < 0.05


# -- audio ------------------------------------------------------------------

@pytest.mark.parametrize("op,coeffs", [
    ("HannWindow", [0.5, 0.5]), ("HammingWindow", [25 / 46, 21 / 46]),
    ("BlackmanWindow", [0.42, 0.5, 0.08])])
@pytest.mark.parametrize("periodic", [1, 0])
def test_windows_formulas(op, coeffs, periodic):
    (w,) = run([O.make_node(op, ["n"], ["w"], periodic=periodic)],
               {"x": np.zeros(1, np.float32)}, ["w"],
               {"n": np.array(16, np.int64)})
    n = np.arange(16)
    N = 16 if periodic else 15
    ref = sum(((-1.0) ** k) * a * np.cos(2 * np.pi * k * n / N)
              for k, a in enumerate(coeffs))
    np.testing.assert_allclose(w, ref, rtol=1e-5, atol=1e-6)


def test_dft_matches_numpy():
    x = np.random.default_rng(12).normal(0, 1, (2, 16, 1)).astype(np.float32)
    (y,) = run([O.make_node("DFT", ["x"], ["y"])], {"x": x}, ["y"])
    ref = np.fft.fft(x[..., 0], axis=1)
    np.testing.assert_allclose(y[..., 0], ref.real, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(y[..., 1], ref.imag, rtol=1e-4, atol=1e-4)
    (h,) = run([O.make_node("DFT", ["x"], ["y"], onesided=1)], {"x": x},
               ["y"])
    np.testing.assert_allclose(h[..., 0], np.fft.rfft(x[..., 0], axis=1)
                               .real, rtol=1e-4, atol=1e-4)
    (inv,) = run([O.make_node("DFT", ["y"], ["z"], inverse=1)],
                 {"y": np.stack([ref.real, ref.imag], -1).astype(
                     np.float32)}, ["z"])
    np.testing.assert_allclose(inv[..., 0], x[..., 0], atol=1e-4)
    # a negative axis counts on the FULL input rank
    (yn,) = run([O.make_node("DFT", ["x"], ["y"], axis=-2)], {"x": x},
                ["y"])
    np.testing.assert_allclose(yn[..., 0], ref.real, rtol=1e-4, atol=1e-4)


def test_dft_length_complex_onesided_and_refusal():
    rng = np.random.default_rng(22)
    z = rng.normal(0, 1, (2, 12, 2)).astype(np.float32)
    run([O.make_node("DFT", ["x", "n"], ["y"])], {"x": z}, ["y"],
        {"n": np.array(16, np.int64)})
    run([O.make_node("DFT", ["x", "", "ax"], ["y"], onesided=1)], {"x": z},
        ["y"], {"ax": np.array(1, np.int64)})
    refused([O.make_node("DFT", ["x"], ["y"], onesided=1, inverse=1)],
            {"x": z}, ["y"], match="inverse")
    refused([O.make_node("DFT", ["x"], ["y"])],
            {"x": rng.normal(0, 1, (2, 4, 3)).astype(np.float32)}, ["y"],
            match="last dim")


def test_stft_matches_manual_framing():
    x = np.random.default_rng(13).normal(0, 1, (1, 32, 1)).astype(np.float32)
    win = np.hanning(8).astype(np.float32)
    (y,) = run([O.make_node("STFT", ["x", "step", "w"], ["y"], onesided=1)],
               {"x": x}, ["y"], {"step": np.array(4, np.int64), "w": win})
    n_frames = 1 + (32 - 8) // 4
    assert y.shape == (1, n_frames, 8 // 2 + 1, 2)
    for f in range(n_frames):
        ref = np.fft.rfft(x[0, f * 4:f * 4 + 8, 0] * win)
        np.testing.assert_allclose(y[0, f, :, 0], ref.real, rtol=1e-4,
                                   atol=1e-4)
        np.testing.assert_allclose(y[0, f, :, 1], ref.imag, rtol=1e-4,
                                   atol=1e-4)


def test_stft_two_sided_frame_length_and_refusals():
    rng = np.random.default_rng(23)
    z = rng.normal(0, 1, (2, 30, 2)).astype(np.float32)
    run([O.make_node("STFT", ["x", "step", "", "fl"], ["y"], onesided=0)],
        {"x": z}, ["y"], {"step": np.array(5, np.int64),
                          "fl": np.array(10, np.int64)})
    refused([O.make_node("STFT", ["x", "step", "", "fl"], ["y"])],
            {"x": z}, ["y"], {"step": np.array(5, np.int64),
                              "fl": np.array(10, np.int64)},
            match="onesided")
    refused([O.make_node("STFT", ["x", "step"], ["y"])], {"x": z[..., :1]},
            ["y"], {"step": np.array(5, np.int64)}, match="frame_length")


def test_mel_weight_matrix():
    (w,) = run([O.make_node("MelWeightMatrix",
                            ["nm", "dft", "sr", "lo", "hi"], ["w"])],
               {"x": np.zeros(1, np.float32)}, ["w"],
               {"nm": np.array(8, np.int64), "dft": np.array(64, np.int64),
                "sr": np.array(8000, np.int64),
                "lo": np.array(0.0, np.float32),
                "hi": np.array(4000.0, np.float32)})
    assert w.shape == (33, 8)
    assert (w >= 0).all() and w.max() <= 1.0 + 1e-6
    assert (w.sum(axis=0) > 0).all()

    def mel(f):
        return 2595 * np.log10(1 + f / 700)

    edges = np.linspace(mel(0), mel(4000), 10)
    spec_mel = mel(np.arange(33) * 8000 / 64)
    j = 3
    up = (spec_mel - edges[j]) / (edges[j + 1] - edges[j])
    down = (edges[j + 2] - spec_mel) / (edges[j + 2] - edges[j + 1])
    np.testing.assert_allclose(w[:, j], np.maximum(0, np.minimum(up, down)),
                               rtol=1e-4, atol=1e-5)


def test_fed_size_is_refused():
    """A window size fed to the graph is a device tensor in the port: it
    is refused, not read back (the JAX converter reads it eagerly)."""
    data = _model([O.make_node("HannWindow", ["n"], ["w"])],
                  {"n": np.array(16, np.int64)}, ["w"])
    with pytest.raises(UnsupportedOp, match="window size"):
        _port(data, {"n": np.array(16, np.int64)}, ["w"])


def test_log_mel_pipeline():
    """Whisper-style preprocessing as ONE graph: STFT → |.|² → mel
    projection → log."""
    rng = np.random.default_rng(14)
    sr, n = 8000, 512
    t = np.arange(n) / sr
    sig = (np.sin(2 * np.pi * 440 * t) + 0.5 * rng.normal(0, 0.1, n)) \
        .astype(np.float32)
    nodes = [
        O.make_node("STFT", ["x", "step", "w"], ["spec"], onesided=1),
        O.make_node("ReduceSumSquare", ["spec", "ax"], ["power"],
                    keepdims=0),
        O.make_node("MelWeightMatrix", ["nmel", "dft", "sr", "lo", "hi"],
                    ["mel_w"]),
        O.make_node("MatMul", ["power", "mel_w"], ["mel"]),
        O.make_node("Add", ["mel", "eps"], ["mel_e"]),
        O.make_node("Log", ["mel_e"], ["logmel"])]
    (lm,) = run(nodes, {"x": sig.reshape(1, n, 1)}, ["logmel"], {
        "step": np.array(32, np.int64),
        "w": np.hanning(64).astype(np.float32),
        "ax": np.array([-1], np.int64),
        "nmel": np.array(10, np.int64), "dft": np.array(64, np.int64),
        "sr": np.array(sr, np.int64), "lo": np.array(20.0, np.float32),
        "hi": np.array(4000.0, np.float32),
        "eps": np.array(1e-6, np.float32)})
    assert lm.shape == (1, 1 + (n - 64) // 32, 10)
    assert np.isfinite(lm).all()
    assert lm[0].mean(axis=0).argmax() in range(1, 5)


# -- FusedConv and RelativePositionBias (ported earlier; the same file's
# cases) ----------------------------------------------------------------------

def _x_w(seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(0, 1, (1, 3, 8, 8)).astype(np.float32),
            rng.normal(0, 0.3, (4, 3, 3, 3)).astype(np.float32),
            rng.normal(0, 0.1, 4).astype(np.float32))


def test_fused_conv_matches_conv_plus_activation():
    x, w, b = _x_w()
    (fused,) = run([O.make_node("FusedConv", ["x", "w", "b"], ["y"],
                                domain="com.microsoft", activation="Relu")],
                   {"x": x}, ["y"], {"w": w, "b": b})
    (plain,) = run([O.make_node("Conv", ["x", "w", "b"], ["c"]),
                    O.make_node("Relu", ["c"], ["y"])], {"x": x}, ["y"],
                   {"w": w, "b": b})
    np.testing.assert_allclose(fused, plain, rtol=1e-6)


def test_fused_conv_residual_and_param_activations():
    x, w, b = _x_w(1)
    z = np.random.default_rng(2).normal(0, 1, (1, 4, 6, 6)).astype(
        np.float32)
    (y,) = run([O.make_node("FusedConv", ["x", "w", "b", "z"], ["y"],
                            domain="com.microsoft", activation="LeakyRelu",
                            activation_params=[0.2])],
               {"x": x}, ["y"], {"w": w, "b": b, "z": z})
    (c,) = run([O.make_node("Conv", ["x", "w", "b"], ["c"])], {"x": x},
               ["c"], {"w": w, "b": b})
    want = c + z
    np.testing.assert_allclose(y, np.where(want < 0, 0.2 * want, want),
                               rtol=1e-5)


def test_fused_conv_unknown_activation_rejected():
    x, w, b = _x_w(3)
    data = _model([O.make_node("FusedConv", ["x", "w", "b"], ["y"],
                               domain="com.microsoft", activation="Swoosh")],
                  {"x": x}, ["y"], {"w": w, "b": b})
    with pytest.raises(Exception, match="activation"):
        _jax(data, {"x": x}, ["y"])
    with pytest.raises(Exception, match="activation"):
        _port(data, {"x": x}, ["y"])


@pytest.mark.parametrize("bidirectional", [True, False])
def test_relative_position_bias_matches_t5_bucketing(bidirectional):
    from transformers.models.t5.modeling_t5 import T5Attention
    num_buckets, heads, max_dist, q_len, k_len = 32, 4, 64, 7, 11
    table = np.random.default_rng(0).normal(0, 1, (num_buckets, heads)) \
        .astype(np.float32)
    (got,) = run([O.make_node("RelativePositionBias", ["table", "ql", "kl"],
                              ["bias"], domain="com.microsoft",
                              max_distance=max_dist,
                              is_bidirectional=int(bidirectional))],
                 {"table": table}, ["bias"],
                 {"ql": np.array(q_len, np.int64),
                  "kl": np.array(k_len, np.int64)})
    buckets = T5Attention._relative_position_bucket(
        torch.arange(k_len)[None, :] - torch.arange(q_len)[:, None],
        bidirectional=bidirectional, num_buckets=num_buckets,
        max_distance=max_dist)
    want = table[buckets.numpy()].transpose(2, 0, 1)[None]
    np.testing.assert_allclose(got, want, rtol=1e-6)
    assert got.shape == (1, heads, q_len, k_len)


def test_every_extra_op_has_a_case_here():
    """The 26 handlers of JAX ``extra_ops.py`` beyond ``ReduceLogSum``
    (ported with ``convert.py``'s) all run in this file."""
    import sys
    src = open(sys.modules[__name__].__file__).read()
    ops = ["ConvInteger", "MatMulInteger", "DynamicQuantizeLinear", "RNN",
           "LRN", "LpPool", "GlobalLpPool", "MaxUnpool",
           "MeanVarianceNormalization", "BitwiseAnd", "BitwiseOr",
           "BitwiseXor", "BitwiseNot", "DFT", "STFT", "HannWindow",
           "HammingWindow", "BlackmanWindow", "MelWeightMatrix", "Det",
           "RandomNormal", "RandomNormalLike", "RandomUniform",
           "RandomUniformLike", "SoftmaxCrossEntropyLoss",
           "NegativeLogLikelihoodLoss"]
    assert len(ops) == 26
    assert all(f'"{op}"' in src for op in ops)
    from mmlspark_tpu_torch.onnx.convert import OP_HANDLERS
    assert set(ops) <= set(OP_HANDLERS)


# -- the card's cases (chip_smoke phase 20g) through both converters ---------

def _card_cases():
    import sys
    from pathlib import Path
    root = str(Path(__file__).resolve().parents[1])
    if root not in sys.path:
        sys.path.insert(0, root)
    from chip_smoke import extra_op_cases
    return extra_op_cases()


CARD_CASES = _card_cases()


@pytest.mark.parametrize("name", sorted(CARD_CASES))
def test_chip_smoke_cases_match_the_reference(name):
    data, feeds, _ = CARD_CASES[name]
    outs = O.convert_model(data).output_names
    got, want = _port(data, feeds, outs), _jax(data, feeds, outs)
    for o, g, w in zip(outs, got, want):
        _hold(g, w, f"{name} {o}")

"""Long-tail ONNX standard ops: audio/DSP, integer-quantized, recurrent,
loss, pooling, bitwise and random families (counterpart of
``mmlspark_tpu/onnx/extra_ops.py``).

Registered into :mod:`convert`'s ``OP_HANDLERS`` on import, like
``ml_ops``. Each handler computes what the JAX handler computes, with its
refusals; size-like inputs (window sizes, DFT lengths, frame steps, the
mel matrix's arguments, ``MaxUnpool``'s output shape) must be host values,
as everywhere in the converter.

* The integer ops (``MatMulInteger``, ``ConvInteger``) sum in float64 on
  the tensors' device, exact for 8-bit codes, and round to int32: PyTorch
  has no integer matmul or convolution on CUDA (``QLinearConv``'s rule).
  ``DynamicQuantizeLinear`` runs the reference's float32 formula, rounding
  half to even.
* ``DFT`` / ``STFT`` keep the reference's trailing axis of 2 (real,
  imaginary), through ``torch.fft`` (cuFFT on the card).
* The ``Random*`` ops draw from a ``torch.Generator`` on the device,
  seeded from the node's ``seed`` attribute and its first output's name
  (the reference's stance: a fixed derivation, so runs repeat); the values
  differ from the reference's ``jax.random`` draws, so they are held by
  distributional checks only.
"""

from __future__ import annotations

import zlib

import numpy as np
import torch
import torch.nn.functional as F

from .convert import (OP_HANDLERS, UnsupportedOp, _as_tensor, _concrete,
                      _conv_raw, _initial, _opt, _pad_spatial,
                      _pool_geometry, _promoted, _rnn_common,
                      _run_directions, _torch_dtype, _window_sum,
                      register_op)
from .proto import ONNX_TO_NUMPY


def _host_int(v, what) -> int:
    return int(np.asarray(_concrete(v, what)).ravel()[0])


# -- bitwise (opset 18) ------------------------------------------------------

for _name, _fn in [("BitwiseAnd", torch.bitwise_and),
                   ("BitwiseOr", torch.bitwise_or),
                   ("BitwiseXor", torch.bitwise_xor)]:
    OP_HANDLERS[_name] = (lambda f: lambda n, i, c: f(*_promoted(c, i[0],
                                                                 i[1])))(_fn)
OP_HANDLERS["BitwiseNot"] = lambda n, i, c: torch.bitwise_not(
    _as_tensor(i[0], c))


# -- normalization / pooling -------------------------------------------------

@register_op("LRN")
def _lrn(node, inputs, ctx):
    """Local response normalization: the windowed square-sum over the
    channel axis, (size - 1) // 2 channels below and the rest above."""
    x = _as_tensor(inputs[0], ctx)
    size = int(node.attr("size"))
    alpha = node.attr("alpha", 1e-4)
    beta = node.attr("beta", 0.75)
    bias = node.attr("bias", 1.0)
    lo = (size - 1) // 2
    hi = size - 1 - lo
    C = x.shape[1]
    padded = F.pad(x * x, (0, 0) * (x.ndim - 2) + (lo, hi))
    win = padded[:, 0:C]
    for j in range(1, size):
        win = win + padded[:, j:j + C]
    return x / torch.pow(bias + (alpha / size) * win, beta)


@register_op("MeanVarianceNormalization")
def _mvn(node, inputs, ctx):
    x = _as_tensor(inputs[0], ctx)
    axes = tuple(node.attr("axes", [0, 2, 3]))
    mean = x.mean(dim=axes, keepdim=True)
    var = ((x - mean) ** 2).mean(dim=axes, keepdim=True)
    return (x - mean) / torch.sqrt(var + 1e-9)


def _lp_reduce(x, p, dims):
    if p == 2:
        return torch.sqrt(torch.sum(x * x, dim=dims, keepdim=True))
    return torch.pow(torch.sum(torch.pow(torch.abs(x), p), dim=dims,
                               keepdim=True), 1.0 / p)


@register_op("GlobalLpPool")
def _global_lp_pool(node, inputs, ctx):
    x = _as_tensor(inputs[0], ctx)
    return _lp_reduce(x, int(node.attr("p", 2)), tuple(range(2, x.ndim)))


@register_op("LpPool")
def _lp_pool(node, inputs, ctx):
    """(Σ |x|^p over each window)^(1/p), the windows of the pools'
    geometry (zero padding)."""
    p = int(node.attr("p", 2))
    x = _as_tensor(inputs[0], ctx)
    k, strides, dilations, pads = _pool_geometry(node, x)
    summed = _window_sum(_pad_spatial(torch.abs(x) ** p, pads, 0.0), k,
                         strides, dilations)
    return torch.pow(summed, 1.0 / p)


@register_op("MaxUnpool")
def _max_unpool(node, inputs, ctx):
    """Scatter pooled values back to the indices MaxPool recorded (global
    row-major flat indices, the ORT layout)."""
    x = _as_tensor(inputs[0], ctx)
    idx = _as_tensor(inputs[1], ctx).long()
    if _opt(inputs, 2) is not None:
        out_shape = tuple(int(v) for v in
                          np.ravel(_concrete(inputs[2],
                                             "MaxUnpool output_shape")))
    else:
        k = node.attr("kernel_shape")
        strides = node.attr("strides", [1] * len(k))
        pads = node.attr("pads", [0] * 2 * len(k))
        spatial = tuple(
            (x.shape[2 + i] - 1) * strides[i] + k[i]
            - pads[i] - pads[len(k) + i] for i in range(len(k)))
        out_shape = tuple(x.shape[:2]) + spatial
    flat = torch.zeros(int(np.prod(out_shape)), dtype=x.dtype,
                       device=x.device)
    flat[idx.reshape(-1)] = x.reshape(-1)
    return flat.reshape(out_shape)


# -- integer-quantized (the pre-QLinear wire ops) ----------------------------

def _sub_zp(t, zp, what, ctx) -> torch.Tensor:
    """``t - zp`` in float64 (exact for 8-bit codes); a 1-D zero point is
    per row of A (second-to-last axis) or per column of B (last axis)."""
    t = _as_tensor(t, ctx).to(torch.float64)
    if zp is None:
        return t
    z = _as_tensor(zp, ctx).to(torch.float64)
    if z.ndim == 0 or z.numel() == 1:
        return t - z.reshape(())
    if z.ndim == 1:
        shape = ([1] * (t.ndim - 2) + [-1, 1]) if what == "a" \
            else ([1] * (t.ndim - 2) + [1, -1])
        return t - z.reshape(shape)
    raise UnsupportedOp(f"MatMulInteger {what}_zero_point rank {z.ndim}")


@register_op("MatMulInteger")
def _matmul_integer(node, inputs, ctx):
    a = _sub_zp(inputs[0], _opt(inputs, 2), "a", ctx)
    b = _sub_zp(inputs[1], _opt(inputs, 3), "b", ctx)
    return torch.round(torch.matmul(a, b)).to(torch.int32)


@register_op("ConvInteger")
def _conv_integer(node, inputs, ctx):
    x = _as_tensor(inputs[0], ctx).to(torch.float64)
    w = _as_tensor(inputs[1], ctx).to(torch.float64)
    if _opt(inputs, 2) is not None:
        x = x - _as_tensor(inputs[2], ctx).to(torch.float64).reshape(())
    if _opt(inputs, 3) is not None:
        wz = np.asarray(_concrete(inputs[3], "ConvInteger w_zero_point"))
        if wz.size != 1:
            raise UnsupportedOp("ConvInteger per-channel w_zero_point")
        w = w - float(wz.ravel()[0])
    return torch.round(_conv_raw(node, x, w)).to(torch.int32)


@register_op("DynamicQuantizeLinear")
def _dynamic_quantize_linear(node, inputs, ctx):
    x = _as_tensor(inputs[0], ctx).to(torch.float32)
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    x_min = torch.minimum(x.min(), zero)
    x_max = torch.maximum(x.max(), zero)
    scale = (x_max - x_min) / 255.0
    scale = torch.where(scale == 0, torch.ones_like(scale), scale)
    zp = torch.clamp(torch.round(0.0 - x_min / scale), 0, 255)
    y = torch.clamp(torch.round(x / scale) + zp, 0, 255).to(torch.uint8)
    return y, scale, zp.to(torch.uint8)


# -- vanilla RNN (completes the LSTM/GRU trio) -------------------------------

@register_op("RNN")
def _rnn(node, inputs, ctx):
    """ONNX vanilla RNN (the default activation Tanh only)."""
    X, W, R, B, direction = _rnn_common(
        node, inputs, ctx, allowed_acts=(["tanh"], ["tanh"] * 2))
    H = int(node.attr("hidden_size"))
    h0 = _initial(inputs, 5, ctx, (W.shape[0], X.shape[1], H), X)

    def cell(carry, x, W, R, B):
        (h,) = carry
        wb = B[:H] if B is not None else 0.0
        rb = B[H:] if B is not None else 0.0
        h_new = torch.tanh(x @ W.T + wb + h @ R.T + rb)
        return (h_new,), h_new

    res = _run_directions(X, W, R, B, h0, (), direction, cell)
    Y = torch.stack([ys for ys, _ in res], dim=1)
    Y_h = torch.stack([carry[0] for _, carry in res], dim=0)
    return Y, Y_h


# -- losses (training-capable graphs) ----------------------------------------

def _nll_core(log_prob, target, weight, ignore_index, reduction, ctx):
    """log_prob (N, C, d...), target (N, d...) int."""
    C = log_prob.shape[1]
    tgt = _as_tensor(target, ctx).long()
    valid = torch.ones(tgt.shape, dtype=torch.float32, device=tgt.device) \
        if ignore_index is None else (tgt != ignore_index).to(torch.float32)
    tgt_safe = torch.clamp(tgt, 0, C - 1)
    gathered = torch.gather(log_prob, 1, tgt_safe[:, None])[:, 0]
    w = (_as_tensor(weight, ctx)[tgt_safe].to(torch.float32)
         if weight is not None else torch.ones(tgt.shape, dtype=torch.float32,
                                               device=tgt.device))
    w = w * valid
    loss = -gathered * w
    if reduction == "none":
        return loss
    if reduction == "sum":
        return torch.sum(loss)
    return torch.sum(loss) / torch.clamp(torch.sum(w), min=1e-12)   # mean


@register_op("NegativeLogLikelihoodLoss")
def _nll_loss(node, inputs, ctx):
    return _nll_core(_as_tensor(inputs[0], ctx), inputs[1], _opt(inputs, 2),
                     node.attr("ignore_index"),
                     node.attr("reduction", "mean"), ctx)


@register_op("SoftmaxCrossEntropyLoss")
def _sce_loss(node, inputs, ctx):
    log_prob = torch.log_softmax(_as_tensor(inputs[0], ctx), dim=1)
    loss = _nll_core(log_prob, inputs[1], _opt(inputs, 2),
                     node.attr("ignore_index"),
                     node.attr("reduction", "mean"), ctx)
    if len(node.output) > 1:
        return loss, log_prob
    return loss


# -- misc --------------------------------------------------------------------

@register_op("Det")
def _det(node, inputs, ctx):
    return torch.linalg.det(_as_tensor(inputs[0], ctx))


def _random(node, shape, default, normal, device):
    """``default``: the output dtype without a ``dtype`` attribute."""
    dt = node.attr("dtype")
    dt = default if dt is None else _torch_dtype(ONNX_TO_NUMPY[dt])
    seed = node.attr("seed")
    # a fixed derivation per node: the seed attribute (0 without one) and a
    # stable hash of the node's first output (hash() is salted per process)
    key = ((int(seed) if seed is not None else 0) * 0x9E3779B1
           + zlib.crc32(node.output[0].encode())) % (1 << 63)
    g = torch.Generator(device=device)
    g.manual_seed(key)
    if normal:
        mean = node.attr("mean", 0.0)
        scale = node.attr("scale", 1.0)
        z = torch.randn(shape, generator=g, device=device,
                        dtype=torch.float32)
        return (mean + scale * z).to(dt)
    low = float(node.attr("low", 0.0))
    high = float(node.attr("high", 1.0))
    u = torch.rand(shape, generator=g, device=device, dtype=torch.float32)
    # keep the half-open [low, high) that rounding at the top could close
    top = float(np.nextafter(np.float32(high), np.float32(low)))
    return torch.clamp(u * (high - low) + low, max=top).to(dt)


@register_op("RandomNormal")
def _random_normal(node, inputs, ctx):
    return _random(node, tuple(node.attr("shape")), torch.float32, True,
                   ctx.device)


@register_op("RandomUniform")
def _random_uniform(node, inputs, ctx):
    return _random(node, tuple(node.attr("shape")), torch.float32, False,
                   ctx.device)


@register_op("RandomNormalLike")
def _random_normal_like(node, inputs, ctx):
    x = _as_tensor(inputs[0], ctx)
    return _random(node, tuple(x.shape), x.dtype, True, ctx.device)


@register_op("RandomUniformLike")
def _random_uniform_like(node, inputs, ctx):
    x = _as_tensor(inputs[0], ctx)
    return _random(node, tuple(x.shape), x.dtype, False, ctx.device)


# -- audio / DSP family (opset 17) -------------------------------------------

def _cosine_window(node, inputs, ctx, coeffs):
    size = _host_int(inputs[0], "window size")
    periodic = int(node.attr("periodic", 1))
    dt = _torch_dtype(ONNX_TO_NUMPY.get(node.attr("output_datatype"),
                                        np.float32))
    N = size if periodic else size - 1
    n = torch.arange(size, dtype=torch.float32, device=ctx.device)
    w = torch.zeros(size, dtype=torch.float32, device=ctx.device)
    for k, a in enumerate(coeffs):
        w = w + ((-1.0) ** k) * a * torch.cos(2.0 * np.pi * k * n
                                              / max(N, 1))
    return w.to(dt)


@register_op("HannWindow")
def _hann_window(node, inputs, ctx):
    return _cosine_window(node, inputs, ctx, [0.5, 0.5])


@register_op("HammingWindow")
def _hamming_window(node, inputs, ctx):
    return _cosine_window(node, inputs, ctx, [25.0 / 46.0, 21.0 / 46.0])


@register_op("BlackmanWindow")
def _blackman_window(node, inputs, ctx):
    return _cosine_window(node, inputs, ctx, [0.42, 0.5, 0.08])


def _as_complex(x, what):
    """[..., 1] real or [..., 2] interleaved → complex64."""
    if x.shape[-1] == 1:
        return x[..., 0].to(torch.complex64)
    if x.shape[-1] == 2:
        return torch.complex(x[..., 0].float(), x[..., 1].float())
    raise UnsupportedOp(f"{what}: last dim must be 1 (real) or 2 (complex), "
                        f"got {x.shape[-1]}")


def _stack_complex(z):
    return torch.stack([z.real, z.imag], dim=-1).to(torch.float32)


@register_op("DFT")
def _dft(node, inputs, ctx):
    inverse = int(node.attr("inverse", 0))
    onesided = int(node.attr("onesided", 0))
    if inverse and onesided:
        raise UnsupportedOp("DFT inverse+onesided")
    # axis: opset-20 input 2, else the attribute (default 1, the signal dim
    # of [batch, n, 1|2])
    if _opt(inputs, 2) is not None:
        axis = _host_int(inputs[2], "DFT axis")
    else:
        axis = int(node.attr("axis", 1))
    sig = _as_tensor(inputs[0], ctx)
    z = _as_complex(sig, "DFT")
    if axis < 0:
        # the spec counts axes on the FULL input rank (the trailing
        # real/imaginary dim included)
        axis += z.ndim + 1
    n = None
    if _opt(inputs, 1) is not None:
        n = _host_int(inputs[1], "DFT dft_length")
    if inverse:
        out = torch.fft.ifft(z, n=n, dim=axis)
    elif onesided:
        if sig.shape[-1] == 1:
            out = torch.fft.rfft(sig[..., 0].to(torch.float32), n=n,
                                 dim=axis)
        else:
            full = torch.fft.fft(z, n=n, dim=axis)
            keep = (n if n is not None else z.shape[axis]) // 2 + 1
            out = full.narrow(axis, 0, keep)
    else:
        out = torch.fft.fft(z, n=n, dim=axis)
    return _stack_complex(out)


@register_op("STFT")
def _stft(node, inputs, ctx):
    """[batch, n, 1|2] signal → [batch, frames, dft_bins, 2]."""
    onesided = int(node.attr("onesided", 1))
    signal = _as_tensor(inputs[0], ctx)
    step = _host_int(inputs[1], "STFT frame_step")
    window = (_as_tensor(inputs[2], ctx).to(torch.float32)
              if _opt(inputs, 2) is not None else None)
    if _opt(inputs, 3) is not None:
        frame_length = _host_int(inputs[3], "STFT frame_length")
    elif window is not None:
        frame_length = int(window.shape[0])
    else:
        raise UnsupportedOp("STFT needs window or frame_length")
    if signal.shape[-1] == 2 and onesided:
        raise UnsupportedOp("STFT onesided over a complex signal")
    z = _as_complex(signal, "STFT")               # (B, N)
    N = z.shape[1]
    n_frames = 1 + (N - frame_length) // step
    starts = torch.arange(n_frames, device=z.device) * step
    gather = starts[:, None] + torch.arange(frame_length, device=z.device)
    frames = z[:, gather]                         # (B, frames, frame_len)
    if window is not None:
        frames = frames * window[None, None, :]
    if onesided:
        out = torch.fft.rfft(frames.real.to(torch.float32), dim=-1)
    else:
        out = torch.fft.fft(frames, dim=-1)
    return _stack_complex(out)


@register_op("MelWeightMatrix")
def _mel_weight_matrix(node, inputs, ctx):
    """[dft//2+1, mel_bins] triangular filterbank (HTK mel scale), the
    ``tf.signal.linear_to_mel_weight_matrix`` layout the ONNX spec adopts;
    built on the host in float64, as the reference builds it."""
    nm = _host_int(inputs[0], "num_mel_bins")
    dft = _host_int(inputs[1], "dft_length")
    sr = float(np.asarray(_concrete(inputs[2], "sample_rate")).ravel()[0])
    lo = float(np.asarray(_concrete(inputs[3],
                                    "lower_edge_hertz")).ravel()[0])
    hi = float(np.asarray(_concrete(inputs[4],
                                    "upper_edge_hertz")).ravel()[0])
    dt = ONNX_TO_NUMPY.get(node.attr("output_datatype"), np.float32)
    n_spec = dft // 2 + 1

    def hz_to_mel(f):
        return 2595.0 * np.log10(1.0 + np.asarray(f, np.float64) / 700.0)

    mel_edges = np.linspace(hz_to_mel(lo), hz_to_mel(hi), nm + 2)
    spec_mel = hz_to_mel(np.arange(n_spec) * sr / dft)
    lower = mel_edges[:-2][None, :]               # (1, nm)
    center = mel_edges[1:-1][None, :]
    upper = mel_edges[2:][None, :]
    s = spec_mel[:, None]                         # (n_spec, 1)
    up = (s - lower) / np.maximum(center - lower, 1e-12)
    down = (upper - s) / np.maximum(upper - center, 1e-12)
    w = np.maximum(0.0, np.minimum(up, down))
    return _as_tensor(w.astype(dt), ctx)

"""ResNet family — native PyTorch forward + ONNX exporter (counterpart of
``mmlspark_tpu/models/zoo/resnet.py``).

Serves two roles, as in the JAX package:

* a forward pass with NHWC semantics (``resnet_apply``), run on
  ``F.conv2d`` over ``channels_last`` tensors, which is cuDNN's NHWC
  layout on the card; and
* a generator of ResNet ONNX graphs (NCHW, the ONNX convention) for the
  port's ONNX path, at the scale of ResNet-50.

``init_resnet`` draws the same numpy stream as the JAX package's, so both
packages build bitwise-equal weights from one seed, and
``export_resnet_onnx`` writes bitwise-equal initializers.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ["ResNetConfig", "RESNET50", "RESNET18_CFG", "init_resnet",
           "resnet_apply", "export_resnet_onnx"]


class ResNetConfig:
    def __init__(self, stage_sizes: List[int], num_classes: int = 1000,
                 width: int = 64, dtype=torch.bfloat16):
        self.stage_sizes = stage_sizes
        self.num_classes = num_classes
        self.width = width
        self.dtype = dtype


RESNET50 = ResNetConfig([3, 4, 6, 3])
RESNET18_CFG = ResNetConfig([2, 2, 2, 2])

# -- native implementation (NHWC semantics) ----------------------------------

def _conv_init(rng, kh, kw, cin, cout):
    fan_in = kh * kw * cin
    return (rng.normal(0, np.sqrt(2.0 / fan_in), (kh, kw, cin, cout))
            .astype(np.float32))


def init_resnet(cfg: ResNetConfig = RESNET50, seed: int = 0) -> Dict:
    """He-initialized parameter pytree (BN folded to scale/bias for inference)."""
    rng = np.random.default_rng(seed)
    params: Dict = {"stem": {
        "w": _conv_init(rng, 7, 7, 3, cfg.width),
        "scale": np.ones(cfg.width, np.float32),
        "bias": np.zeros(cfg.width, np.float32),
    }, "stages": []}
    cin = cfg.width
    for si, nblocks in enumerate(cfg.stage_sizes):
        cmid = cfg.width * (2 ** si)
        cout = cmid * 4
        stage = []
        for bi in range(nblocks):
            blk = {
                "conv1": {"w": _conv_init(rng, 1, 1, cin, cmid),
                          "scale": np.ones(cmid, np.float32),
                          "bias": np.zeros(cmid, np.float32)},
                "conv2": {"w": _conv_init(rng, 3, 3, cmid, cmid),
                          "scale": np.ones(cmid, np.float32),
                          "bias": np.zeros(cmid, np.float32)},
                "conv3": {"w": _conv_init(rng, 1, 1, cmid, cout),
                          "scale": np.ones(cout, np.float32),
                          "bias": np.zeros(cout, np.float32)},
            }
            if bi == 0:
                blk["proj"] = {"w": _conv_init(rng, 1, 1, cin, cout),
                               "scale": np.ones(cout, np.float32),
                               "bias": np.zeros(cout, np.float32)}
            stage.append(blk)
            cin = cout
        params["stages"].append(stage)
    params["head"] = {
        "w": rng.normal(0, 0.01, (cin, cfg.num_classes)).astype(np.float32),
        "b": np.zeros(cfg.num_classes, np.float32)}
    return params


def _conv_bn(x, p, stride, dtype):
    """Conv (HWIO weights, same padding) then the folded BN scale/bias, all
    in ``dtype``; ``x`` is NCHW in ``channels_last`` memory."""
    w = torch.as_tensor(p["w"], device=x.device).to(dtype)
    kh, kw = w.shape[0], w.shape[1]
    w = w.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
    y = F.conv2d(x, w, stride=stride, padding=(kh // 2, kw // 2))
    scale = torch.as_tensor(p["scale"], device=x.device).to(dtype)
    bias = torch.as_tensor(p["bias"], device=x.device).to(dtype)
    return y * scale.reshape(1, -1, 1, 1) + bias.reshape(1, -1, 1, 1)


def resnet_apply(params: Dict, x: torch.Tensor,
                 cfg: ResNetConfig = RESNET50,
                 features_only: bool = False) -> torch.Tensor:
    """Forward pass. ``x`` is NHWC float (a tensor on the device to run
    on); compute in ``cfg.dtype``; features or logits come back float32.
    ``params`` is :func:`init_resnet`'s tree, numpy or tensors."""
    dt = cfg.dtype
    # NHWC → an NCHW view whose memory is channels_last: no copy
    x = x.permute(0, 3, 1, 2).to(dt)
    x = torch.relu(_conv_bn(x, params["stem"], 2, dt))
    x = F.max_pool2d(x, 3, stride=2, padding=1)
    for si, stage in enumerate(params["stages"]):
        for bi, blk in enumerate(stage):
            stride = 2 if (si > 0 and bi == 0) else 1
            shortcut = x
            y = torch.relu(_conv_bn(x, blk["conv1"], 1, dt))
            y = torch.relu(_conv_bn(y, blk["conv2"], stride, dt))
            y = _conv_bn(y, blk["conv3"], 1, dt)
            if "proj" in blk:
                shortcut = _conv_bn(x, blk["proj"], stride, dt)
            x = torch.relu(y + shortcut)
    x = x.mean(dim=(2, 3))  # global average pool
    if features_only:
        return x.float()
    head_w = torch.as_tensor(params["head"]["w"], device=x.device).float()
    head_b = torch.as_tensor(params["head"]["b"], device=x.device).float()
    return x.float() @ head_w + head_b


# -- ONNX exporter -----------------------------------------------------------

def export_resnet_onnx(cfg: ResNetConfig = RESNET50, seed: int = 0,
                       params: Optional[Dict] = None,
                       input_size: int = 224) -> bytes:
    """Emit a standard NCHW ResNet ONNX graph (Conv+BN pre-folded to
    Conv-with-bias via scale/bias multiplication, matching inference form)."""
    from ...onnx.builder import (make_graph, make_model, make_node,
                                 make_tensor_value_info)
    if params is None:
        params = init_resnet(cfg, seed)
    nodes, inits = [], {}
    uid = [0]

    def conv(x_name, p, stride, out_name):
        uid[0] += 1
        wname, bname = f"w{uid[0]}", f"b{uid[0]}"
        # fold BN scale/bias into conv weight+bias (inference form)
        w_nhwc = p["w"] * p["scale"][None, None, None, :]
        w_oihw = np.transpose(w_nhwc, (3, 2, 0, 1)).astype(np.float32)
        inits[wname] = np.ascontiguousarray(w_oihw)
        inits[bname] = p["bias"].astype(np.float32)
        kh = p["w"].shape[0]
        nodes.append(make_node("Conv", [x_name, wname, bname], [out_name],
                               strides=[stride, stride],
                               pads=[kh // 2, kh // 2, kh // 2, kh // 2],
                               kernel_shape=[kh, p["w"].shape[1]]))
        return out_name

    x = conv("input", params["stem"], 2, "stem")
    nodes.append(make_node("Relu", [x], ["stem_r"]))
    nodes.append(make_node("MaxPool", ["stem_r"], ["pool0"],
                           kernel_shape=[3, 3], strides=[2, 2],
                           pads=[1, 1, 1, 1]))
    x = "pool0"
    for si, stage in enumerate(params["stages"]):
        for bi, blk in enumerate(stage):
            stride = 2 if (si > 0 and bi == 0) else 1
            base = f"s{si}b{bi}"
            y = conv(x, blk["conv1"], 1, f"{base}_c1")
            nodes.append(make_node("Relu", [y], [f"{base}_r1"]))
            y = conv(f"{base}_r1", blk["conv2"], stride, f"{base}_c2")
            nodes.append(make_node("Relu", [y], [f"{base}_r2"]))
            y = conv(f"{base}_r2", blk["conv3"], 1, f"{base}_c3")
            if "proj" in blk:
                sc = conv(x, blk["proj"], stride, f"{base}_proj")
            else:
                sc = x
            nodes.append(make_node("Add", [y, sc], [f"{base}_add"]))
            nodes.append(make_node("Relu", [f"{base}_add"], [f"{base}_out"]))
            x = f"{base}_out"
    nodes.append(make_node("GlobalAveragePool", [x], ["gap"]))
    nodes.append(make_node("Flatten", ["gap"], ["feat"], axis=1))
    inits["head_w"] = params["head"]["w"].astype(np.float32)
    inits["head_b"] = params["head"]["b"].astype(np.float32)
    nodes.append(make_node("Gemm", ["feat", "head_w", "head_b"], ["logits"]))
    graph = make_graph(
        nodes, "resnet",
        [make_tensor_value_info("input", np.float32,
                                ["N", 3, input_size, input_size])],
        [make_tensor_value_info("logits", np.float32,
                                ["N", cfg.num_classes]),
         make_tensor_value_info("feat", np.float32, ["N", None])],
        initializers=inits)
    return make_model(graph)

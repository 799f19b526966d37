"""Genuine torch.onnx.export artifacts through the converter.

The onnx shim (``interop/onnx_shim.py``) routes torch's single ``import
onnx`` use (the onnxscript-function scan) to this repo's own protobuf
parser, so ``torch.onnx.export`` emits REAL torch-serialized ONNX bytes in
a zero-egress image. These tests assert numeric parity of the converted
graphs against torch eval — the reference's bar is ORT executing arbitrary
exporter artifacts (``deep-learning/.../onnx/ONNXModel.scala:195-245``).
"""

import io
import warnings

import numpy as np
import pytest

from mmlspark_tpu.interop.onnx_shim import install_onnx_shim
from mmlspark_tpu.onnx.convert import convert_model

torch = pytest.importorskip("torch")
import torch.nn as nn  # noqa: E402

torch.set_num_threads(1)  # one a worker: README, "Testing & benchmarks"


def _export(model, args, **kw):
    install_onnx_shim()
    model.eval()
    buf = io.BytesIO()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        torch.onnx.export(model, args, buf, dynamo=False, **kw)
    return buf.getvalue()


def test_mlp_export_parity():
    torch.manual_seed(0)
    m = nn.Sequential(nn.Linear(4, 8), nn.ReLU(), nn.Linear(8, 3))
    x = torch.randn(2, 4)
    b = _export(m, (x,), input_names=["x"], output_names=["y"])
    cm = convert_model(b)
    assert cm.model.producer_name == "pytorch"   # genuine artifact
    got = np.asarray(cm(cm.params, {"x": x.numpy()})["y"])
    np.testing.assert_allclose(got, m(x).detach().numpy(),
                               rtol=1e-5, atol=1e-6)


class _BasicBlock(nn.Module):
    """torchvision-faithful BasicBlock (conv-bn-relu x2 + skip)."""

    def __init__(self, cin, cout, stride=1):
        super().__init__()
        self.conv1 = nn.Conv2d(cin, cout, 3, stride, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(cout)
        self.conv2 = nn.Conv2d(cout, cout, 3, 1, 1, bias=False)
        self.bn2 = nn.BatchNorm2d(cout)
        self.relu = nn.ReLU(inplace=True)
        self.down = None
        if stride != 1 or cin != cout:
            self.down = nn.Sequential(
                nn.Conv2d(cin, cout, 1, stride, bias=False),
                nn.BatchNorm2d(cout))

    def forward(self, x):
        idn = x if self.down is None else self.down(x)
        out = self.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        return self.relu(out + idn)


class _ResNet(nn.Module):
    """torchvision ResNet-18 topology at reduced width (the structure —
    stem, 4 stages, global pool, fc — is what the exporter exercises)."""

    def __init__(self, width=8, classes=10):
        super().__init__()
        w = width
        self.stem = nn.Sequential(
            nn.Conv2d(3, w, 7, 2, 3, bias=False), nn.BatchNorm2d(w),
            nn.ReLU(inplace=True), nn.MaxPool2d(3, 2, 1))
        self.layer1 = nn.Sequential(_BasicBlock(w, w), _BasicBlock(w, w))
        self.layer2 = nn.Sequential(_BasicBlock(w, 2 * w, 2),
                                    _BasicBlock(2 * w, 2 * w))
        self.layer3 = nn.Sequential(_BasicBlock(2 * w, 4 * w, 2),
                                    _BasicBlock(4 * w, 4 * w))
        self.layer4 = nn.Sequential(_BasicBlock(4 * w, 8 * w, 2),
                                    _BasicBlock(8 * w, 8 * w))
        self.pool = nn.AdaptiveAvgPool2d(1)
        self.fc = nn.Linear(8 * w, classes)

    def forward(self, x):
        x = self.stem(x)
        x = self.layer4(self.layer3(self.layer2(self.layer1(x))))
        return self.fc(torch.flatten(self.pool(x), 1))


def test_resnet_export_parity():
    torch.manual_seed(1)
    m = _ResNet()
    # BN with running stats in eval mode: run a forward pass in train mode
    # first so the stats are not the init values (a realistic checkpoint)
    m.train()
    with torch.no_grad():
        m(torch.randn(4, 3, 64, 64))
    m.eval()
    x = torch.randn(2, 3, 64, 64)
    b = _export(m, (x,), input_names=["image"], output_names=["logits"])
    cm = convert_model(b)
    got = np.asarray(cm(cm.params, {"image": x.numpy()})["logits"])
    want = m(x).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-4)


def test_hf_bert_export_parity():
    """A real transformers BERT (tiny config) through the real exporter:
    embeddings + LayerNorm + multi-head attention + pooler, exactly as HF
    emits them."""
    tr = pytest.importorskip("transformers")
    torch.manual_seed(2)
    cfg = tr.BertConfig(vocab_size=64, hidden_size=32, num_hidden_layers=2,
                        num_attention_heads=2, intermediate_size=64,
                        max_position_embeddings=32)
    m = tr.BertModel(cfg)
    m.eval()
    ids = torch.randint(0, 64, (2, 10))
    mask = torch.ones(2, 10, dtype=torch.long)
    mask[1, 6:] = 0                                  # real padding
    b = _export(m, (ids, mask),
                input_names=["input_ids", "attention_mask"],
                output_names=["last_hidden_state", "pooler_output"])
    cm = convert_model(b)
    out = cm(cm.params, {"input_ids": ids.numpy(),
                         "attention_mask": mask.numpy()})
    with torch.no_grad():
        want = m(ids, attention_mask=mask)
    np.testing.assert_allclose(
        np.asarray(out["last_hidden_state"]),
        want.last_hidden_state.numpy(), rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(
        np.asarray(out["pooler_output"]),
        want.pooler_output.numpy(), rtol=1e-3, atol=1e-4)


def test_shim_is_scoped_and_removable():
    import sys
    from mmlspark_tpu.interop.onnx_shim import uninstall_onnx_shim
    install_onnx_shim()
    assert getattr(sys.modules["onnx"], "__mmlspark_tpu_shim__", False)
    uninstall_onnx_shim()
    assert "onnx" not in sys.modules
    install_onnx_shim()      # leave installed for other tests' exports

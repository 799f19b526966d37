"""The port's ViT exporter (``models/zoo/vit.py``) against the JAX
package's on the CPU, at ``tests/test_vit.py``'s config (32 px, patch 8,
d_model 64, 4 heads, 2 layers).

* For the same config and seed both write the same nodes, attributes,
  inputs, outputs and bitwise-equal initializers (node names excluded:
  the builder derives them from object ids); ``init_vit_params`` is
  bitwise.
* ``feat`` and ``logits`` through the port's converter within ``F32``
  (1e-5 · max|ref| + 1e-6) of the JAX converter on the same bytes, and
  within 2e-4 of ``vit_reference`` (the reference test's bound), at two
  batch sizes; through ``ONNXModel(device="cpu")`` as well.
* The ``ImageFeaturizer`` case of ``tests/test_vit.py`` waits for ROADMAP
  queue item 5.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import mmlspark_tpu.onnx as J
import mmlspark_tpu_torch.onnx as O
from mmlspark_tpu.models.zoo import vit as jvit
from mmlspark_tpu_torch.core import DataFrame
from mmlspark_tpu_torch.models.onnx_model import ONNXModel
from mmlspark_tpu_torch.models.zoo import vit as pvit

torch.set_num_threads(1)  # one a worker: README, "Testing & benchmarks"

KW = dict(image_size=32, patch=8, d_model=64, heads=4, layers=2, d_ff=128,
          num_classes=5)


def _f32_close(got, want):
    assert got.shape == want.shape
    tol = 1e-5 * float(np.abs(want).max()) + 1e-6
    assert float(np.abs(got - want).max()) <= tol


def _view(pkg, data):
    m = pkg.parse_model(data)
    return ([(n.op_type, n.domain, list(n.input), list(n.output),
              {k: repr(n.attr(k)) for k in sorted(n.attributes)})
             for n in m.graph.nodes],
            [(v.name, v.elem_type, list(v.shape)) for v in m.graph.inputs],
            [(v.name, v.elem_type, list(v.shape)) for v in m.graph.outputs],
            m.opset, m.producer_name)


def test_export_matches_reference_exporter():
    mine = pvit.export_vit_onnx(pvit.ViTConfig(**KW), seed=2)
    ref = jvit.export_vit_onnx(jvit.ViTConfig(**KW), seed=2)
    assert _view(O, mine) == _view(J, ref)
    a = {t.name: O.tensor_to_numpy(t)
         for t in O.parse_model(mine).graph.initializers}
    b = {t.name: J.tensor_to_numpy(t)
         for t in J.parse_model(ref).graph.initializers}
    assert list(a) == list(b)
    assert all(a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k])
               for k in a)
    pa = pvit.init_vit_params(pvit.ViTConfig(**KW), 4)
    pb = jvit.init_vit_params(jvit.ViTConfig(**KW), 4)
    assert all(np.array_equal(pa[k], pb[k]) for k in pb)


@pytest.mark.parametrize("batch", [1, 3])
def test_logits_match_reference(batch):
    cfg = pvit.ViTConfig(**KW)
    params = pvit.init_vit_params(cfg, seed=0)
    data = pvit.export_vit_onnx(cfg, params=params)
    px = np.random.default_rng(batch).normal(
        0, 1, (batch, 3, 32, 32)).astype(np.float32)
    pm, jm = O.convert_model(data), J.convert_model(data)
    got = pm({k: torch.from_numpy(v) for k, v in pm.params.items()},
             {"pixel_values": torch.from_numpy(px)})
    want = jm(jm.params, {"pixel_values": jnp.asarray(px)})
    feat_ref, logits_ref = pvit.vit_reference(params, px, cfg)
    for name, ref in (("feat", feat_ref), ("logits", logits_ref)):
        assert got[name].shape == (batch, ref.shape[1])
        _f32_close(got[name].numpy(), np.asarray(want[name]))
        np.testing.assert_allclose(got[name].numpy(), ref, atol=2e-4)


def test_onnx_model_logits():
    cfg = pvit.ViTConfig(**KW)
    params = pvit.init_vit_params(cfg, seed=1)
    px = np.random.default_rng(9).normal(0, 1, (5, 3, 32, 32)) \
        .astype(np.float32)
    m = ONNXModel(pvit.export_vit_onnx(cfg, params=params), device="cpu",
                  feed_dict={"pixel_values": "px"},
                  fetch_dict={"logits": "logits"}, argmax_dict={"p": "logits"},
                  mini_batch_size=2)
    out = m.transform(DataFrame({"px": px}))
    want = pvit.vit_reference(params, px, cfg)[1]
    np.testing.assert_allclose(out["logits"], want, atol=2e-4)
    np.testing.assert_array_equal(out["p"], want.argmax(1))

"""The port's decoder exporter (``models/zoo/decoder_onnx.py``) and its
decode-step graph (``GroupQueryAttention`` over static kv caches with
fused rotary, ``SimplifiedLayerNormalization``, ``FastGelu``) against the
JAX package on the CPU, at ``tests/test_decoder_onnx.py``'s config
(vocab 97, 2 layers, d_model 32, 4 heads, 10 positions).

* From the same numpy params (``init_transformer``, bitwise in both
  packages) the two exporters write the same nodes and bitwise-equal
  initializers (node names excluded); the port's export of the same
  weights as ``params_from_numpy`` tensors is bitwise the same.
* Stepping the graph: the port's converter, its caches fed back as the
  next step's past, against the JAX converter stepping the same bytes,
  logits and present caches at every position within ``F32`` (1e-5 ·
  max|ref| + 1e-6), and the logits against the JAX ``decode_step`` and
  the port's ``decode_step_ragged`` within 2e-4 (the reference test's
  bound).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import mmlspark_tpu.onnx as J
import mmlspark_tpu_torch.onnx as O
from mmlspark_tpu.models.zoo import decoder_onnx as jdec
from mmlspark_tpu.models.zoo import transformer as jtf
from mmlspark_tpu_torch.models.zoo import decoder_onnx as pdec
from mmlspark_tpu_torch.models.zoo import transformer as ptf

torch.set_num_threads(1)  # one a worker: README, "Testing & benchmarks"

KW = dict(vocab=97, layers=2, d_model=32, heads=4, max_len=16, d_ff=64,
          causal=True, norm="rmsnorm", position="rope")
JCFG = jtf.TransformerConfig(dtype=jnp.float32, **KW)
PCFG = ptf.TransformerConfig(dtype=torch.float32, **KW)
L, B = 10, 2


def _f32_close(got, want, what):
    assert got.shape == want.shape, what
    tol = 1e-5 * float(np.abs(want).max()) + 1e-6
    err = float(np.abs(got - want).max())
    assert err <= tol, f"{what}: {err} > {tol}"


@pytest.fixture(scope="module")
def params():
    return jtf.init_transformer(JCFG, seed=3)


def _graph_and_inits(pkg, data):
    m = pkg.parse_model(data)
    nodes = [(n.op_type, n.domain, list(n.input), list(n.output),
              {k: repr(n.attr(k)) for k in sorted(n.attributes)})
             for n in m.graph.nodes]
    inits = {t.name: pkg.tensor_to_numpy(t) for t in m.graph.initializers}
    return nodes, [(v.name, v.elem_type, list(v.shape))
                   for v in m.graph.inputs + m.graph.outputs], inits


@pytest.mark.parametrize("source", ["numpy", "tensors"])
def test_export_matches_reference_exporter(params, source):
    np_params = jax.tree_util.tree_map(np.asarray, params)
    port_params = np_params if source == "numpy" else \
        ptf.params_from_numpy(np_params, PCFG, "cpu")
    mine = _graph_and_inits(O, pdec.export_decoder_onnx(PCFG, port_params,
                                                        L))
    ref = _graph_and_inits(J, jdec.export_decoder_onnx(JCFG, params, L))
    assert mine[:2] == ref[:2]
    assert list(mine[2]) == list(ref[2])
    for k, v in ref[2].items():
        assert mine[2][k].dtype == v.dtype and np.array_equal(mine[2][k], v)


def test_onnx_decode_steps_match_reference(params):
    np_params = jax.tree_util.tree_map(np.asarray, params)
    data = pdec.export_decoder_onnx(PCFG, np_params, max_len=L)
    pm, jm = O.convert_model(data), J.convert_model(data)
    tokens = np.random.default_rng(0).integers(0, KW["vocab"], (B, L))
    H, hd = KW["heads"], KW["d_model"] // KW["heads"]
    cache0 = {f"past_{kv}_{i}": np.zeros((B, H, L, hd), np.float32)
              for i in range(KW["layers"]) for kv in "kv"}
    # the JAX decode_step and the port's decode_step_ragged, step by step
    jcache = jtf.init_kv_cache(JCFG, B, L)
    tp = ptf.params_from_numpy(np_params, PCFG, "cpu")
    pcache = [{"k": torch.zeros(B, H, L, hd), "v": torch.zeros(B, H, L, hd)}
              for _ in range(KW["layers"])]
    pparams = {k: torch.from_numpy(v) for k, v in pm.params.items()}
    pfeeds = {k: torch.from_numpy(v.copy()) for k, v in cache0.items()}
    jfeeds = {k: jnp.asarray(v) for k, v in cache0.items()}
    for t in range(L):
        step = {"token": tokens[:, t:t + 1].astype(np.int64),
                "seqlens": np.full(B, t, np.int32),
                "total": np.array(t + 1, np.int32)}
        got = pm(pparams, {**{k: torch.from_numpy(v) for k, v in
                              step.items()}, **pfeeds})
        want = jm(jm.params, {**{k: jnp.asarray(v) for k, v in
                                 step.items()}, **jfeeds})
        for name in want:
            _f32_close(got[name].numpy(), np.asarray(want[name]),
                       f"step {t} {name}")
        native, jcache = jtf.decode_step(np_params, jnp.asarray(tokens[:, t]),
                                         t, jcache, JCFG)
        np.testing.assert_allclose(got["logits"].numpy(), np.asarray(native),
                                   rtol=2e-4, atol=2e-4, err_msg=f"step {t}")
        ported, pcache = ptf.decode_step_ragged(
            tp, torch.from_numpy(tokens[:, t]), torch.full((B,), t),
            pcache, PCFG)
        np.testing.assert_allclose(got["logits"].numpy(), ported.numpy(),
                                   rtol=2e-4, atol=2e-4, err_msg=f"step {t}")
        # the present caches feed the next step; the port's are the fed
        # past buffers, written in place
        assert all(got[f"present_{kv}_{i}"] is pfeeds[f"past_{kv}_{i}"]
                   for i in range(KW["layers"]) for kv in "kv")
        pfeeds = {k.replace("present", "past"): v for k, v in got.items()
                  if k.startswith("present")}
        jfeeds = {k.replace("present", "past"): v for k, v in want.items()
                  if k.startswith("present")}
        assert pfeeds["past_k_0"].shape == (B, H, L, hd)


def test_export_guards():
    enc = PCFG._replace(causal=False)
    with pytest.raises(ValueError, match="decoder switches"):
        pdec.export_decoder_onnx(enc, ptf.init_transformer(enc, seed=0), 8)
    odd = ptf.TransformerConfig(vocab=32, layers=1, d_model=30, heads=6,
                                d_ff=32, max_len=8, dtype=torch.float32,
                                causal=True, norm="rmsnorm", position="rope")
    with pytest.raises(ValueError, match="even head dim"):
        pdec.export_decoder_onnx(odd, ptf.init_transformer(odd, seed=0), 8)

"""Port parity: the zoo transformer's full-sequence forward and trainer
(``transformer_apply`` → ``loss_fn`` → ``train_step``), dense and flash.

The same seeded weights, ids, masks and labels (numpy) go through the JAX
reference (flash attention through its Pallas kernels in interpret mode)
and through ``mmlspark_tpu_torch``'s port (plain flash versions on the
CPU), in f32 at a tiny width. Hidden states and the loss agree within
2e-4 (the reference's own flash-vs-dense tolerance); after two
``train_step``s the parameters agree within 1e-6 absolute (each step moves
them by 1e-4 times the momentum) and the momentum buffers, which hold the
gradients, within 2e-4 of each leaf's largest entry (f32 backward
summation order).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mmlspark_tpu.models.zoo import transformer as ref
from mmlspark_tpu_torch.models.zoo import transformer as port
from mmlspark_tpu_torch.ops.flash_attention import (flash_attention,
                                                    flash_attention_bwd_plain,
                                                    flash_attention_plain)

torch.set_num_threads(1)  # one a worker: README, "Testing & benchmarks"

TOL = dict(rtol=2e-4, atol=2e-4)
WIDTH = dict(vocab=64, layers=2, d_model=64, heads=2, d_ff=128, max_len=64)
DECODER = dict(causal=True, norm="rmsnorm", position="rope")


def _cfgs(kind, use_flash):
    extra = DECODER if kind == "decoder" else {}
    return (ref.TransformerConfig(dtype=jnp.float32, use_flash=use_flash,
                                  **WIDTH, **extra),
            port.TransformerConfig(dtype=torch.float32, use_flash=use_flash,
                                   **WIDTH, **extra))


def _inputs(seed, B=2, S=48, pad_row=False):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, WIDTH["vocab"], (B, S))
    labels = rng.integers(0, WIDTH["vocab"], (B, S))
    mask = np.ones((B, S), bool)
    mask[0, S - 11:] = False                # a ragged padding tail
    if pad_row:
        mask[-1] = False                    # a fully padded sequence
    return ids, labels, mask


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, list):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def _zeros_like(tree):
    if isinstance(tree, dict):
        return {k: _zeros_like(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_zeros_like(v) for v in tree]
    return torch.zeros_like(tree, requires_grad=False)


@pytest.mark.parametrize("kind", ["encoder", "decoder"])
@pytest.mark.parametrize("use_flash", [False, True])
def test_transformer_apply_matches_reference(kind, use_flash):
    """Encoder (LayerNorm, learned positions) and decoder (RMSNorm, RoPE,
    causal), dense and flash, with a ragged mask and a fully padded row:
    the two packages agree on every row, including the padded one (dense:
    the mean of v; flash: zeros)."""
    rc, pc = _cfgs(kind, use_flash)
    p = ref.init_transformer(rc, seed=1)
    ids, _, mask = _inputs(2, pad_row=True)
    want = np.asarray(ref.transformer_apply(
        jax.tree.map(jnp.asarray, p), jnp.asarray(ids), rc,
        mask=jnp.asarray(mask)))
    launches = flash_attention.launches
    calls = flash_attention_plain.calls
    got = port.transformer_apply(port.params_from_numpy(p, pc, "cpu"),
                                 torch.from_numpy(ids), pc,
                                 mask=torch.from_numpy(mask))
    assert got.shape == want.shape and got.dtype == torch.float32
    assert flash_attention.launches == launches
    assert flash_attention_plain.calls == calls + (
        WIDTH["layers"] if use_flash else 0)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("kind", ["encoder", "decoder"])
def test_flash_equals_dense_off_the_padded_row(kind):
    """Flash and dense agree except on a fully padded sequence, where
    dense attends uniformly and flash gives 0 (the reference's
    documented difference)."""
    _, pc = _cfgs(kind, False)
    params = port.params_from_numpy(port.init_transformer(pc, seed=3), pc,
                                    "cpu")
    ids, _, mask = _inputs(4, pad_row=True)
    ids, mask = torch.from_numpy(ids), torch.from_numpy(mask)
    dense = port.transformer_apply(params, ids, pc, mask=mask)
    flash = port.transformer_apply(params, ids, pc._replace(use_flash=True),
                                   mask=mask)
    torch.testing.assert_close(flash[:-1], dense[:-1], **TOL)
    assert not torch.allclose(flash[-1], dense[-1], **TOL)


@pytest.mark.parametrize("use_flash", [False, True])
def test_loss_fn_matches_reference(use_flash):
    rc, pc = _cfgs("decoder", use_flash)
    p = ref.init_transformer(rc, seed=5)
    ids, labels, _ = _inputs(6)
    want = float(ref.loss_fn(jax.tree.map(jnp.asarray, p), jnp.asarray(ids),
                             jnp.asarray(labels), rc))
    got = port.loss_fn(port.params_from_numpy(p, pc, "cpu"),
                       torch.from_numpy(ids), torch.from_numpy(labels), pc)
    assert got.dtype == torch.float32 and got.dim() == 0
    np.testing.assert_allclose(float(got), want, **TOL)


@pytest.mark.parametrize("kind,use_flash", [("encoder", False),
                                            ("encoder", True),
                                            ("decoder", True)])
def test_two_train_steps_match_reference(kind, use_flash):
    """Two SGD-with-momentum steps: loss, every parameter and every
    momentum buffer against the reference's ``train_step``."""
    rc, pc = _cfgs(kind, use_flash)
    p = ref.init_transformer(rc, seed=7)
    ids, labels, _ = _inputs(8)
    jp = jax.tree.map(jnp.asarray, p)
    jm = jax.tree.map(jnp.zeros_like, jp)
    tp = port.params_from_numpy(p, pc, "cpu", master=True)
    tm = _zeros_like(tp)
    tids, tlab = torch.from_numpy(ids), torch.from_numpy(labels)
    bwd = flash_attention_bwd_plain.calls
    for step in range(2):
        jp, jm, jloss = ref.train_step(jp, jm, jnp.asarray(ids),
                                       jnp.asarray(labels), rc)
        out = port.train_step(tp, tm, tids, tlab, pc)
        assert out[0] is tp and out[1] is tm          # updated in place
        np.testing.assert_allclose(float(out[2]), float(jloss), **TOL,
                                   err_msg=f"loss, step {step}")
    assert flash_attention_bwd_plain.calls == bwd + (
        2 * WIDTH["layers"] if use_flash else 0)
    for a, b in zip(_leaves(tp), _leaves(jax.tree.map(np.asarray, jp))):
        assert a.dtype == torch.float32 and a.requires_grad
        np.testing.assert_allclose(a.detach().numpy(), b, rtol=0, atol=1e-6)
    for a, b in zip(_leaves(tm), _leaves(jax.tree.map(np.asarray, jm))):
        scale = max(float(np.abs(b).max()), 1e-30)
        np.testing.assert_allclose(a.numpy(), b, rtol=0, atol=2e-4 * scale)


def test_training_lowers_the_loss():
    _, pc = _cfgs("encoder", True)
    tp = port.params_from_numpy(port.init_transformer(pc, seed=9), pc, "cpu",
                                master=True)
    tm = _zeros_like(tp)
    ids, _, _ = _inputs(10)
    ids = torch.from_numpy(ids)
    losses = [float(port.train_step(tp, tm, ids, ids, pc, lr=0.05)[2])
              for _ in range(6)]
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]


def test_master_and_serving_dicts_give_the_same_bf16_forward():
    """The per-use cast is a no-op on the serving dict: bf16 forwards from
    the serving dict and from the f32 master dict are bitwise equal."""
    cfg = port.TransformerConfig(dtype=torch.bfloat16, use_flash=True,
                                 **WIDTH)
    p = port.init_transformer(cfg, seed=11)
    serving = port.params_from_numpy(p, cfg, "cpu")
    master = port.params_from_numpy(p, cfg, "cpu", master=True)
    assert serving["layers"][0]["qkv"]["w"].dtype == torch.bfloat16
    assert all(t.dtype == torch.float32 and t.requires_grad
               for t in _leaves(master))
    ids, _, mask = _inputs(12, S=32)
    ids, mask = torch.from_numpy(ids), torch.from_numpy(mask)
    with torch.no_grad():
        a = port.transformer_apply(serving, ids, cfg, mask=mask)
        b = port.transformer_apply(master, ids, cfg, mask=mask)
    assert a.dtype == torch.bfloat16
    assert torch.equal(a, b)


def test_return_aux_is_zero_and_configs_match_reference():
    _, pc = _cfgs("encoder", False)
    params = port.params_from_numpy(port.init_transformer(pc), pc, "cpu")
    ids = torch.from_numpy(_inputs(13)[0])
    hidden, aux = port.transformer_apply(params, ids, pc, return_aux=True)
    assert hidden.shape == (2, 48, WIDTH["d_model"])
    assert float(aux["balance"]) == 0.0 and float(aux["dropped"]) == 0.0
    for name in ("BERT_BASE", "BERT_MINI", "DECODER_MINI"):
        a, b = getattr(port, name), getattr(ref, name)
        assert {f: getattr(a, f) for f in a._fields if f != "dtype"} == \
            {f: getattr(b, f) for f in b._fields if f != "dtype"}
        assert a.dtype == torch.bfloat16
    assert port.BERT_BASE.is_moe_layer(1) is False
    assert pc._replace(moe_experts=4).is_moe_layer(1)


def test_unported_options_raise():
    _, pc = _cfgs("encoder", True)
    params = port.params_from_numpy(port.init_transformer(pc), pc, "cpu")
    ids = torch.from_numpy(_inputs(14)[0])
    with pytest.raises(NotImplementedError, match="slice 6"):
        port.transformer_apply(params, ids, pc, mesh=object())
    with pytest.raises(NotImplementedError, match="slice 6"):
        port.transformer_apply(params, ids, pc._replace(moe_experts=4))
    with pytest.raises(NotImplementedError, match="slice 6"):
        port.init_transformer(pc._replace(moe_experts=4))
    with pytest.raises(ValueError):
        port.transformer_apply(params, ids, pc._replace(norm="batchnorm"))


def test_master_params_default_to_cuda_and_raise_without_it():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    _, pc = _cfgs("encoder", True)
    with pytest.raises(RuntimeError, match="CUDA"):
        port.params_from_numpy(port.init_transformer(pc), pc, master=True)


@pytest.mark.cuda
def test_cuda_train_step_runs_through_the_kernels():
    """On the card: two flash train steps launch K7, K8a and K8b once per
    layer per step and track the CPU's plain-version steps."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    _, pc = _cfgs("encoder", True)
    p = port.init_transformer(pc, seed=15)
    ids, labels, _ = (torch.from_numpy(a) for a in _inputs(16))
    runs = {}
    for dev in ("cpu", "cuda"):
        tp = port.params_from_numpy(p, pc, dev, master=True)
        tm = _zeros_like(tp)
        before = (flash_attention.launches, flash_attention.launches_dkv,
                  flash_attention.launches_dq)
        losses = [float(port.train_step(tp, tm, ids.to(dev), labels.to(dev),
                                        pc)[2]) for _ in range(2)]
        after = (flash_attention.launches, flash_attention.launches_dkv,
                 flash_attention.launches_dq)
        runs[dev] = (losses, [t.detach().cpu() for t in _leaves(tp)],
                     [a - b for a, b in zip(after, before)])
    assert runs["cpu"][2] == [0, 0, 0]
    assert runs["cuda"][2] == [2 * WIDTH["layers"]] * 3
    np.testing.assert_allclose(runs["cuda"][0], runs["cpu"][0], **TOL)
    for a, b in zip(runs["cuda"][1], runs["cpu"][1]):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-6)

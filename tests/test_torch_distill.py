"""Port parity: LM training and draft distillation
(``models/zoo/distill.py``) on the cases of ``tests/test_distill.py``.

The same seeded numpy weights and ``markov_sampler`` batches go through the
JAX reference (optax AdamW) and the port (``torch.optim.AdamW`` with
optax's defaults), in f32 on the CPU. Tolerances:

* ``markov_sampler`` batches equal, element for element;
* loss histories within 1e-4 · |loss| + 1e-6 of the reference's;
* parameters after the steps within 0.05 · lr of the reference's: Adam
  normalizes each step by sqrt(v), so a coordinate whose gradient is
  rounding-sized moves by up to ~lr on either side; measured here
  ≈ 0.005 · lr;
* the chain the JAX test checks (losses fall, the distilled draft lifts
  acceptance, speculative output stays the target's) on the port alone.
"""

import inspect

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mmlspark_tpu.models.zoo import distill as rdist
from mmlspark_tpu.models.zoo import transformer as ref
from mmlspark_tpu_torch.models.zoo import distill as pdist
from mmlspark_tpu_torch.models.zoo import speculative as ps
from mmlspark_tpu_torch.models.zoo import transformer as port

torch.set_num_threads(1)  # one a worker: README, "Testing & benchmarks"

_T = dict(vocab=64, layers=2, d_model=64, heads=4, d_ff=128, max_len=128,
          causal=True, norm="rmsnorm", position="rope")
_D = dict(_T, layers=1, d_model=32, heads=2, d_ff=64)
R_T = ref.TransformerConfig(dtype=jnp.float32, **_T)
R_D = ref.TransformerConfig(dtype=jnp.float32, **_D)
T_CFG = port.TransformerConfig(dtype=torch.float32, **_T)
D_CFG = port.TransformerConfig(dtype=torch.float32, **_D)


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, list):
        return [x for v in tree for x in _leaves(v)]
    return [np.asarray(tree)]


def _close_params(got, want, lr):
    a, b = _leaves(got), _leaves(want)
    assert len(a) == len(b)
    err = max(float(np.abs(x - y).max()) for x, y in zip(a, b))
    assert err <= 0.05 * lr, f"max |port - jax| = {err / lr:.4f} lr"


def _close_hist(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert (np.abs(got - want) <= 1e-4 * np.abs(want) + 1e-6).all(), \
        (got, want)


@pytest.mark.parametrize("seed,branching", [(0, 4), (3, 4), (5, 2)])
def test_markov_sampler_equal(seed, branching):
    a = rdist.markov_sampler(64, batch=5, seq=12, seed=seed,
                             branching=branching)
    b = pdist.markov_sampler(64, batch=5, seq=12, seed=seed,
                             branching=branching)
    for step in (0, 1, 7, 999):
        x, y = a(step), b(step)
        assert y.dtype == np.int32
        np.testing.assert_array_equal(x, y)


def test_adamw_is_optax_default():
    import optax
    sig = inspect.signature(optax.adamw).parameters
    assert pdist.ADAMW == dict(
        betas=(sig["b1"].default, sig["b2"].default), eps=sig["eps"].default,
        weight_decay=sig["weight_decay"].default)


@pytest.fixture(scope="module")
def trained_pair():
    """Ten steps of train_lm, then ten of distill_draft, both packages."""
    bf = rdist.markov_sampler(64, batch=8, seq=16, seed=3)
    t0 = ref.init_transformer(R_T, seed=0)
    rt, rh = rdist.train_lm(t0, R_T, bf, steps=10, learning_rate=1e-3,
                            log_every=1)
    pt, ph = pdist.train_lm(t0, T_CFG, bf, steps=10, learning_rate=1e-3,
                            log_every=1, device="cpu")
    rd, rdh = rdist.distill_draft(rt, R_T, R_D, bf, steps=10,
                                  learning_rate=2e-3)
    pd, pdh = pdist.distill_draft(pt, T_CFG, D_CFG, bf, steps=10,
                                  learning_rate=2e-3, device="cpu")
    return (rt, rh, pt, ph), (rd, rdh, pd, pdh)


def test_train_lm_matches_reference(trained_pair):
    rt, rh, pt, ph = trained_pair[0]
    _close_hist(ph, rh)
    _close_params(pt, rt, 1e-3)
    assert ph[-1] < ph[0]


def test_distill_draft_matches_reference(trained_pair):
    rd, rdh, pd, pdh = trained_pair[1]
    _close_hist(pdh, rdh)
    _close_params(pd, rd, 2e-3)


def test_distill_from_the_same_teacher_matches_reference():
    """Both students distil from the JAX-trained teacher's exact weights,
    with a temperature, from a given draft start."""
    bf = pdist.markov_sampler(64, batch=4, seq=12, seed=9)
    teacher = ref.init_transformer(R_T, seed=4)
    start = ref.init_transformer(R_D, seed=8)
    rd, rh = rdist.distill_draft(teacher, R_T, R_D, bf, steps=4,
                                 learning_rate=1e-3, tau=2.0,
                                 d_params=start)
    pd, ph = pdist.distill_draft(teacher, T_CFG, D_CFG, bf, steps=4,
                                 learning_rate=1e-3, tau=2.0,
                                 d_params=start, device="cpu")
    _close_hist(ph, rh)
    _close_params(pd, rd, 1e-3)


def test_train_lm_log_every():
    bf = pdist.markov_sampler(64, batch=2, seq=8, seed=1)
    p0 = port.init_transformer(T_CFG, seed=2)
    _, none = pdist.train_lm(p0, T_CFG, bf, steps=3, device="cpu")
    _, every2 = pdist.train_lm(p0, T_CFG, bf, steps=5, log_every=2,
                               device="cpu")
    assert none == [] and len(every2) == 2


@pytest.fixture(scope="module")
def trained():
    """The JAX test's chain at its sizes, on the port alone."""
    batch_fn = pdist.markov_sampler(T_CFG.vocab, batch=16, seq=32, seed=3)
    t0 = port.init_transformer(T_CFG, seed=0)
    t_params, hist = pdist.train_lm(t0, T_CFG, batch_fn, steps=80,
                                    learning_rate=1e-3, log_every=40,
                                    device="cpu")
    d_params, d_hist = pdist.distill_draft(t_params, T_CFG, D_CFG, batch_fn,
                                           steps=80, learning_rate=2e-3,
                                           device="cpu")
    return batch_fn, t_params, d_params, hist, d_hist


def test_lm_loss_decreases(trained):
    assert trained[3][-1] < trained[3][0]


def test_kl_decreases(trained):
    assert trained[4][-1] < 0.5 * trained[4][0]


def test_distilled_draft_lifts_acceptance(trained):
    batch_fn, t_params, d_params, _, _ = trained
    prompt = batch_fn(999)[:1, :16]
    random_draft = port.init_transformer(D_CFG, seed=7)
    _, s_rand = ps.generate_speculative_fused(
        t_params, random_draft, prompt, T_CFG, D_CFG, max_new_tokens=24,
        gamma=4, device="cpu")
    _, s_dist = ps.generate_speculative_fused(
        t_params, d_params, prompt, T_CFG, D_CFG, max_new_tokens=24,
        gamma=4, device="cpu")
    acc_rand = s_rand["accepted_drafts"] / max(s_rand["rounds"], 1)
    acc_dist = s_dist["accepted_drafts"] / max(s_dist["rounds"], 1)
    assert acc_dist > acc_rand + 1.0
    assert s_dist["target_forwards"] < s_rand["target_forwards"]


def test_output_stays_target_exact(trained):
    batch_fn, t_params, d_params, _, _ = trained
    prompt = batch_fn(1234)[:1, :12]
    want = port.generate_cached(t_params, prompt, T_CFG, max_new_tokens=20,
                                device="cpu")
    got, _ = ps.generate_speculative_fused(t_params, d_params, prompt,
                                           T_CFG, D_CFG, max_new_tokens=20,
                                           gamma=4, device="cpu")
    np.testing.assert_array_equal(got.numpy(), want.numpy())


def test_vocab_mismatch_rejected():
    bad = D_CFG._replace(vocab=32)
    with pytest.raises(ValueError, match="vocabulary"):
        pdist.distill_draft(port.init_transformer(T_CFG, 0), T_CFG, bad,
                            pdist.markov_sampler(64, 2, 8), steps=1,
                            device="cpu")

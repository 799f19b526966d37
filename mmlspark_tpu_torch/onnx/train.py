"""Training on imported ONNX graphs (counterpart of ``onnx/train.py``).

An imported graph is a PyTorch function over an explicit ``params`` dict
(``ConvertedModel.__call__(params, feeds)``), so ``torch.autograd`` flows
through every differentiable handler: any ONNX model, a graph that
carries its own loss (SoftmaxCrossEntropyLoss, NegativeLogLikelihoodLoss)
included, fine-tunes on the card. Attention of the fused transformer ops
runs K7 forward and K8a/K8b backward there (``_attention_core`` ->
``ops.flash_attention``).

The reference's steps are jitted optax updates; here a step is eager:
the params are leaf tensors that require grad, ``loss.backward()`` fills
their gradients and a ``torch.optim`` optimizer updates them in place.
``optimizer`` arguments are factories from a list of tensors to a
``torch.optim.Optimizer``: :func:`adam` and :func:`sgd` give optax's
``adam`` (b1 0.9, b2 0.999, eps 1e-8, no weight decay) and ``sgd`` (no
momentum). ``trainable`` rejects a param by leaving it out of the
optimizer (it does not require grad): the reference zeroes its gradient,
after which Adam leaves it unchanged, so the two agree.

``init_lora`` draws the adapters' ``a`` matrices from the reference's
threefry stream (:mod:`..utils.prng`), so both packages start from the
same adapters (normals within a few ulps). Entry points place numpy
params and feeds on ``device`` (``None`` = the CUDA card); tensors stay
on their own device.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np
import torch

from ..utils import prng
from ..utils.device import resolve_device
from .convert import ConvertedModel

__all__ = ["value_and_grad", "make_train_step", "fine_tune",
           "lora_targets", "init_lora", "lora_merge",
           "make_lora_train_step", "lora_fine_tune", "adam", "sgd"]


def adam(learning_rate: float) -> Callable:
    """optax.adam's defaults as a ``torch.optim.Adam`` factory."""
    def make(tensors):
        return torch.optim.Adam(tensors, lr=learning_rate, betas=(0.9, 0.999),
                                eps=1e-8, weight_decay=0.0)
    return make


def sgd(learning_rate: float) -> Callable:
    """optax.sgd's defaults (no momentum) as a ``torch.optim.SGD``
    factory."""
    def make(tensors):
        return torch.optim.SGD(tensors, lr=learning_rate)
    return make


def _device_of(*trees, device=None) -> torch.device:
    """The device of the first tensor in the (nested dict) trees, else
    ``resolve_device(device)``."""
    for tree in trees:
        for v in (tree or {}).values():
            if isinstance(v, dict):
                v = next(iter(v.values()), None)
            if isinstance(v, torch.Tensor):
                return v.device
    return resolve_device(device)


def _tensor(v, dev: torch.device) -> torch.Tensor:
    if isinstance(v, torch.Tensor):
        return v if v.device == dev else v.to(dev)
    return torch.from_numpy(np.array(v)).to(dev)


def _leaves(params: Dict, dev: torch.device,
            trainable: Optional[Callable[[str], bool]] = None) -> Dict:
    """The params as fresh tensors on ``dev``; the trainable ones are
    float leaves that require grad."""
    out = {}
    for k, v in params.items():
        t = _tensor(v, dev).detach().clone()
        if t.is_floating_point() and (trainable is None or trainable(k)):
            t.requires_grad_(True)
        out[k] = t
    return out


def _feeds(feeds: Dict, dev: torch.device) -> Dict:
    return {k: _tensor(v, dev) for k, v in feeds.items()}


def _scalar_loss(model: ConvertedModel, loss_fn, output: Optional[str]):
    """loss(params, feeds) -> scalar tensor: a graph output that already
    is the loss, or ``loss_fn(outputs, feeds)``."""
    if loss_fn is None:
        if output is None:
            if len(model.output_names) != 1:
                raise ValueError(
                    "graph has several outputs; pass output= (a scalar "
                    "loss output) or loss_fn=(outputs, feeds) -> scalar")
            output = model.output_names[0]

        def loss(params, feeds):
            return model(params, feeds)[output].sum()
    else:
        def loss(params, feeds):
            return loss_fn(model(params, feeds), feeds)
    return loss


def value_and_grad(model: ConvertedModel,
                   loss_fn: Optional[Callable] = None,
                   output: Optional[str] = None, device=None):
    """``(params, feeds) -> (scalar, grads)`` for an imported graph: the
    loss (a 0-d tensor) and ``{name: gradient}`` for every float param.

    ``output`` names a graph output that already is the loss (e.g. a
    SoftmaxCrossEntropyLoss node with reduction='mean'); alternatively
    ``loss_fn(outputs_dict, feeds) -> scalar`` computes one (the feeds
    reach it as tensors on the device)."""
    loss = _scalar_loss(model, loss_fn, output)

    def vg(params, feeds):
        dev = _device_of(params, feeds, device=device)
        leaves = _leaves(params, dev)
        val = loss(leaves, _feeds(feeds, dev))
        names = [k for k, t in leaves.items() if t.requires_grad]
        grads = torch.autograd.grad(val, [leaves[k] for k in names],
                                    allow_unused=True)
        return val.detach(), {
            k: (g if g is not None else torch.zeros_like(leaves[k]))
            for k, g in zip(names, grads)}
    return vg


class _OptState:
    """A step's state: the leaf tensors being trained and their torch
    optimizer."""

    def __init__(self, leaves: Dict, optimizer):
        self.leaves = leaves
        self.optimizer = optimizer


def _sync_in(params: Dict, leaves: Dict) -> None:
    """Values the caller passes that are not the state's own tensors are
    copied into them (a functional caller's params)."""
    with torch.no_grad():
        for k, t in leaves.items():
            v = params.get(k, t)
            if v is not t:
                t.copy_(_tensor(v, t.device))


def make_train_step(model: ConvertedModel, optimizer,
                    loss_fn: Optional[Callable] = None,
                    output: Optional[str] = None,
                    trainable: Optional[Callable[[str], bool]] = None,
                    device=None):
    """One optimizer step over the graph's params.

    ``optimizer`` is a factory (:func:`adam`, :func:`sgd`); ``trainable``
    an optional name predicate whose rejected params stay as they are
    (the frozen-backbone pattern). Returns ``(step, init)``:
    ``init(params) -> opt_state`` places the params on the device, and
    ``step(params, opt_state, feeds) -> (params, opt_state, loss)``
    updates them in place and returns them (``params`` is the dict the
    last step or ``init`` gave, or any dict of values to start from)."""
    loss = _scalar_loss(model, loss_fn, output)

    def init(params):
        dev = _device_of(params, device=device)
        leaves = _leaves(params, dev, trainable)
        trained = [t for t in leaves.values() if t.requires_grad]
        return _OptState(leaves, optimizer(trained))

    def step(params, opt_state, feeds):
        leaves = opt_state.leaves
        _sync_in(params, leaves)
        dev = next(iter(leaves.values())).device
        opt_state.optimizer.zero_grad(set_to_none=True)
        val = loss(leaves, _feeds(feeds, dev))
        val.backward()
        opt_state.optimizer.step()
        return leaves, opt_state, val.detach()

    return step, init


def fine_tune(model: ConvertedModel, feeds_iter, optimizer=None,
              loss_fn: Optional[Callable] = None,
              output: Optional[str] = None,
              steps: Optional[int] = None,
              trainable: Optional[Callable[[str], bool]] = None,
              params: Optional[Dict] = None, device=None):
    """Iterate ``feeds_iter`` (dicts of graph inputs), one optimizer step
    each; returns (params, losses), the params detached tensors on the
    device. ``params`` defaults to the graph's own initializers (the
    imported weights are the warm start); ``optimizer`` to ``adam(1e-3)``."""
    if optimizer is None:
        optimizer = adam(1e-3)
    step, init = make_train_step(model, optimizer, loss_fn=loss_fn,
                                 output=output, trainable=trainable,
                                 device=device)
    state = init(params if params is not None else model.params)
    cur = state.leaves
    losses = []
    for i, feeds in enumerate(feeds_iter):
        if steps is not None and i >= steps:
            break
        cur, state, val = step(cur, state, feeds)
        losses.append(float(val))
    return {k: v.detach() for k, v in cur.items()}, losses


# ---- LoRA: low-rank adapters over imported graphs -------------------------
# An adapter trains rank * (n + m) numbers per matrix instead of n * m, and
# the optimizer state shrinks with it; the merged deltas serve through
# ONNXModel's ``weights_override`` like any fine-tune.


def lora_targets(model: ConvertedModel, rank: int,
                 trainable: Optional[Callable[[str], bool]] = None):
    """Params eligible for adaptation: 2-D float weights with both dims
    larger than ``rank``, filtered by ``trainable``."""
    out = []
    for k, v in model.params.items():
        a = np.asarray(v)
        if (a.ndim == 2 and a.dtype.kind == "f" and min(a.shape) > rank
                and (trainable is None or trainable(k))):
            out.append(k)
    return sorted(out)


def init_lora(model: ConvertedModel, rank: int, targets=None,
              seed: int = 0, device=None) -> Dict:
    """Fresh adapters {name: {"a": (n, r), "b": (r, m)}} on ``device``:
    ``a`` a fan-in gaussian (the reference's threefry draws, key
    ``fold_in(PRNGKey(seed), i)`` for the i-th target in name order),
    ``b`` zeros, so the first forward equals the imported graph's."""
    if rank < 1:
        raise ValueError("rank must be >= 1")
    targets = (lora_targets(model, rank) if targets is None
               else sorted(targets))
    if not targets:
        raise ValueError(
            f"no 2-D params wider than rank {rank} to adapt (an explicit "
            "targets= / trainable filter may have excluded every matrix)")
    unknown = [t for t in targets if t not in model.params]
    if unknown:
        raise ValueError(f"unknown target params {unknown[:5]}")
    bad = [t for t in targets if np.asarray(model.params[t]).ndim != 2]
    if bad:
        raise ValueError(f"LoRA targets must be 2-D weights; {bad[:5]} "
                         "are not")
    dev = resolve_device(device)
    key = prng.PRNGKey(seed, device=dev)
    lora = {}
    for i, k in enumerate(targets):
        n, m = model.params[k].shape
        a = prng.normal(prng.fold_in(key, i), (n, rank)) / torch.sqrt(
            torch.tensor(float(n), dtype=torch.float32, device=dev))
        lora[k] = {"a": a, "b": torch.zeros((rank, m), dtype=torch.float32,
                                            device=dev)}
    return lora


def lora_merge(params: Dict, lora: Dict, alpha: float) -> Dict:
    """Base params with every adapter's ``(alpha / rank) a @ b`` delta
    folded in: the artifact that serves (and quantizes) like any
    fine-tune. Adapted entries come back as tensors on the adapters'
    device; the others are passed through."""
    out = dict(params)
    for k, ab in lora.items():
        a, b = ab["a"], ab["b"]
        r = a.shape[1]
        base = _tensor(out[k], a.device)
        delta = (torch.tensor(alpha / r, dtype=torch.float32,
                              device=a.device) * (a @ b)).to(base.dtype)
        out[k] = base + delta
    return out


def make_lora_train_step(model: ConvertedModel, optimizer,
                         alpha: Optional[float] = None,
                         loss_fn: Optional[Callable] = None,
                         output: Optional[str] = None, device=None):
    """One LoRA step: gradients flow only into the adapters; ``base`` is
    never updated and carries no optimizer state. ``alpha`` defaults to
    the adapters' rank (scale 1). Returns ``(step, init)`` with
    ``init(lora) -> opt_state`` (numpy adapters are placed on
    ``device``) and
    ``step(base, lora, opt_state, feeds) -> (lora, opt_state, loss)``."""
    loss = _scalar_loss(model, loss_fn, output)

    def init(lora):
        dev = _device_of(*lora.values(), device=device)
        leaves = {k: {n: _tensor(t, dev).detach().clone().requires_grad_(True)
                      for n, t in ab.items()} for k, ab in lora.items()}
        flat = [t for ab in leaves.values() for t in ab.values()]
        return _OptState(leaves, optimizer(flat))

    def step(base, lora, opt_state, feeds):
        leaves = opt_state.leaves
        with torch.no_grad():
            for k, ab in leaves.items():
                for n, t in ab.items():
                    v = lora[k][n]
                    if v is not t:
                        t.copy_(_tensor(v, t.device))
        dev = next(iter(leaves.values()))["a"].device
        rank = next(iter(leaves.values()))["a"].shape[1]
        scale = rank if alpha is None else alpha
        opt_state.optimizer.zero_grad(set_to_none=True)
        base_t = {k: _tensor(v, dev) for k, v in base.items()}
        val = loss(lora_merge(base_t, leaves, scale), _feeds(feeds, dev))
        val.backward()
        opt_state.optimizer.step()
        return leaves, opt_state, val.detach()

    return step, init


def lora_fine_tune(model: ConvertedModel, feeds_iter, rank: int = 8,
                   optimizer=None, alpha: Optional[float] = None,
                   loss_fn: Optional[Callable] = None,
                   output: Optional[str] = None,
                   targets=None, seed: int = 0,
                   steps: Optional[int] = None, device=None):
    """The LoRA loop mirroring :func:`fine_tune`; returns
    ``(merged_params, lora, losses)``: serve ``merged_params`` (or just
    the adapted names) through ``ONNXModel.weights_override``."""
    if optimizer is None:
        optimizer = adam(1e-3)
    dev = resolve_device(device)
    lora = init_lora(model, rank, targets=targets, seed=seed, device=dev)
    step, init = make_lora_train_step(model, optimizer, alpha=alpha,
                                      loss_fn=loss_fn, output=output,
                                      device=dev)
    base = {k: _tensor(v, dev) for k, v in model.params.items()}
    state = init(lora)
    lora = state.leaves
    losses = []
    for i, feeds in enumerate(feeds_iter):
        if steps is not None and i >= steps:
            break
        lora, state, val = step(base, lora, state, feeds)
        losses.append(float(val))
    scale = rank if alpha is None else alpha
    with torch.no_grad():
        merged = lora_merge(base, lora, scale)
    return merged, {k: {n: t.detach() for n, t in ab.items()}
                    for k, ab in lora.items()}, losses

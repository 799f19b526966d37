"""ai.onnx.ml domain: the sklearn / LightGBM interchange operators
(counterpart of ``mmlspark_tpu/onnx/ml_ops.py``).

A trained booster exported by ``models/gbdt/onnx_export.py``
(``TreeEnsembleClassifier`` / ``TreeEnsembleRegressor``) and skl2onnx's
preprocessing and linear models (``Scaler``, ``Imputer``, ``Normalizer``,
``LinearClassifier``, the SVMs, ...) run here as PyTorch ops on the device
of their feeds, with the JAX handlers' semantics and refusals.

The tree walk is the reference's: the node attributes are parsed on the
host into padded ``(T, max_nodes)`` tables, and every (row, tree) pair
descends one level per step with leaves looping on themselves, so a
forest costs ``max_depth`` batched gathers. The tables are parsed and
placed on a device once per converted node (:func:`_node_constants`),
never once a batch.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .convert import UnsupportedOp, _as_tensor, register_op

_ML = "ai.onnx.ml"

_MODES = {"BRANCH_LEQ": 0, "BRANCH_LT": 1, "BRANCH_GTE": 2, "BRANCH_GT": 3,
          "BRANCH_EQ": 4, "BRANCH_NEQ": 5, "LEAF": 6}


def _require_ml(node):
    if node.domain not in (_ML,):
        raise UnsupportedOp(f"{node.op_type} in domain {node.domain!r}")


def _node_constants(node, device: torch.device, build):
    """``build(device)`` once per (node, device): the node's attribute
    tables as tensors on ``device``, kept on the node of the converted
    model so later batches reuse them."""
    cache = node.__dict__.setdefault("_ml_constants", {})
    key = str(device)
    if key not in cache:
        cache[key] = build(device)
    return cache[key]


def _rows_f32(x, ctx) -> torch.Tensor:
    X = _as_tensor(x, ctx).to(torch.float32)
    return X[None, :] if X.dim() == 1 else X


def _on(device, a, dtype=None) -> torch.Tensor:
    t = torch.from_numpy(np.ascontiguousarray(a))
    return t.to(device=device, dtype=dtype or t.dtype)


# -- tree ensembles ----------------------------------------------------------

def _parse_tree_tables(node):
    """Static node attributes -> padded (T, M) numpy tables + max depth."""
    tids = np.asarray(node.attr("nodes_treeids"), np.int64)
    nids = np.asarray(node.attr("nodes_nodeids"), np.int64)
    feats = np.asarray(node.attr("nodes_featureids"), np.int64)
    vals = np.asarray(node.attr("nodes_values"), np.float32)
    modes = np.asarray([_MODES[m] for m in node.attr("nodes_modes")],
                       np.int32)
    trues = np.asarray(node.attr("nodes_truenodeids"), np.int64)
    falses = np.asarray(node.attr("nodes_falsenodeids"), np.int64)
    miss = node.attr("nodes_missing_value_tracks_true")
    miss = (np.asarray(miss, np.int32) if miss
            else np.zeros(len(nids), np.int32))

    trees = sorted(set(int(t) for t in tids))
    tree_index = {t: i for i, t in enumerate(trees)}
    T = len(trees)
    M = int(nids.max()) + 1 if len(nids) else 1

    feat = np.zeros((T, M), np.int64)
    val = np.zeros((T, M), np.float32)
    mode = np.full((T, M), _MODES["LEAF"], np.int32)
    tnext = np.tile(np.arange(M, dtype=np.int64), (T, 1))
    fnext = np.tile(np.arange(M, dtype=np.int64), (T, 1))
    mtrue = np.zeros((T, M), np.int32)
    for i in range(len(nids)):
        t, n = tree_index[int(tids[i])], int(nids[i])
        feat[t, n] = feats[i]
        val[t, n] = vals[i]
        mode[t, n] = modes[i]
        mtrue[t, n] = miss[i]
        if modes[i] != _MODES["LEAF"]:
            tnext[t, n] = trues[i]
            fnext[t, n] = falses[i]
        # leaves keep the self-loop defaults

    # longest root -> leaf path (BFS per tree); cycle-guarded by the node
    # count
    max_depth = 1
    for t in range(T):
        depth = np.full(M, -1, np.int64)
        depth[0] = 0
        frontier = [0]
        steps = 0
        while frontier and steps <= M:
            steps += 1
            nxt = []
            for n in frontier:
                if mode[t, n] == _MODES["LEAF"]:
                    continue
                for c in (int(tnext[t, n]), int(fnext[t, n])):
                    if depth[c] == -1:
                        depth[c] = depth[n] + 1
                        nxt.append(c)
            frontier = nxt
        max_depth = max(max_depth, int(depth.max()) + 1)
    return tree_index, (feat, val, mode, tnext, fnext, mtrue), max_depth


def _walk_trees(X, tables, max_depth):
    """(N, F) rows x (T, M) node tables (device tensors, flattened to
    (T * M,)) -> (N, T) leaf node indices, int64."""
    feat, val, mode, tnext, fnext, mtrue, M = tables
    N, F = X.shape
    T = feat.numel() // M
    base = torch.arange(T, device=X.device, dtype=torch.int64) * M
    idx = torch.zeros((N, T), dtype=torch.int64, device=X.device)
    for _ in range(max_depth):
        at = base + idx                                # (N, T) flat node
        nv = val[at]
        nm = mode[at]
        x = X.gather(1, feat[at].clamp(0, F - 1))
        cond = torch.where(
            nm == 0, x <= nv, torch.where(
                nm == 1, x < nv, torch.where(
                    nm == 2, x >= nv, torch.where(
                        nm == 3, x > nv, torch.where(
                            nm == 4, x == nv, x != nv)))))
        cond = torch.where(torch.isnan(x), mtrue[at] > 0, cond)
        idx = torch.where(cond, tnext[at], fnext[at])
    return idx


def _leaf_weight_table(node, tree_index, M, n_out, prefix,
                       collapse_ids=False):
    """(T, M, n_out) dense weights from the class_* / target_* attributes.
    ``collapse_ids``: the binary single-class form, where every entry
    scores the one output column whatever its class id."""
    tids = np.asarray(node.attr(f"{prefix}_treeids"), np.int64)
    nids = np.asarray(node.attr(f"{prefix}_nodeids"), np.int64)
    outs = np.asarray(node.attr(f"{prefix}_ids"), np.int64)
    ws = np.asarray(node.attr(f"{prefix}_weights"), np.float32)
    W = np.zeros((len(tree_index), M, n_out), np.float32)
    for i in range(len(tids)):
        col = 0 if collapse_ids else int(outs[i])
        # += not =: a leaf may carry several entries for the same output
        W[tree_index[int(tids[i])], int(nids[i]), col] += ws[i]
    return W


def _post_transform(scores, kind):
    if kind in (None, "", "NONE"):
        return scores
    if kind == "SOFTMAX":
        return torch.softmax(scores, dim=-1)
    if kind == "LOGISTIC":
        return torch.sigmoid(scores)
    if kind == "SOFTMAX_ZERO":
        # softmax over the nonzero entries only (spec): zero logits keep
        # probability zero
        nz = scores != 0.0
        top = torch.where(nz, scores, -torch.inf).amax(dim=-1, keepdim=True)
        e = torch.where(nz, torch.exp(scores - top), 0.0)
        return e / e.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    if kind == "PROBIT":
        return 0.5 * (1.0 + torch.erf(scores / math.sqrt(2.0)))
    raise UnsupportedOp(f"post_transform {kind!r}")


def _ensemble(node, prefix, n_out, collapse_ids=False):
    """The ``build`` for :func:`_node_constants`: the node's walk tables, leaf
    weights and base values, parsed on the host when first needed."""
    def build(device):
        tree_index, tables, max_depth = _parse_tree_tables(node)
        M = tables[0].shape[1]
        W = _leaf_weight_table(node, tree_index, M, n_out, prefix,
                               collapse_ids=collapse_ids)
        base = np.asarray(node.attr("base_values") or [0.0] * n_out,
                          np.float32)
        flat = tuple(_on(device, a.reshape(-1)) for a in tables)
        return dict(tables=flat + (M,), depth=max_depth,
                    W=_on(device, W.reshape(-1, n_out)), M=M,
                    base=_on(device, base))
    return build


def _leaf_contrib(c, leaf):
    """(N, T, n_out) weights of the leaves each row reached."""
    T = leaf.shape[1]
    at = torch.arange(T, device=leaf.device, dtype=torch.int64) * c["M"]
    return c["W"][at + leaf]


@register_op("TreeEnsembleClassifier")
def _tree_classifier(node, inputs, ctx):
    _require_ml(node)
    labels = node.attr("classlabels_int64s")
    if labels is None:
        raise UnsupportedOp("TreeEnsembleClassifier with string class "
                            "labels (int64 labels only under jit)")
    labels = np.asarray(labels, np.int64)
    C = len(labels)
    class_ids = set(int(c) for c in node.attr("class_ids"))
    binary_single = C == 2 and len(class_ids) == 1
    n_out = 1 if binary_single else C
    post = node.attr("post_transform", "NONE")

    X = _rows_f32(inputs[0], ctx)

    def build(device):
        c = _ensemble(node, "class", n_out, collapse_ids=binary_single)(
            device)
        c["labels"] = _on(device, labels)
        return c
    c = _node_constants(node, X.device, build)
    leaf = _walk_trees(X, c["tables"], c["depth"])          # (N, T)
    scores = _leaf_contrib(c, leaf).sum(dim=1) + c["base"]  # (N, n_out)
    if binary_single:
        s = scores[:, 0]
        if post == "LOGISTIC":
            p1 = torch.sigmoid(s)
            scores = torch.stack([1.0 - p1, p1], dim=-1)
        elif post in (None, "", "NONE"):
            # sklearn forest exports carry leaf PROBABILITIES for class 1
            scores = torch.stack([1.0 - s, s], dim=-1)
        else:
            raise UnsupportedOp(
                f"binary single-class TreeEnsemble with {post}")
    else:
        scores = _post_transform(scores, post)
    pred = c["labels"][torch.argmax(scores, dim=-1)]
    return pred, scores


@register_op("TreeEnsembleRegressor")
def _tree_regressor(node, inputs, ctx):
    _require_ml(node)
    n_out = int(node.attr("n_targets", 1))
    agg = node.attr("aggregate_function", "SUM")
    if agg not in ("SUM", "AVERAGE", "MIN", "MAX"):
        raise UnsupportedOp(f"aggregate_function {agg!r}")
    X = _rows_f32(inputs[0], ctx)
    c = _node_constants(node, X.device, _ensemble(node, "target", n_out))
    leaf = _walk_trees(X, c["tables"], c["depth"])
    contrib = _leaf_contrib(c, leaf)                        # (N, T, n_out)
    if agg == "SUM":
        scores = contrib.sum(dim=1)
    elif agg == "AVERAGE":
        scores = contrib.mean(dim=1)
    elif agg == "MIN":
        scores = contrib.amin(dim=1)
    else:
        scores = contrib.amax(dim=1)
    scores = scores + c["base"]
    return _post_transform(scores, node.attr("post_transform", "NONE"))


# -- linear / preprocessing --------------------------------------------------

@register_op("LinearClassifier")
def _linear_classifier(node, inputs, ctx):
    _require_ml(node)
    labels = node.attr("classlabels_ints")
    if labels is None:
        raise UnsupportedOp("LinearClassifier with string class labels")
    labels = np.asarray(labels, np.int64)
    C = len(labels)
    # row count comes from the intercepts (skl2onnx emits one per score
    # row); a single row with two labels is the binary-one form
    inter = np.asarray(node.attr("intercepts") or [0.0], np.float32)
    rows = len(inter)
    coef = np.asarray(node.attr("coefficients"), np.float32).reshape(rows, -1)
    post = node.attr("post_transform", "NONE")
    X = _rows_f32(inputs[0], ctx)
    c = _node_constants(node, X.device, lambda d: dict(
        coef=_on(d, coef), inter=_on(d, inter), labels=_on(d, labels)))
    s = X @ c["coef"].T + c["inter"]
    if rows == 1 and C == 2:
        p1 = torch.sigmoid(s[:, 0]) if post == "LOGISTIC" else s[:, 0]
        scores = torch.stack([1.0 - p1, p1], dim=-1)
    else:
        scores = _post_transform(s, post)
    pred = c["labels"][torch.argmax(scores, dim=-1)]
    return pred, scores


@register_op("LinearRegressor")
def _linear_regressor(node, inputs, ctx):
    _require_ml(node)
    n = int(node.attr("targets", 1))
    coef = np.asarray(node.attr("coefficients"), np.float32).reshape(n, -1)
    inter = np.asarray(node.attr("intercepts") or [0.0] * n, np.float32)
    X = _rows_f32(inputs[0], ctx)
    c = _node_constants(node, X.device, lambda d: dict(
        coef=_on(d, coef), inter=_on(d, inter)))
    return _post_transform(X @ c["coef"].T + c["inter"],
                           node.attr("post_transform", "NONE"))


@register_op("Scaler")
def _scaler(node, inputs, ctx):
    _require_ml(node)
    x = _as_tensor(inputs[0], ctx).to(torch.float32)
    off = np.asarray(node.attr("offset") or [0.0], np.float32)
    sc = np.asarray(node.attr("scale") or [1.0], np.float32)
    c = _node_constants(node, x.device, lambda d: (_on(d, off), _on(d, sc)))
    return (x - c[0]) * c[1]


@register_op("Normalizer")
def _normalizer(node, inputs, ctx):
    _require_ml(node)
    norm = node.attr("norm", "MAX")
    x = _as_tensor(inputs[0], ctx).to(torch.float32)
    if norm == "MAX":
        d = x.abs().amax(dim=-1, keepdim=True)
    elif norm == "L1":
        d = x.abs().sum(dim=-1, keepdim=True)
    elif norm == "L2":
        d = torch.sqrt((x * x).sum(dim=-1, keepdim=True))
    else:
        raise UnsupportedOp(f"Normalizer norm {norm!r}")
    return x / d.clamp_min(1e-30)


@register_op("Imputer")
def _imputer(node, inputs, ctx):
    _require_ml(node)
    x = _as_tensor(inputs[0], ctx)
    if x.is_floating_point():
        fill = np.asarray(node.attr("imputed_value_floats"), np.float32)
        missing = node.attr("replaced_value_float", float("nan"))
        hit = (torch.isnan(x) if np.isnan(missing)
               else x == np.float32(missing).item())
    else:
        fill = np.asarray(node.attr("imputed_value_int64s"), np.int64)
        hit = x == node.attr("replaced_value_int64", 0)
    fill = _on(x.device, fill if fill.size > 1 else fill.reshape(()))
    return torch.where(hit, fill.to(torch.promote_types(fill.dtype, x.dtype)),
                       x)


@register_op("Binarizer")
def _binarizer(node, inputs, ctx):
    _require_ml(node)
    x = _as_tensor(inputs[0], ctx)
    thr = torch.tensor(node.attr("threshold", 0.0), dtype=x.dtype,
                       device=x.device)
    return (x > thr).to(x.dtype)


@register_op("ArrayFeatureExtractor")
def _array_feature_extractor(node, inputs, ctx):
    _require_ml(node)
    x = _as_tensor(inputs[0], ctx)
    idx = _as_tensor(inputs[1], ctx, torch.int64).reshape(-1)
    return x.index_select(-1, idx.to(x.device))


@register_op("FeatureVectorizer")
def _feature_vectorizer(node, inputs, ctx):
    _require_ml(node)
    cols = [_as_tensor(x, ctx).to(torch.float32) for x in inputs
            if x is not None]
    cols = [c[:, None] if c.dim() == 1 else c for c in cols]
    return torch.cat(cols, dim=-1)


@register_op("LabelEncoder")
def _label_encoder(node, inputs, ctx):
    _require_ml(node)
    x = _as_tensor(inputs[0], ctx)
    for kk, vk in (("keys_int64s", "values_int64s"),
                   ("keys_int64s", "values_floats"),
                   ("keys_floats", "values_int64s"),
                   ("keys_floats", "values_floats")):
        keys, vals = node.attr(kk), node.attr(vk)
        if keys is not None and vals is not None:
            break
    else:
        raise UnsupportedOp("LabelEncoder with string keys/values "
                            "(jit-incompatible)")
    # float attributes are float32 values (the reference's 64-bit types
    # are off)
    keys = np.asarray(keys, np.float32 if kk == "keys_floats" else np.int64)
    vals = np.asarray(vals, np.float32 if vk == "values_floats"
                      else np.int64)
    default = node.attr(
        "default_int64" if vals.dtype.kind == "i" else "default_float",
        -1 if vals.dtype.kind == "i" else -0.0)
    c = _node_constants(node, x.device, lambda d: (_on(d, keys),
                                                   _on(d, vals)))
    hit = x[..., None] == c[0]                              # (..., K)
    found = hit.any(dim=-1)
    picked = (hit.to(c[1].dtype) * c[1]).sum(dim=-1)
    return torch.where(found, picked,
                       torch.tensor(default, dtype=picked.dtype,
                                    device=picked.device))


@register_op("ZipMap")
def _zipmap(node, inputs, ctx):
    # ZipMap decorates probabilities into per-row dicts for python callers;
    # the tensor is the useful output, so it passes through (the label keys
    # stay in the node's attributes for a host-side consumer)
    _require_ml(node)
    return _as_tensor(inputs[0], ctx)


# -- SVMs (skl2onnx SVC / SVR) -----------------------------------------------

def _svm_kernel(X, SV, kind, params):
    """(N, F) x (M, F) kernel matrix. ``params`` = [gamma, coef0, degree]
    (the attribute order skl2onnx emits)."""
    gamma, coef0, degree = (list(params) + [0.0, 0.0, 3.0])[:3]
    if kind == "LINEAR":
        return X @ SV.T
    if kind == "POLY":
        return (gamma * (X @ SV.T) + coef0) ** int(degree)
    if kind == "RBF":
        d2 = ((X * X).sum(dim=1)[:, None] - 2.0 * (X @ SV.T)
              + (SV * SV).sum(dim=1)[None, :])
        return torch.exp(-gamma * d2)
    if kind == "SIGMOID":
        return torch.tanh(gamma * (X @ SV.T) + coef0)
    raise UnsupportedOp(f"SVM kernel {kind!r}")


@register_op("SVMRegressor")
def _svm_regressor(node, inputs, ctx):
    _require_ml(node)
    if node.attr("one_class", 0):
        raise UnsupportedOp("SVMRegressor one_class (OneClassSVM ±1 "
                            "labeling semantics)")
    coefs = np.asarray(node.attr("coefficients"), np.float32)
    sv = np.asarray(node.attr("support_vectors"), np.float32)
    rho = np.asarray(node.attr("rho") or [0.0], np.float32)
    kind = node.attr("kernel_type", "LINEAR")
    params = node.attr("kernel_params") or []
    X = _rows_f32(inputs[0], ctx)
    M = len(coefs)
    c = _node_constants(node, X.device, lambda d: (
        _on(d, sv.reshape(M, -1)), _on(d, coefs)))
    K = _svm_kernel(X, c[0], kind, params)                  # (N, M)
    out = K @ c[1] + rho[0].item()
    return _post_transform(out[:, None],
                           node.attr("post_transform", "NONE"))


@register_op("SVMClassifier")
def _svm_classifier(node, inputs, ctx):
    """libsvm-style one-vs-one voting (the skl2onnx SVC export): decision
    values for each class pair from the dual coefficients, labels by
    majority vote with the decision sums breaking ties
    (``votes + sigmoid(sums) * 0.5``), as onnxruntime does without Platt
    calibration."""
    _require_ml(node)
    if node.attr("prob_a"):
        raise UnsupportedOp("SVMClassifier with Platt scaling (prob_a/b)")
    labels = node.attr("classlabels_ints")
    if labels is None:
        raise UnsupportedOp("SVMClassifier with string class labels")
    labels = np.asarray(labels, np.int64)
    C = len(labels)
    vpc = np.asarray(node.attr("vectors_per_class"), np.int64)
    sv = np.asarray(node.attr("support_vectors"), np.float32)
    coefs = np.asarray(node.attr("coefficients"), np.float32)
    rho = np.asarray(node.attr("rho"), np.float32)
    kind = node.attr("kernel_type", "LINEAR")
    params = node.attr("kernel_params") or []
    M = int(vpc.sum())
    starts = np.r_[0, np.cumsum(vpc)]

    X = _rows_f32(inputs[0], ctx)
    c = _node_constants(node, X.device, lambda d: dict(
        SV=_on(d, sv.reshape(M, -1)),
        A=_on(d, coefs.reshape(C - 1, M)),     # dual coefs, libsvm layout
        rho=_on(d, rho), labels=_on(d, labels)))
    K = _svm_kernel(X, c["SV"], kind, params)               # (N, M)
    A = c["A"]

    N = X.shape[0]
    votes = torch.zeros((N, C), dtype=torch.float32, device=X.device)
    sums = torch.zeros((N, C), dtype=torch.float32, device=X.device)
    decisions = []
    p = 0
    for i in range(C):
        for j in range(i + 1, C):
            si = slice(int(starts[i]), int(starts[i + 1]))
            sj = slice(int(starts[j]), int(starts[j + 1]))
            # + rho: skl2onnx stores sklearn's intercept_ in rho (decision
            # = dual sum + intercept), same sign as SVMRegressor above
            dec = K[:, si] @ A[j - 1, si] + K[:, sj] @ A[i, sj] + c["rho"][p]
            decisions.append(dec)
            win_i = (dec > 0).to(torch.float32)
            votes[:, i] += win_i
            votes[:, j] += 1.0 - win_i
            sums[:, i] += dec
            sums[:, j] -= dec
            p += 1
    scores = torch.stack(decisions, dim=1) if decisions else sums
    # majority vote, ties broken by the accumulated decision sums
    rank = votes + torch.sigmoid(sums) * 0.5
    pred = c["labels"][torch.argmax(rank, dim=-1)]
    return pred, _post_transform(scores, node.attr("post_transform", "NONE"))


# -- core-domain stragglers found next to ml graphs --------------------------

@register_op("Hardmax")
def _hardmax(node, inputs, ctx):
    x = _as_tensor(inputs[0], ctx)
    axis = node.attr("axis", -1 if ctx.opset >= 13 else 1)
    # the first maximal index, as jnp.argmax
    idx = torch.argmax(x, dim=axis, keepdim=True)
    return torch.zeros_like(x).scatter_(axis, idx, 1)


@register_op("ScatterElements")
def _scatter_elements(node, inputs, ctx):
    data = _as_tensor(inputs[0], ctx)
    idx = _as_tensor(inputs[1], ctx, torch.int64).to(data.device)
    upd = _as_tensor(inputs[2], ctx, data.dtype).to(data.device)
    axis = node.attr("axis", 0)
    reduction = node.attr("reduction", "none")
    idx = torch.where(idx < 0, idx + data.shape[axis], idx)
    if reduction == "none":
        # repeated indices are undefined in ONNX (and the winner
        # nondeterministic on CUDA)
        return data.clone().scatter_(axis, idx, upd)
    if reduction == "add":
        return data.clone().scatter_add_(axis, idx, upd)
    if reduction in ("mul", "max", "min"):
        return data.clone().scatter_reduce_(
            axis, idx, upd, {"mul": "prod", "max": "amax",
                             "min": "amin"}[reduction], include_self=True)
    raise UnsupportedOp(f"ScatterElements reduction {reduction!r}")

"""GBDT boosting loop (counterpart of ``models/gbdt/train.py``, single
device).

The bins live on the device (feature-major, ``ops/histogram.py``) for the
whole run; gradients, the tree build (K6 per level) and the score update
run there between iterations. On the fused path (no ``valid_sets``, no
``callbacks``) the loop never reads a device value: each iteration's tree
arrays stay on the device in ``pending`` and are materialized in chunks
after the loop, so iterations queue back to back on the card. The general
path materializes each tree for eval, early stopping and callbacks.

Multiclass (``objective="multiclass"``, ``num_class`` K >= 2) grows K
trees an iteration, one per class, together: scores are (n, K), the
gradients (K, n), and every level's K histograms come from one K6 launch
(``trees.build_tree``). Trees are appended class-major, each with its
leaf values in row k of a (K, 2^depth) array, as the JAX package stores
them, so model strings load across the two packages.

A warm start (``init_model``) continues a booster: its raw scores on X,
less its base score, start the loop on the device (computed there from X
in chunks) and the new trees append to a copy of it. ``init_score`` starts
the loop from a per-row margin, (n,) or (n, K), with ``base_score`` 0;
the model's predictions exclude that margin, as LightGBM's do.

Ported: ``boosting="gbdt"``, dense X, ``tree_learner="serial"``, the
regression-family, binary and multiclass objectives, sample weights,
``scale_pos_weight`` / ``is_unbalance``, ``boost_from_average``,
``bagging_fraction`` / ``bagging_freq``, ``feature_fraction``,
``use_quantized_grad``, ``init_model`` and ``init_score``. Every other
mode raises ``NotImplementedError`` naming its ROADMAP leftover.
"""

from __future__ import annotations

import math
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ...utils.device import resolve_device
from ...ops.histogram import prepare_bins_columns
from .binning import BinMapper, is_sparse
from .booster import Booster, _leftover
from .objectives import get_metric, get_objective
from .trees import build_tree, map_rows, predict_trees

__all__ = ["train", "TrainConfig", "resolve_params", "bins_on_device"]

_DEFAULTS = dict(
    objective="regression",
    boosting="gbdt",                # gbdt | goss | dart | rf
    top_rate=0.2,                   # goss: keep fraction by |grad|
    other_rate=0.1,                 # goss: sample fraction of the rest
    drop_rate=0.1,                  # dart: per-tree drop probability
    max_drop=50,                    # dart: cap on dropped trees per iter
    skip_drop=0.5,                  # dart: prob of skipping the drop entirely
    num_iterations=100,
    learning_rate=0.1,
    num_leaves=31,
    max_depth=-1,
    lambda_l1=0.0,
    lambda_l2=0.0,
    min_data_in_leaf=20,
    min_sum_hessian_in_leaf=1e-3,
    min_gain_to_split=0.0,
    feature_fraction=1.0,
    bagging_fraction=1.0,
    bagging_freq=0,
    max_bin=255,
    early_stopping_round=0,
    num_class=1,
    seed=0,
    metric="auto",
    tree_learner="serial",
    top_k=20,                       # voting_parallel: local nominations/node
    alpha=0.9,                      # huber/quantile parameter
    tweedie_variance_power=1.5,
    verbosity=-1,
    checkpoint_dir=None,            # step-level checkpoint/resume
    checkpoint_interval=0,          # iterations between checkpoints (0 = off)
    categorical_feature=None,       # feature indices with categorical splits
    enable_bundle=True,             # EFB on sparse input (LightGBM name)
    max_conflict_rate=0.0,          # EFB conflict budget as a row fraction
    max_bundle_bins=4096,           # cap on one bundle's bin span
    monotone_constraints=None,      # per-feature -1/0/+1 (LightGBM name)
    scale_pos_weight=1.0,           # binary: positive-class weight multiplier
    is_unbalance=False,             # binary: auto scale_pos_weight = neg/pos
    extra_trees=False,              # one random threshold per node x feature
    feature_fraction_bynode=1.0,    # feature subsample per NODE (not tree)
    path_smooth=0.0,                # smooth node outputs toward the parent
    boost_from_average=True,        # start from the objective's optimal const
    interaction_constraints=None,   # list of allowed feature groups
    cat_smooth=10.0,                # categorical: mean smoothing pseudo-count
    min_data_per_group=0,           # categorical: pool rarer categories
    linear_tree=False,              # ridge model per leaf over path features
    linear_lambda=0.0,              # L2 on linear-leaf weights (not bias)
    use_quantized_grad=False,       # bf16 histogram stats (LightGBM's
    #                                 quantized-gradient analog)
)

#: rows binned and uploaded per chunk (the host never holds all the bins)
_BIN_CHUNK = 1 << 21
#: trees stacked per host transfer when the deferred arrays materialize
_MATERIALIZE_CHUNK = 64


def resolve_params(params: Dict) -> Dict:
    aliases = {"n_estimators": "num_iterations", "num_trees": "num_iterations",
               "num_round": "num_iterations", "eta": "learning_rate",
               "reg_alpha": "lambda_l1", "reg_lambda": "lambda_l2",
               "min_child_samples": "min_data_in_leaf",
               "min_child_weight": "min_sum_hessian_in_leaf",
               "subsample": "bagging_fraction", "subsample_freq": "bagging_freq",
               "colsample_bytree": "feature_fraction",
               "min_split_gain": "min_gain_to_split",
               "random_state": "seed",
               "application": "objective", "app": "objective",
               "boosting_type": "boosting", "boost": "boosting",
               "topK": "top_k",
               "parallelism": "tree_learner"}
    out = dict(_DEFAULTS)
    for k, v in params.items():
        out[aliases.get(k, k)] = v
    return out


def _depth_for(p: Dict) -> int:
    if p["max_depth"] and p["max_depth"] > 0:
        return int(p["max_depth"])
    # complete tree with num_leaves leaves at the bottom
    return max(1, int(math.ceil(math.log2(max(2, int(p["num_leaves"]))))))


def _thr_bins_to_raw(feats: np.ndarray, thr_bin: np.ndarray,
                     mapper: BinMapper, n_bins: int) -> np.ndarray:
    """Map split bins -> raw thresholds ("x <= thr" == "bin <= thr_bin"),
    vectorized over (tree, node) via the mapper's padded bounds table."""
    table, lengths = mapper.bounds_table()
    out = np.full(thr_bin.shape, np.inf, dtype=np.float32)
    valid = (feats >= 0) & (thr_bin < n_bins)
    f = np.clip(feats, 0, table.shape[0] - 1).astype(np.int64)
    i = np.clip(thr_bin.astype(np.int64) - 1, 0, np.maximum(lengths[f] - 1, 0))
    vals = table[f, i].astype(np.float32)
    out[valid] = vals[valid]
    return out


class TrainConfig:
    def __init__(self, params: Dict, n_features: int):
        self.p = resolve_params(params)
        self.depth = _depth_for(self.p)
        self.n_features = n_features


def _reject_unported(p: Dict, X, group, mesh) -> None:
    """Raise NotImplementedError for every mode outside this slice."""
    boosting = {"gbrt": "gbdt", "random_forest": "rf"}.get(
        str(p["boosting"]).lower(), str(p["boosting"]).lower())
    if boosting in ("goss", "dart", "rf"):
        raise _leftover(f"boosting={boosting!r} (goss, rf and dart)", 14)
    if boosting != "gbdt":
        raise ValueError(f"boosting must be gbdt/goss/dart/rf, got {boosting!r}")
    if p["objective"] == "lambdarank" or group is not None:
        raise _leftover("lambdarank")
    if mesh is not None or p["tree_learner"] != "serial":
        raise _leftover(f"tree_learner={p['tree_learner']!r} / mesh= "
                        f"(data- and voting-parallel training, slice 6)", 31)
    if is_sparse(X):
        raise _leftover("sparse input with EFB bundling", 18)
    if p["linear_tree"]:
        raise _leftover("linear_tree", 19)
    if p["categorical_feature"]:
        raise _leftover("categorical_feature", 17)
    mc = p["monotone_constraints"]
    if mc is not None and np.asarray(mc).size and np.asarray(mc).any():
        raise _leftover("monotone_constraints", 16)
    if float(p["path_smooth"]) != 0.0:
        raise _leftover("path_smooth", 16)
    if p["interaction_constraints"]:
        raise _leftover("interaction_constraints", 16)
    if p["extra_trees"]:
        raise _leftover("extra_trees")
    if float(p["feature_fraction_bynode"]) != 1.0:
        raise _leftover("feature_fraction_bynode")
    if p["checkpoint_dir"]:
        raise _leftover("step checkpoints (checkpoint_dir, with "
                        "utils/checkpoint.py)", 24, "slice 5: the periphery")


def _to_device(a: np.ndarray, dev: torch.device, dtype) -> torch.Tensor:
    """A host array on the device, without stalling the stream: CUDA
    copies go from pinned memory, asynchronously."""
    t = torch.from_numpy(np.ascontiguousarray(a)).to(dtype)
    if dev.type == "cuda":
        return t.pin_memory().to(dev, non_blocking=True)
    return t


def _class_rows(leaf: np.ndarray, K: int) -> np.ndarray:
    """(T, 2^D) leaf values of class-major trees (tree t of class t % K)
    -> (T, K, 2^D), each tree's values in row t % K and zeros elsewhere:
    how a multiclass booster stores a tree."""
    out = np.zeros((leaf.shape[0], K, leaf.shape[1]), dtype=leaf.dtype)
    t = np.arange(leaf.shape[0])
    out[t, t % K] = leaf
    return out


def _host_trees(feats, thr_bin, leaf, gains, covers, mapper: BinMapper,
                n_bins: int, is_multi: bool) -> List[Tuple]:
    """One iteration's trees as the booster stores them, (feat, thr_raw,
    leaf_value, gain, cover) each: one tree, or K trees class-major for
    (K, ...) multiclass arrays."""
    thr_raw = _thr_bins_to_raw(feats, thr_bin, mapper, n_bins)
    if not is_multi:
        return [(feats, thr_raw, leaf, gains, covers)]
    return list(zip(feats, thr_raw, _class_rows(leaf, len(leaf)), gains,
                    covers))


def bins_on_device(mapper: BinMapper, X: np.ndarray, device):
    """X binned by ``mapper`` on the host, one chunk of rows at a time (the
    host never holds all the bins), into the (F, n) device layout K6
    reads. Returns (bins_cols, host transform seconds, upload seconds)."""
    dev = torch.device(device)
    n, F = X.shape
    dt = torch.uint8 if mapper.n_bins <= 256 else torch.int16
    bins_cols = torch.empty((F, n), dtype=dt, device=dev)
    transform_s = upload_s = 0.0
    for lo in range(0, n, _BIN_CHUNK):
        t0 = time.perf_counter()
        part = mapper.transform(X[lo:lo + _BIN_CHUNK])
        t1 = time.perf_counter()
        bins_cols[:, lo:lo + len(part)] = prepare_bins_columns(part, dev)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        transform_s += t1 - t0
        upload_s += time.perf_counter() - t1
    return bins_cols, transform_s, upload_s


def train(params: Dict,
          X: np.ndarray, y: np.ndarray,
          sample_weight: Optional[np.ndarray] = None,
          group: Optional[np.ndarray] = None,
          valid_sets: Optional[List[Tuple[np.ndarray, np.ndarray]]] = None,
          init_model: Optional[Booster] = None,
          mesh=None,
          callbacks: Optional[List[Callable]] = None,
          eval_log: Optional[List] = None,
          init_score: Optional[np.ndarray] = None,
          valid_init_scores: Optional[List[np.ndarray]] = None,
          valid_weights: Optional[List[np.ndarray]] = None, *,
          device=None) -> Booster:
    """Fit a GBDT on ``device`` (CUDA when None; raises without a card).
    ``params`` uses LightGBM names (aliases accepted). ``valid_weights``:
    per-set sample weights for eval metrics. The returned booster
    predicts on the same device and carries ``phase_seconds``."""
    p = resolve_params(params)
    if init_model is not None and init_score is not None:
        raise ValueError("init_score cannot combine with a warm-start "
                         "model (the model already defines the margin)")
    if init_model is not None \
            and getattr(init_model, "is_linear", False) != bool(
                p["linear_tree"]):
        raise ValueError("warm start must keep the leaf model family: "
                         "set linear_tree to match the init model")
    _reject_unported(p, X, group, mesh)
    dev = resolve_device(device)
    X = np.asarray(X)
    if X.dtype.kind != "f":
        X = X.astype(np.float64)
    y = np.asarray(y, dtype=np.float64)
    n, F = X.shape
    w = (np.asarray(sample_weight, dtype=np.float64) if sample_weight is not None
         else np.ones(n))
    depth = _depth_for(p)
    objective_name = p["objective"]
    num_class = int(p["num_class"])
    is_multi = objective_name in ("multiclass", "softmax")
    if is_multi and num_class < 2:
        raise ValueError(f"the multiclass objective needs num_class >= 2, "
                         f"got {num_class}")
    K = num_class if is_multi else 1
    obj = get_objective(objective_name, num_class=num_class,
                        alpha=p["alpha"],
                        tweedie_variance_power=p["tweedie_variance_power"])

    # class-imbalance reweighting, folded into the sample weights so
    # gradients, hessians and boost-from-average all see it
    spw = float(p["scale_pos_weight"])
    if p["is_unbalance"] or spw != 1.0:
        if objective_name != "binary":
            raise ValueError("scale_pos_weight/is_unbalance apply to the "
                             "binary objective only")
        if p["is_unbalance"]:
            if spw != 1.0:
                raise ValueError("set either is_unbalance or "
                                 "scale_pos_weight, not both (LightGBM's "
                                 "own rule)")
            pos = float(np.sum(w * (y == 1)))
            neg = float(np.sum(w * (y != 1)))
            if pos <= 0.0:
                raise ValueError(
                    "is_unbalance: no positive examples (or zero positive "
                    "weight) — the auto ratio would be unbounded")
            spw = neg / pos
        w = w * np.where(y == 1, spw, 1.0)

    t0 = time.perf_counter()
    mapper = BinMapper(max_bin=int(p["max_bin"]), seed=int(p["seed"]))
    mapper.fit(X)
    n_bins = int(mapper.n_bins)
    phase = {"bin_fit": time.perf_counter() - t0}
    bins_cols, phase["bin_transform"], phase["upload"] = bins_on_device(
        mapper, X, dev)

    # device residency, all f32 (the reference runs with x64 off); scores
    # are the DELTA from base_score, re-added for the gradients
    t0 = time.perf_counter()
    init_trees = 0
    if init_model is not None:
        # the new trees append to a copy: the caller's model is left as
        # it was
        booster = init_model.truncated(init_model.num_trees)
        booster.device = dev
        base_score = booster.base_score
        init_trees = booster.num_trees
        scores = booster.raw_score_on_device(X) - torch.tensor(
            base_score, dtype=torch.float32, device=dev)
    else:
        if init_score is not None:
            # a per-row starting margin: boost-from-average is skipped and
            # predictions exclude the margin (LightGBM's semantics)
            init_arr = np.asarray(init_score, dtype=np.float64)
            want = (n, K) if is_multi else (n,)
            if init_arr.shape != want:
                raise ValueError(f"init_score shape {init_arr.shape} != "
                                 f"{want}")
            base_score = 0.0
            scores = _to_device(init_arr, dev, torch.float32)
        else:
            # boost_from_average: the first margin is the objective's
            # optimal constant; off (and multiclass) -> boosting starts
            # at 0
            base_score = obj.init_score(y, w) if p["boost_from_average"] \
                and not is_multi else 0.0
            scores = torch.zeros((n, K) if is_multi else n,
                                 dtype=torch.float32, device=dev)
        booster = Booster(depth, F, objective_name, base_score, K,
                          device=dev)
    y_d = torch.as_tensor(y, dtype=torch.float32).to(dev)
    w_d = torch.as_tensor(w, dtype=torch.float32).to(dev)
    live_d = torch.ones(n, dtype=torch.float32, device=dev)
    base32 = torch.tensor(base_score, dtype=torch.float32, device=dev)
    phase["upload"] += time.perf_counter() - t0
    init_iters = init_trees // K

    build_kwargs = dict(depth=depth, n_bins=n_bins,
                        lam=float(p["lambda_l2"]) + 1e-10,
                        alpha=float(p["lambda_l1"]),
                        min_gain=float(p["min_gain_to_split"]),
                        min_child_weight=float(p["min_sum_hessian_in_leaf"]),
                        min_data_in_leaf=float(p["min_data_in_leaf"]),
                        hist_dtype=(torch.bfloat16 if p["use_quantized_grad"]
                                    else None))
    booster.fit_params = {"learning_rate": float(p["learning_rate"]),
                          "lambda_l2": float(p["lambda_l2"])}
    lr = float(p["learning_rate"])
    rng = np.random.default_rng(int(p["seed"]))
    n_iter = max(0, int(p["num_iterations"]))

    # eval bookkeeping: every metric of the list is computed and logged;
    # early stopping follows the FIRST
    m_raw = p["metric"]
    metric_list = (list(m_raw) if isinstance(m_raw, (list, tuple))
                   else [m_raw])
    if not metric_list:
        metric_list = ["auto"]
    resolved = [get_metric(m if m not in ("auto", "") else "",
                           objective_name) for m in metric_list]
    metric_name, (metric_fn, higher_better) = resolved[0]
    best_score = -np.inf if higher_better else np.inf
    best_iter = 0
    patience = int(p["early_stopping_round"])
    valid_scores = None
    if valid_sets:
        if any(is_sparse(vx) for vx, _ in valid_sets):
            raise _leftover("sparse validation sets", 18)
        valid_sets = [(np.asarray(vx), vy) for vx, vy in valid_sets]
        if init_score is not None and valid_init_scores is None:
            raise ValueError(
                "init_score with valid_sets needs valid_init_scores "
                "(one margin array per validation set): eval at margin "
                "zero would select a wrong best_iteration")
        if init_trees:
            valid_scores = [booster.raw_score(vx).astype(np.float64)
                            for vx, _vy in valid_sets]
        else:
            valid_scores = [np.full((vx.shape[0], K) if is_multi
                                    else vx.shape[0], base_score,
                                    dtype=np.float64)
                            for vx, _vy in valid_sets]
        if valid_weights is not None:
            if len(valid_weights) != len(valid_sets):
                raise ValueError(
                    f"valid_weights has {len(valid_weights)} entries for "
                    f"{len(valid_sets)} valid_sets")
            valid_weights = [np.asarray(w_, dtype=np.float64)
                             for w_ in valid_weights]
            for vi, (w_, (vx_, _vy)) in enumerate(
                    zip(valid_weights, valid_sets)):
                if len(w_) != vx_.shape[0]:
                    raise ValueError(
                        f"valid_weights[{vi}] has {len(w_)} rows for a "
                        f"{vx_.shape[0]}-row validation set")
        if valid_init_scores is not None:
            if len(valid_init_scores) != len(valid_sets):
                raise ValueError(
                    f"valid_init_scores has {len(valid_init_scores)} "
                    f"entries for {len(valid_sets)} valid_sets")
            for vi, vis in enumerate(valid_init_scores):
                vis = np.asarray(vis, dtype=np.float64)
                if vis.shape != valid_scores[vi].shape:
                    raise ValueError(
                        f"valid_init_scores[{vi}] shape {vis.shape} != "
                        f"{valid_scores[vi].shape}")
                valid_scores[vi] = valid_scores[vi] + vis

    fmask_all = torch.ones(F, dtype=torch.bool, device=dev)

    def _bagging_masks(it):
        """(live_it, gh_w) for this iteration. Shared by both loop paths
        so the rng stream stays in lockstep with the reference's: a seed
        yields the same row subsets either way."""
        if p["bagging_freq"] and p["bagging_fraction"] < 1.0 \
                and it % int(p["bagging_freq"]) == 0:
            keep = rng.random(n) < float(p["bagging_fraction"])
            live_it = live_d * _to_device(keep, dev, torch.float32)
            return live_it, live_it
        return live_d, live_d

    def _feature_mask():
        """Per-tree feature subsample mask (same rng-lockstep contract)."""
        if float(p["feature_fraction"]) < 1.0:
            k = max(1, int(round(F * float(p["feature_fraction"]))))
            sel = rng.choice(F, size=k, replace=False)
            m = np.zeros(F, dtype=bool)
            m[sel] = True
            return _to_device(m, dev, torch.bool)
        return fmask_all

    # fused/deferred fast path: nothing in an iteration reads a device
    # value, so iterations queue back to back on the card
    defer = not valid_sets and not callbacks
    pending: List[Tuple] = []
    t_boost = time.perf_counter()
    for it in range(n_iter):
        live_it, gh_w = _bagging_masks(it)
        fmask = _feature_mask()
        g_d, h_d = obj.grad_hess(scores + base32, y_d, w_d)
        # gh_w is 0/1 per row (bagging); every row is live (no padding)
        if is_multi:        # (n, K) -> the (K, n) rows build_tree takes
            g_d = (g_d * gh_w[:, None]).T.contiguous()
            h_d = (h_d * gh_w[:, None]).T.contiguous()
        else:
            g_d, h_d = g_d * gh_w, h_d * gh_w
        feats, thr_bin, leaf_val, node_rel, gains, covers = build_tree(
            bins_cols, g_d, h_d, live_it, feature_mask=fmask, **build_kwargs)
        if is_multi:
            scores = scores + leaf_val.gather(
                1, node_rel.to(torch.int64)).T * lr
        else:
            scores = scores + leaf_val.index_select(0, node_rel) * lr
        if defer:
            pending.append((feats, thr_bin, leaf_val, gains, covers))
            continue
        trees = _host_trees(feats.cpu().numpy(), thr_bin.cpu().numpy(),
                            leaf_val.cpu().numpy() * lr, gains.cpu().numpy(),
                            covers.cpu().numpy(), mapper, n_bins, is_multi)
        for tree in trees:
            booster.append_tree(*tree)

        # eval + early stopping (this iteration's trees only)
        if valid_sets:
            new_f, new_t, new_l = (torch.as_tensor(np.stack(
                [t[i] for t in trees])).to(dev) for i in range(3))
            results = []
            per_set_log = (eval_log is not None
                           and (len(resolved) > 1 or len(valid_sets) > 1))
            for vi, (vx, vy) in enumerate(valid_sets):
                valid_scores[vi] = valid_scores[vi] + map_rows(
                    lambda xd: predict_trees(new_f, new_t, new_l, xd, depth),
                    vx, dev).cpu().numpy()
                raw32 = torch.from_numpy(valid_scores[vi].astype(np.float32))
                pred = obj.transform(raw32).numpy()
                vw = (valid_weights[vi] if valid_weights is not None
                      else np.ones(len(vy)))
                vy_arr = np.asarray(vy)
                use = resolved if per_set_log else resolved[:1]
                vals = {mname: mfn(vy_arr, pred, vw)
                        for mname, (mfn, _hb) in use}
                results.append(vals[metric_name])
                if per_set_log:
                    for mname, mv in vals.items():
                        eval_log.append({"iteration": it, "valid_set": vi,
                                         mname: mv})
            primary = results[0]
            if eval_log is not None:
                entry = {"iteration": it, metric_name: primary}
                if per_set_log:
                    entry["primary"] = True
                eval_log.append(entry)
            improved = primary > best_score if higher_better \
                else primary < best_score
            if improved:
                best_score = primary
                best_iter = it + 1
            elif patience and (it + 1 - best_iter) >= patience:
                booster.best_iteration = best_iter
                final = booster.truncated(init_trees + best_iter * K)
                phase["boost"] = time.perf_counter() - t_boost
                final.phase_seconds = phase
                return final
        if callbacks:
            scores_np = scores.cpu().numpy().astype(np.float64) + base_score
            for cb in callbacks:
                cb(it, booster, scores_np)

    if pending:
        # materialize the deferred tree arrays: one host transfer per chunk
        # of iterations, then one vectorized bin -> raw threshold conversion
        cols = [[], [], [], [], []]
        for lo in range(0, len(pending), _MATERIALIZE_CHUNK):
            grp = pending[lo:lo + _MATERIALIZE_CHUNK]
            for i in range(5):
                cols[i].append(torch.stack([t[i] for t in grp]).cpu().numpy())
        feats_all, thr_all, leaf_all, gains_all, covers_all = (
            np.concatenate(c) for c in cols)
        leaf_all = leaf_all.astype(np.float32) * np.float32(lr)
        if is_multi:            # (iterations, K, ...) -> class-major trees
            feats_all, thr_all, gains_all, covers_all = (
                a.reshape((-1,) + a.shape[2:])
                for a in (feats_all, thr_all, gains_all, covers_all))
            leaf_all = _class_rows(
                leaf_all.reshape((-1,) + leaf_all.shape[2:]), K)
        thr_raw_all = _thr_bins_to_raw(feats_all, thr_all, mapper, n_bins)
        for t in range(feats_all.shape[0]):
            booster.append_tree(feats_all[t], thr_raw_all[t], leaf_all[t],
                                gains_all[t], covers_all[t])
    elif dev.type == "cuda":
        torch.cuda.synchronize(dev)
    phase["boost"] = time.perf_counter() - t_boost
    booster.phase_seconds = phase
    # absolute iterations, the warm start's included (the reference counts
    # them only with valid_sets)
    booster.best_iteration = init_iters + (best_iter if valid_sets
                                           else n_iter)
    return booster

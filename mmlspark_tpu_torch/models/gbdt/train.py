"""GBDT boosting loop (counterpart of ``models/gbdt/train.py``, single
device).

The bins live on the device (feature-major, ``ops/histogram.py``) for the
whole run; gradients, the tree build (K6 per level) and the score update
run there between iterations. On the fused path (gbdt, goss or rf, no
``valid_sets``, no ``callbacks``, constant leaves) each iteration's tree
arrays stay on the device in ``pending`` and are materialized in chunks
after the loop, so iterations queue back to back on the card. The general
path materializes each tree for eval, early stopping, callbacks, dart's
drops and linear leaves.

Multiclass (``objective="multiclass"``, ``num_class`` K >= 2) grows K
trees an iteration, one per class, together: scores are (n, K), the
gradients (K, n), and every level's K histograms come from one K6 launch
(``trees.build_tree``). Trees are appended class-major, each with its
leaf values in row k of a (K, 2^depth) array, as the JAX package stores
them, so model strings load across the two packages.

Boosting modes, each drawing from the one numpy stream
``np.random.default_rng(seed)`` in the JAX package's order (dart's drop,
then bagging or goss, then the feature subsample), so a seed selects the
same rows and trees in both packages:

* ``goss``: the top ``top_rate`` of rows by |g| and an ``other_rate``
  sample of the rest, amplified by (1 - a) / b in g and h only (never in
  the count channel). The selection runs on the host with the JAX
  package's numpy calls (``argpartition``, then ``rng.choice``): the
  gradients come to the host each iteration. K6 still reads every row;
  unselected rows carry zero weight.
* ``dart``: a drop of earlier iterations' trees (``skip_drop``,
  ``drop_rate``, ``max_drop``); the new tree fits the scores without
  them and enters at 1 / (k + 1), the dropped ones are rescaled by
  k / (k + 1) in place (``Booster.scale_trees``); with early stopping the
  best iteration's model is a snapshot.
* ``rf``: every tree fits the gradients at the starting margin, scaled by
  1 / num_iterations (the forest average); needs bagging.

Constraints and regularizers (``trees.build_tree``): ``monotone_constraints``,
``path_smooth``, ``interaction_constraints``. ``categorical_feature``
rank-encodes columns on the host (``categorical.py``) before binning;
the booster keeps the encoder. Sparse X (scipy CSR/CSC) bins column by
column, and with ``enable_bundle`` (the default) EFB packs mutually
exclusive features into bundles (``bundling.py``): K6 then reads the
(n_bundles, n) bundled bins at ``n_bundle_bins`` and the trees debundle.
``linear_tree`` fits a ridge model per leaf over its path features on the
device (``trees.fit_linear_leaves``) from the float32 matrix, kept there
for the run (as is dart's, for its drops).

A warm start (``init_model``) continues a booster: its raw scores on X,
less its base score, start the loop on the device (computed there from X
in chunks) and the new trees append to a copy of it. ``init_score`` starts
the loop from a per-row margin, (n,) or (n, K), with ``base_score`` 0;
the model's predictions exclude that margin, as LightGBM's do.

``extra_trees`` and ``feature_fraction_bynode`` draw each level's
candidate bins and feature subsets from the JAX package's threefry keys
(:mod:`...utils.prng`): ``PRNGKey(seed)`` folded with the absolute
iteration, split into one key a class for multiclass, so a seed grows the
same trees in both packages.

``objective="lambdarank"`` with ``group`` (the document counts of
contiguous query runs) computes the LambdaRank gradients on the device in
float64 (:mod:`.lambdarank`, the groups bucketed by size once per run)
and casts them to float32 after the sample weights, as the reference
does on the host.

Step checkpoints (``checkpoint_dir``, ``checkpoint_interval``) save the
booster through :class:`...utils.checkpoint.TrainingCheckpointer` in the
JAX package's layout; a call on a directory with a checkpoint resumes
from its newest step and trains the remaining iterations.

Not ported: data- and voting-parallel training (``tree_learner`` other
than serial, ``mesh=``) raise ``NotImplementedError`` naming ROADMAP.md's
slice-6 item.
"""

from __future__ import annotations

import math
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ...utils import prng
from ...utils.checkpoint import TrainingCheckpointer
from ...utils.device import resolve_device
from ...ops.histogram import prepare_bins_columns
from .binning import BinMapper, is_sparse
from .booster import Booster, _leftover
from .bundling import FeatureBundler
from .categorical import CategoricalEncoder
from .lambdarank import LambdarankPlan, lambdarank_grad
from .objectives import get_metric, get_objective
from .trees import (BundleTables, build_tree, fit_linear_leaves, map_rows,
                    path_features, predict_trees, predict_trees_linear)

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


def _reject_unported(p: Dict, mesh) -> None:
    """Raise NotImplementedError for the modes outside the port."""
    if mesh is not None or p["tree_learner"] != "serial":
        raise _leftover(f"tree_learner={p['tree_learner']!r} / mesh= "
                        f"(data- and voting-parallel training, slice 6)", 31)


def _boosting(p: Dict) -> str:
    return {"gbrt": "gbdt", "random_forest": "rf"}.get(
        str(p["boosting"]).lower(), str(p["boosting"]).lower())


def _check_modes(p: Dict, boosting: str, sparse_X: bool, init_model) -> None:
    """The JAX package's refusals of mode combinations (ValueError)."""
    if sparse_X and p["categorical_feature"]:
        raise ValueError(
            "categorical_feature is not supported with sparse input "
            "(rank-encode the categorical columns before sparsifying, "
            "or pass a dense matrix)")
    if boosting not in ("gbdt", "goss", "dart", "rf"):
        raise ValueError(f"boosting must be gbdt/goss/dart/rf, got {boosting!r}")
    if boosting == "goss" and p["bagging_freq"]:
        raise ValueError("GOSS replaces bagging; unset bagging_freq")
    if boosting == "rf":
        if not (p["bagging_freq"] and 0 < float(p["bagging_fraction"]) < 1):
            raise ValueError("rf mode needs bagging_freq > 0 and "
                             "0 < bagging_fraction < 1 (LightGBM's own rule)")
        if p["early_stopping_round"]:
            raise ValueError("rf averages over the full planned forest; "
                             "early stopping would bias the average")
        if init_model is not None:
            raise ValueError("rf mode cannot warm-start (the 1/T average "
                             "is defined over one forest)")
    if p["linear_tree"]:
        # LightGBM's linear_tree restrictions: the leaf models regress on
        # raw numerical features only
        if sparse_X:
            raise ValueError("linear_tree needs dense input (the leaf "
                             "models regress on raw feature values)")
        if p["categorical_feature"]:
            raise ValueError("linear_tree regresses on numerical features "
                             "only; drop categorical_feature")
        mc = p["monotone_constraints"]
        if mc is not None and np.asarray(mc).size and np.asarray(mc).any():
            # the fitted leaf models are unclamped: predictions would
            # silently violate the declared direction
            raise ValueError("linear_tree cannot honor "
                             "monotone_constraints; drop one of them")
        if float(p["lambda_l1"]) != 0.0:
            raise ValueError("lambda_l1 applies to constant leaf values "
                             "only; linear_tree leaves are L2-regularized "
                             "via linear_lambda (set lambda_l1=0)")
        if float(p["path_smooth"]) != 0.0:
            raise ValueError("path_smooth smooths constant leaf outputs; "
                             "it has no linear-leaf counterpart here "
                             "(set path_smooth=0)")
    if float(p["path_smooth"]) < 0.0:
        raise ValueError("path_smooth must be >= 0")
    ffbn = float(p["feature_fraction_bynode"])
    if not 0.0 < ffbn <= 1.0:
        raise ValueError(f"feature_fraction_bynode must be in (0, 1], "
                         f"got {ffbn}")


def _constraints(p: Dict, F: int, cat_encoder, dev) -> Dict:
    """build_tree's constraint keywords from the params, validated as the
    JAX package validates them: ``path_smooth``, ``ic_groups`` ((G, F)
    bool) and ``monotone`` ((F,) int32, only when one is nonzero)."""
    kw = {"path_smooth": float(p["path_smooth"])}
    ic_raw = p["interaction_constraints"]
    if ic_raw:
        # a branch may only combine features that share a group; features
        # in no group are unusable (LightGBM's semantics)
        groups = np.zeros((len(ic_raw), F), dtype=bool)
        for gi, grp in enumerate(ic_raw):
            idx = np.asarray(list(grp), dtype=np.int64)
            if idx.size == 0:
                raise ValueError("interaction_constraints groups must be "
                                 "non-empty")
            if idx.min() < 0 or idx.max() >= F:
                raise ValueError(
                    f"interaction_constraints[{gi}] has feature indices "
                    f"outside [0, {F})")
            groups[gi, idx] = True
        kw["ic_groups"] = torch.as_tensor(groups).to(dev)
    mono_raw = p["monotone_constraints"]
    if mono_raw is not None and np.asarray(mono_raw).size:
        # raw values are checked before the int cast (a fractional entry
        # would silently become a vacuous 0)
        raw = np.asarray(mono_raw)
        if raw.shape != (F,):
            raise ValueError(
                f"monotone_constraints needs one entry per feature "
                f"({F}), got shape {raw.shape}")
        if not np.isin(raw, (-1, 0, 1)).all():
            raise ValueError("monotone_constraints entries must be "
                             "-1, 0, or +1")
        mono = raw.astype(np.int32)
        if cat_encoder is not None:
            cat_set = set(cat_encoder.feature_indices)
            cat_idx = [int(i) for i in np.nonzero(mono)[0]
                       if int(i) in cat_set]
            if cat_idx:
                # the encoder rewrites these columns to label-ordered
                # ranks: monotone in the raw value would be vacuous
                raise ValueError(
                    f"monotone_constraints on categorical features "
                    f"{cat_idx} are not supported")
        if mono.any():
            kw["monotone"] = torch.as_tensor(mono).to(dev)
    return kw


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


def _bins(p: Dict, X, sparse_X: bool, mapper: BinMapper, dev,
          phase: Dict):
    """Fit ``mapper`` and put X's bins on the device. Sparse X with
    ``enable_bundle`` is planned into EFB bundles and, where bundling
    pays, K6 reads the (n_bundles, n) bundled bins. Returns (bins_cols,
    the bundler or None); seconds land in ``phase``."""
    t0 = time.perf_counter()
    mapper.fit(X)
    phase["bin_fit"] = time.perf_counter() - t0
    if sparse_X and p["enable_bundle"]:
        t0 = time.perf_counter()
        bundler = FeatureBundler(
            max_conflict_rate=float(p["max_conflict_rate"]),
            max_bundle_bins=int(p["max_bundle_bins"])).fit(X, mapper)
        phase["bundle_fit"] = time.perf_counter() - t0
        if bundler.worthwhile(X.shape[1]):
            t0 = time.perf_counter()
            xb = bundler.transform(X, mapper)
            t1 = time.perf_counter()
            bins_cols = prepare_bins_columns(xb, dev)
            _sync(dev)
            phase["bin_transform"] = t1 - t0
            phase["upload"] = time.perf_counter() - t1
            return bins_cols, bundler
    bins_cols, phase["bin_transform"], phase["upload"] = bins_on_device(
        mapper, X, dev)
    return bins_cols, None


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _save_step(ckpt: TrainingCheckpointer, step: int, booster: Booster
               ) -> None:
    """One step checkpoint in the reference's layout: the model string
    and the completed iteration count."""
    ckpt.save(step, {"booster.txt": booster.to_string(),
                     "meta.json": {"completed_iterations": step}})


def _goss_select(gabs: np.ndarray, a: float, b: float,
                 rng: np.random.Generator) -> Tuple[np.ndarray, np.ndarray]:
    """GOSS on the host, with the JAX package's numpy calls: the top
    ceil(a n) rows by |g| (``argpartition``) and a ``rng.choice`` of
    ceil(b n) of the rest, amplified by (1 - a) / b. Returns float64
    (selected 0/1, gradient weight) per row."""
    n = len(gabs)
    top_n = min(n, max(1, int(math.ceil(a * n))))
    rest_n = max(0, int(math.ceil(b * n)))
    order = np.argpartition(-gabs, top_n - 1)
    sel_bin = np.zeros(n)
    sel_amp = np.zeros(n)
    sel_bin[order[:top_n]] = 1.0
    sel_amp[order[:top_n]] = 1.0
    rest = order[top_n:]
    if rest_n and len(rest):
        samp = rng.choice(rest, size=min(rest_n, len(rest)), replace=False)
        sel_bin[samp] = 1.0
        sel_amp[samp] = (1.0 - a) / max(b, 1e-12)
    return sel_bin, sel_amp


def _dart_drop(p: Dict, n_groups: int, rng: np.random.Generator
               ) -> np.ndarray:
    """dart's dropped iterations (the JAX package's draws, in order):
    none with probability ``skip_drop``, else each with probability
    ``drop_rate``, at most ``max_drop`` of them."""
    if n_groups and rng.random() >= float(p["skip_drop"]):
        cand = np.nonzero(rng.random(n_groups) < float(p["drop_rate"]))[0]
        md = int(p["max_drop"])
        if md > 0 and len(cand) > md:
            cand = np.sort(rng.choice(cand, size=md, replace=False))
        return cand
    return np.array([], dtype=np.int64)


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
    ``params`` uses LightGBM names (aliases accepted); X is dense or
    scipy-sparse. ``valid_weights``: per-set sample weights for eval
    metrics. The returned booster predicts on the same device and
    carries ``phase_seconds`` (bin_fit, bin_transform, upload, boost, and
    where their modes run: cat_encode, bundle_fit, goss_d2h, goss_select,
    linear_fit) and ``efb_plan`` (``n_bundles``, ``n_bundle_bins``, or
    None)."""
    p = resolve_params(params)
    boosting = _boosting(p)
    linear_tree = bool(p["linear_tree"])
    _reject_unported(p, mesh)
    sparse_X = is_sparse(X)
    _check_modes(p, boosting, sparse_X, init_model)
    dev = resolve_device(device)
    # step checkpoints: a directory holding one resumes from its newest
    # step, as a warm start from the saved booster
    ckpt = None
    resumed_iters = 0
    if p["checkpoint_dir"] and init_score is not None:
        # a checkpoint holds only the booster: a resume could not rebuild
        # the margin-adjusted scores
        raise ValueError("init_score cannot combine with step checkpoints")
    if p["checkpoint_dir"]:
        ckpt = TrainingCheckpointer(str(p["checkpoint_dir"]))
        latest = ckpt.latest()
        if latest is not None:
            _, files = latest
            meta = TrainingCheckpointer.read_json(files["meta.json"])
            resumed_iters = int(meta["completed_iterations"])
            init_model = Booster.from_string(TrainingCheckpointer.read_text(
                files["booster.txt"]), device=dev)
    if init_model is not None and init_score is not None:
        raise ValueError("init_score cannot combine with a warm-start "
                         "model (the model already defines the margin)")
    if init_model is not None \
            and getattr(init_model, "is_linear", False) != linear_tree:
        raise ValueError("warm start must keep the leaf model family: "
                         "set linear_tree to match the init model")
    if sparse_X:
        # stays sparse: the binned matrix is the only dense artifact
        X = X.tocsr()
        if X.dtype.kind != "f":
            X = X.astype(np.float64)
    else:
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
    is_rank = objective_name == "lambdarank"
    if is_rank and group is None:
        raise ValueError("objective='lambdarank' needs group= (the "
                         "document count of each contiguous query run)")
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

    phase: Dict[str, float] = {}
    X_raw = X
    cat_encoder = None
    if p["categorical_feature"] or (init_model is not None
                                    and init_model.cat_encoder is not None):
        # label-ordered rank encoding; a warm start reuses the prior
        # booster's encoding (its trees split in that rank space)
        if sparse_X:
            raise ValueError("categorical encoding and sparse input cannot "
                             "combine (the warm-start model was trained "
                             "with categorical_feature)")
        t0 = time.perf_counter()
        if init_model is not None and init_model.cat_encoder is not None:
            cat_encoder = init_model.cat_encoder
        elif init_model is not None:
            # appending rank-space trees to raw-space ones would mix spaces
            raise ValueError(
                "categorical_feature set, but the warm-start model was "
                "trained without categorical encoding; retrain from "
                "scratch or drop categorical_feature")
        else:
            cat_encoder = CategoricalEncoder(
                p["categorical_feature"],
                cat_smooth=float(p["cat_smooth"]),
                min_data_per_group=int(p["min_data_per_group"])).fit(X, y)
        X = cat_encoder.transform(X)
        phase["cat_encode"] = time.perf_counter() - t0
    constraints = _constraints(p, F, cat_encoder, dev)

    mapper = BinMapper(max_bin=int(p["max_bin"]), seed=int(p["seed"]))
    bins_cols, bundler = _bins(p, X, sparse_X, mapper, dev, phase)
    n_bins = int(mapper.n_bins)

    # device residency, all f32 (the reference runs with x64 off); scores
    # are the DELTA from base_score, re-added for the gradients
    t0 = time.perf_counter()
    init_trees = 0
    init_d = None
    if init_model is not None:
        # the new trees append to a copy: the caller's model is left as
        # it was (dart rescales trees in place)
        booster = init_model.truncated(init_model.num_trees)
        booster.device = dev
        base_score = booster.base_score
        init_trees = booster.num_trees
        scores = booster.raw_score_on_device(X_raw) - torch.tensor(
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
            scores = init_d = _to_device(init_arr, dev, torch.float32)
        else:
            # boost_from_average: the first margin is the objective's
            # optimal constant; off (and multiclass) -> boosting starts
            # at 0
            base_score = obj.init_score(y, w) if p["boost_from_average"] \
                and not (is_multi or is_rank) else 0.0
            scores = torch.zeros((n, K) if is_multi else n,
                                 dtype=torch.float32, device=dev)
        booster = Booster(depth, F, objective_name, base_score, K,
                          device=dev)
        booster.cat_encoder = cat_encoder
    y_d = torch.as_tensor(y, dtype=torch.float32).to(dev)
    w_d = torch.as_tensor(w, dtype=torch.float32).to(dev)
    live_d = torch.ones(n, dtype=torch.float32, device=dev)
    base32 = torch.tensor(base_score, dtype=torch.float32, device=dev)
    # the float32 matrix on the device, for dart's drops and the linear
    # leaves' design (sparse X is densified in chunks at each drop)
    X_dev = None
    if (boosting == "dart" or linear_tree) and not sparse_X:
        X_dev = torch.from_numpy(np.ascontiguousarray(
            X, dtype=np.float32)).to(dev)
    phase["upload"] += time.perf_counter() - t0
    init_iters = init_trees // K

    build_kwargs = dict(depth=depth, n_bins=n_bins,
                        lam=float(p["lambda_l2"]) + 1e-10,
                        alpha=float(p["lambda_l1"]),
                        min_gain=float(p["min_gain_to_split"]),
                        min_child_weight=float(p["min_sum_hessian_in_leaf"]),
                        min_data_in_leaf=float(p["min_data_in_leaf"]),
                        hist_dtype=(torch.bfloat16 if p["use_quantized_grad"]
                                    else None), **constraints)
    if bundler is not None:
        build_kwargs.update(
            bundles=BundleTables.from_bundler(bundler, dev),
            n_bundle_bins=int(bundler.n_bundle_bins))
    # extra_trees / feature_fraction_bynode: the reference's threefry
    # keys, one a tree (a class)
    draws = bool(p["extra_trees"]) or float(p["feature_fraction_bynode"]) < 1
    if draws:
        build_kwargs.update(extra_trees=bool(p["extra_trees"]),
                            ff_bynode=float(p["feature_fraction_bynode"]))
    if p["extra_trees"]:
        # each feature's populated bins, the missing bin included: the
        # candidate bin is drawn within the feature's own range
        build_kwargs["feat_bins"] = torch.tensor(
            [len(b) + 1 for b in mapper.upper_bounds], dtype=torch.int32,
            device=dev)
    rank_plan = None
    if is_rank:
        t0 = time.perf_counter()
        rank_plan = LambdarankPlan(group, y, dev, n=n)
        w64 = torch.as_tensor(w, dtype=torch.float64).to(dev)
        phase["rank_plan"] = time.perf_counter() - t0
    booster.fit_params = {"learning_rate": float(p["learning_rate"]),
                          "lambda_l2": float(p["lambda_l2"])}
    lr = float(p["learning_rate"])
    rng = np.random.default_rng(int(p["seed"]))
    n_iter = max(0, int(p["num_iterations"]) - resumed_iters)
    ckpt_iv = int(p["checkpoint_interval"]) if ckpt is not None else 0
    it_keys = None
    if draws:
        # every iteration's key in one hash: fold_in(PRNGKey(seed),
        # absolute iteration), then split into one key a class
        it_keys = prng.fold_in(prng.PRNGKey(int(p["seed"]), device=dev),
                               torch.arange(resumed_iters,
                                            resumed_iters + n_iter,
                                            device=dev))
        if is_multi:
            it_keys = prng.fold_in(it_keys[:, None, :],
                                   torch.arange(K, device=dev))
    # rf has no shrinkage: each tree enters at 1/T, so the sum is the
    # forest's average
    rf_scale = 1.0 / max(1, int(p["num_iterations"])) \
        if boosting == "rf" else None

    def _stack_pred(feats_a, thr_a, leaf_a, Xq, coefs_a=None, pf_a=None):
        """A stack of trees' summed outputs for Xq (a device tensor, or
        host rows mapped over in chunks), on the device."""
        f, t = (torch.as_tensor(np.asarray(a)).to(dev)
                for a in (feats_a, thr_a))
        if linear_tree:
            c, pf = (torch.as_tensor(np.asarray(a)).to(dev)
                     for a in (coefs_a, pf_a))

            def fn(xd):
                return predict_trees_linear(f, t, c, pf, xd, depth, K)
        else:
            lv = torch.as_tensor(np.asarray(leaf_a)).to(dev)

            def fn(xd):
                return predict_trees(f, t, lv, xd, depth)
        return fn(Xq) if isinstance(Xq, torch.Tensor) else map_rows(
            fn, Xq, dev)

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
    best_model = None               # dart: a snapshot at each new best
    patience = int(p["early_stopping_round"])
    valid_scores = valid_margins = None
    if valid_sets:
        valid_sets = [(vx if is_sparse(vx) else np.asarray(vx), vy)
                      for vx, vy in valid_sets]
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
            valid_margins = []
            for vi, vis in enumerate(valid_init_scores):
                vis = np.asarray(vis, dtype=np.float64)
                if vis.shape != valid_scores[vi].shape:
                    raise ValueError(
                        f"valid_init_scores[{vi}] shape {vis.shape} != "
                        f"{valid_scores[vi].shape}")
                valid_margins.append(vis)
                valid_scores[vi] = valid_scores[vi] + vis
        if cat_encoder is not None:
            # the eval below feeds the trees directly: rank-encode the
            # validation matrices once
            if any(is_sparse(vx) for vx, _ in valid_sets):
                raise ValueError("sparse validation sets cannot combine "
                                 "with categorical_feature")
            valid_sets = [(cat_encoder.transform(np.asarray(vx)), vy)
                          for vx, vy in valid_sets]

    fmask_all = torch.ones(F, dtype=torch.bool, device=dev)

    def _bagging_masks(it):
        """(live_it, gh_w) for this iteration, from the one rng stream in
        the reference's order: a seed yields the same row subsets."""
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

    def _finish(b: Booster) -> Booster:
        phase["boost"] = time.perf_counter() - t_boost
        b.phase_seconds = phase
        b.efb_plan = None if bundler is None else {
            "n_bundles": bundler.n_bundles,
            "n_bundle_bins": int(bundler.n_bundle_bins)}
        return b

    lin_kwargs = dict(n_leaf=2 ** depth, lam_lin=float(p["linear_lambda"]),
                      lam=float(p["lambda_l2"]) + 1e-10)
    if boosting == "goss":
        phase.update(goss_d2h=0.0, goss_select=0.0)
    if linear_tree:
        phase["linear_fit"] = 0.0
    # fused/deferred fast path: nothing in an iteration reads a tree on
    # the host, so iterations queue back to back on the card
    defer = (boosting != "dart" and not linear_tree and not valid_sets
             and not callbacks and ckpt is None)
    pending: List[Tuple] = []
    t_boost = time.perf_counter()
    for it in range(n_iter):
        # -- dart: drop earlier iterations, fit the scores without them --
        drop_idx = drop_pred = None
        tree_scale = 1.0
        if boosting == "dart":
            drop_groups = _dart_drop(p, booster.num_trees // K, rng)
            if len(drop_groups):
                tree_scale = 1.0 / (len(drop_groups) + 1.0)   # DART weights
                drop_idx = (drop_groups[:, None] * K
                            + np.arange(K)[None, :]).ravel()
                lin = booster.linear if linear_tree else None
                drop_pred = _stack_pred(
                    booster.feats[drop_idx], booster.thr_raw[drop_idx],
                    booster.leaf_values[drop_idx],
                    X_dev if X_dev is not None else X,
                    lin["coefs"][drop_idx] if lin else None,
                    lin["pf"][drop_idx] if lin else None)
        elif boosting == "rf":
            tree_scale = rf_scale

        # trees fit the gradients at: the scores less the dropped trees
        # (dart), the starting margin (rf: every tree fits the same
        # residual), else the current scores
        scores_for_grad = scores + base32
        if drop_pred is not None:
            scores_for_grad = scores_for_grad - drop_pred
        elif boosting == "rf":
            scores_for_grad = (init_d if init_d is not None
                               else torch.full_like(scores, base_score))
        if is_rank:
            # float64 on the device; weighted, then float32 as the
            # reference casts its host gradients
            g64, h64 = lambdarank_grad(scores_for_grad, rank_plan)
            g_d, h_d = (g64 * w64).float(), (h64 * w64).float()
        else:
            g_d, h_d = obj.grad_hess(scores_for_grad, y_d, w_d)

        # goss / bagging / feature sampling: live_it is the 0/1 row
        # membership (counts, covers), gh_w also carries goss's
        # amplification of g and h
        if boosting == "goss":
            _sync(dev)
            t0 = time.perf_counter()
            g_host = g_d.cpu().numpy()
            t1 = time.perf_counter()
            gabs = np.abs(g_host).sum(axis=1) if is_multi else np.abs(g_host)
            sel_bin, sel_amp = _goss_select(gabs, float(p["top_rate"]),
                                            float(p["other_rate"]), rng)
            live_it = _to_device(sel_bin, dev, torch.float32)
            gh_w = _to_device(sel_amp, dev, torch.float32)
            phase["goss_d2h"] += t1 - t0
            phase["goss_select"] += time.perf_counter() - t1
        else:
            live_it, gh_w = _bagging_masks(it)
        fmask = _feature_mask()
        lr_eff = (1.0 if boosting == "rf" else lr) * tree_scale
        if is_multi:        # (n, K) -> the (K, n) rows build_tree takes
            g = (g_d * gh_w[:, None]).T.contiguous()
            h = (h_d * gh_w[:, None]).T.contiguous()
        else:
            g, h = g_d * gh_w, h_d * gh_w
        feats, thr_bin, leaf_val, node_rel, gains, covers = build_tree(
            bins_cols, g, h, live_it, feature_mask=fmask,
            rng=None if it_keys is None else it_keys[it], **build_kwargs)
        new_coefs = new_pf = None
        if linear_tree:
            # one ridge model per leaf over its path features, per class
            feats_np = feats.cpu().numpy()
            fk = feats_np if is_multi else feats_np[None]
            new_pf = np.stack([path_features(fk[k], depth)
                               for k in range(K)])
            t0 = time.perf_counter()
            cols = [fit_linear_leaves(
                X_dev, nk.to(torch.int64), gk, hk, live_it,
                torch.as_tensor(new_pf[k]).to(dev), **lin_kwargs)
                for k, (nk, gk, hk) in enumerate(zip(
                    *((t if is_multi else t[None])
                      for t in (node_rel, g, h))))]
            new_coefs = np.stack([c.cpu().numpy().astype(np.float32)
                                  for c, _ in cols]) * np.float32(lr_eff)
            phase["linear_fit"] += time.perf_counter() - t0
            contrib = torch.stack([c for _, c in cols], dim=1)
            scores = scores + (contrib if is_multi else contrib[:, 0]) \
                * lr_eff
            # leaf_values keep the bias, the constant view
            leaf_np = new_coefs[:, :, -1] if is_multi \
                else new_coefs[0, :, -1].copy()
        elif is_multi:
            scores = scores + leaf_val.gather(
                1, node_rel.to(torch.int64)).T * lr_eff
        else:
            scores = scores + leaf_val.index_select(0, node_rel) * lr_eff
        if defer:
            pending.append((feats, thr_bin, leaf_val, gains, covers))
            continue
        if not linear_tree:
            leaf_np = leaf_val.cpu().numpy() * lr_eff
        trees = _host_trees(feats.cpu().numpy(), thr_bin.cpu().numpy(),
                            leaf_np, gains.cpu().numpy(),
                            covers.cpu().numpy(), mapper, n_bins, is_multi)
        for k, tree in enumerate(trees):
            booster.append_tree(*tree, **(
                dict(coefs=new_coefs[k], pf=new_pf[k]) if linear_tree
                else {}))
        if drop_idx is not None:
            # dart normalization: dropped trees re-enter at k / (k + 1);
            # the running scores hold them at full weight, so the 1 / (k +
            # 1) difference comes back out
            k_drop = len(drop_idx) // K
            booster.scale_trees(drop_idx, k_drop * tree_scale)
            scores = scores - drop_pred * tree_scale

        # eval + early stopping (this iteration's trees only, or the whole
        # stack after a dart drop rescaled earlier trees)
        if valid_sets:
            new_f, new_t, new_l = (np.stack([t[i] for t in trees])
                                   for i in range(3))
            lin = booster.linear if linear_tree else None
            results = []
            per_set_log = (eval_log is not None
                           and (len(resolved) > 1 or len(valid_sets) > 1))
            for vi, (vx, vy) in enumerate(valid_sets):
                if drop_idx is not None:
                    valid_scores[vi] = base_score + _stack_pred(
                        booster.feats, booster.thr_raw, booster.leaf_values,
                        vx, lin["coefs"] if lin else None,
                        lin["pf"] if lin else None).cpu().numpy()
                    if valid_margins is not None:
                        valid_scores[vi] = valid_scores[vi] \
                            + valid_margins[vi]
                else:
                    valid_scores[vi] = valid_scores[vi] + _stack_pred(
                        new_f, new_t, new_l, vx, new_coefs,
                        new_pf).cpu().numpy()
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
                if boosting == "dart":
                    # later drops rescale earlier trees in place: only a
                    # snapshot taken now reproduces this score
                    best_model = booster.truncated(init_trees + best_iter * K)
            elif patience and (it + 1 - best_iter) >= patience:
                booster.best_iteration = best_iter
                final = (best_model if best_model is not None
                         else booster.truncated(init_trees + best_iter * K))
                if ckpt is not None:
                    # marked complete (the full budget): a rerun on the
                    # directory returns this booster, not a resumed one
                    _save_step(ckpt, int(p["num_iterations"]), final)
                return _finish(final)
        if callbacks:
            scores_np = scores.cpu().numpy().astype(np.float64) + base_score
            for cb in callbacks:
                cb(it, booster, scores_np)
        if ckpt_iv and (it + 1) % ckpt_iv == 0:
            _save_step(ckpt, resumed_iters + it + 1, booster)

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
        # the deferred modes' scale is fixed: lr, or rf's 1/T
        leaf_all = leaf_all.astype(np.float32) * np.float32(
            rf_scale if boosting == "rf" else lr)
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
    else:
        _sync(dev)
    if ckpt is not None and n_iter > 0:
        _save_step(ckpt, resumed_iters + n_iter, booster)
    if patience and best_model is not None:
        # dart reaching the budget without the patience branch firing:
        # only the snapshot reproduces best_score
        return _finish(best_model)
    if not (valid_sets and n_iter == 0):
        # absolute iterations, the warm start's included (the reference
        # counts them only with valid_sets); a finished checkpointed run
        # rerun with valid_sets keeps its restored best_iteration
        booster.best_iteration = init_iters + (best_iter if valid_sets
                                               else n_iter)
    return _finish(booster)

"""Export a trained GBDT booster as an ONNX TreeEnsemble graph
(counterpart of ``models/gbdt/onnx_export.py``).

The exporter reads the booster's flat fixed-depth arrays: every internal
node becomes a ``BRANCH_LEQ`` row (missing tracks true, the trainer's
NaN -> left rule), a stub node an always-true split against +inf, and the
leaves carry the class or target weights. The bytes are the JAX
exporter's (node names aside), built with the port's own
``onnx/builder.py``; they run through ``onnx.convert_model`` /
``ONNXModel`` (``onnx/ml_ops.py``) and, being spec-compliant ai.onnx.ml,
any other ONNX consumer.
"""

from __future__ import annotations

import numpy as np

from ...onnx.builder import (make_graph, make_model, make_node,
                             make_tensor_value_info)

__all__ = ["booster_to_onnx"]


def _node_tables(booster):
    """Flat per-node attribute lists from the (T, 2^d-1)/(T, 2^d) arrays."""
    depth = booster.depth
    n_int = 2 ** depth - 1
    n_all = 2 ** (depth + 1) - 1
    feats = np.asarray(booster.feats)
    thr = np.asarray(booster.thr_raw, np.float64)
    T = feats.shape[0]

    tids, nids, fids, vals, modes, tnid, fnid, miss = \
        [], [], [], [], [], [], [], []
    for t in range(T):
        for n in range(n_all):
            tids.append(t)
            nids.append(n)
            if n < n_int:
                f = int(feats[t, n])
                modes.append("BRANCH_LEQ")
                # disabled node (f < 0): the trainer always descends left —
                # an always-true split (x <= +inf, NaN tracks true too)
                fids.append(max(f, 0))
                vals.append(float(thr[t, n]) if f >= 0 else float("inf"))
                tnid.append(2 * n + 1)
                fnid.append(2 * n + 2)
                miss.append(1)          # NaN goes left = the true branch
            else:
                modes.append("LEAF")
                fids.append(0)
                vals.append(0.0)
                tnid.append(0)
                fnid.append(0)
                miss.append(0)
    return {"nodes_treeids": tids, "nodes_nodeids": nids,
            "nodes_featureids": fids, "nodes_values": vals,
            "nodes_modes": modes, "nodes_truenodeids": tnid,
            "nodes_falsenodeids": fnid,
            "nodes_missing_value_tracks_true": miss}


def booster_to_onnx(booster, n_features: int = None) -> bytes:
    """Serialize ``booster`` (models.gbdt.booster.Booster) to ONNX bytes.

    Classifiers (objective binary/multiclass*) become
    ``TreeEnsembleClassifier`` with outputs ``label`` (int64) and
    ``probabilities``; everything else becomes ``TreeEnsembleRegressor``
    with output ``variable`` — the names onnxmltools emits for LightGBM.
    """
    if getattr(booster, "cat_encoder", None) is not None:
        raise ValueError(
            "booster splits in a label-encoded categorical space; ONNX "
            "TreeEnsemble consumers would see raw features. Export only "
            "supports numeric-feature boosters.")
    if getattr(booster, "is_linear", False):
        raise ValueError(
            "ONNX TreeEnsemble has no linear-leaf representation "
            "(onnxmltools rejects LightGBM linear_tree models too)")
    depth = booster.depth
    n_int = 2 ** depth - 1
    n_leaf = 2 ** depth
    F = n_features or booster.n_features
    lv = np.asarray(booster.leaf_values, np.float64)
    T = lv.shape[0]
    nodes_attrs = _node_tables(booster)
    classify = booster.objective.startswith(("binary", "multiclass"))

    if classify:
        K = booster.num_class if booster.num_class > 1 else 2
        ctids, cnids, cids, cws = [], [], [], []
        for t in range(T):
            for leaf in range(n_leaf):
                node_id = n_int + leaf
                if booster.num_class > 1:
                    for k in range(booster.num_class):
                        ctids.append(t)
                        cnids.append(node_id)
                        cids.append(k)
                        cws.append(float(lv[t, k, leaf]))
                else:
                    ctids.append(t)
                    cnids.append(node_id)
                    cids.append(1)      # binary: weights score class 1
                    cws.append(float(lv[t, leaf]))
        post = "SOFTMAX" if booster.num_class > 1 else "LOGISTIC"
        base = [float(booster.base_score)] * \
            (booster.num_class if booster.num_class > 1 else 1)
        node = make_node(
            "TreeEnsembleClassifier", ["features"],
            ["label", "probabilities"], domain="ai.onnx.ml",
            classlabels_int64s=list(range(K)),
            post_transform=post, base_values=base,
            class_treeids=ctids, class_nodeids=cnids, class_ids=cids,
            class_weights=cws, **nodes_attrs)
        outputs = [make_tensor_value_info("label", np.int64, ["N"]),
                   make_tensor_value_info("probabilities", np.float32,
                                          ["N", K])]
    else:
        ttids, tnids_, tids_, tws = [], [], [], []
        for t in range(T):
            for leaf in range(n_leaf):
                ttids.append(t)
                tnids_.append(n_int + leaf)
                tids_.append(0)
                tws.append(float(lv[t, leaf]))
        node = make_node(
            "TreeEnsembleRegressor", ["features"], ["variable"],
            domain="ai.onnx.ml", n_targets=1,
            base_values=[float(booster.base_score)],
            aggregate_function="SUM", post_transform="NONE",
            target_treeids=ttids, target_nodeids=tnids_,
            target_ids=tids_, target_weights=tws, **nodes_attrs)
        outputs = [make_tensor_value_info("variable", np.float32,
                                          ["N", 1])]

    g = make_graph(
        [node], "gbdt",
        [make_tensor_value_info("features", np.float32, ["N", F])],
        outputs)
    return make_model(g, opset=17, extra_opsets={"ai.onnx.ml": 3})

"""The port's ORT generation meta-ops (``onnx/generation_ops.py``:
com.microsoft ``GreedySearch`` / ``BeamSearch``) against the JAX converter
on the CPU: every case of ``tests/test_onnx_generation.py``.

The decoder subgraph is that file's: a causal single-layer GPT from
standard ONNX ops (embeddings, fused-QKV attention with past/present
concat, causal and padding masks), written with the port's builder. Each
graph runs through both converters on the same seeded inputs:

* sequences bitwise the JAX converter's (greedy and beam ids alike; the
  beam's ties select the lower index first in both);
* beam scores within 1e-5 · max|score| + 1e-6 of the JAX converter's;
* and, as the JAX test does, against the oracle of the SAME subgraph
  converted standalone and re-run from scratch each step (full recompute,
  empty past), which for a causal decoder equals cached decoding.
"""

import itertools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import mmlspark_tpu.onnx as J
import mmlspark_tpu_torch.onnx as O
from mmlspark_tpu.onnx.convert import UnsupportedOp as JaxUnsupported
from mmlspark_tpu_torch.onnx.convert import UnsupportedOp

torch.set_num_threads(1)  # one a worker: README, "Testing & benchmarks"

V, D, H = 8, 8, 2
HD = D // H
MAXP = 16


def _decoder_graph(seed=0):
    rng = np.random.default_rng(seed)
    init = {
        "tok_table": rng.normal(0, 0.7, (V, D)).astype(np.float32),
        "pos_table": rng.normal(0, 0.3, (MAXP, D)).astype(np.float32),
        "w_qkv": rng.normal(0, 0.5, (D, 3 * D)).astype(np.float32),
        "w_out": rng.normal(0, 0.5, (D, D)).astype(np.float32),
        "unembed": rng.normal(0, 0.7, (D, V)).astype(np.float32),
        "scale": np.array(1.0 / np.sqrt(HD), np.float32),
        "one_f": np.array([1.0], np.float32),
        "big_neg": np.array(-1e9, np.float32),
        "i1": np.array(1, np.int64),
        "perm_shape": np.array([0, 0, H, HD], np.int64),
        "merge_shape": np.array([0, 0, D], np.int64),
        "i0_idx": np.array(0, np.int64),
        "i1_idx": np.array(1, np.int64),
    }
    n = O.make_node
    nodes = [
        n("Gather", ["tok_table", "input_ids"], ["te"]),
        n("Gather", ["pos_table", "position_ids"], ["pe"]),
        n("Add", ["te", "pe"], ["h"]),
        n("MatMul", ["h", "w_qkv"], ["qkv"]),
        n("Split", ["qkv"], ["q0", "k0", "v0"], axis=-1, num_outputs=3),
        n("Reshape", ["q0", "perm_shape"], ["q1"]),
        n("Reshape", ["k0", "perm_shape"], ["k1"]),
        n("Reshape", ["v0", "perm_shape"], ["v1"]),
        n("Transpose", ["q1"], ["q"], perm=[0, 2, 1, 3]),
        n("Transpose", ["k1"], ["kn"], perm=[0, 2, 1, 3]),
        n("Transpose", ["v1"], ["vn"], perm=[0, 2, 1, 3]),
        n("Gather", ["past_0", "i0_idx"], ["kp"], axis=0),
        n("Gather", ["past_0", "i1_idx"], ["vp"], axis=0),
        n("Concat", ["kp", "kn"], ["K"], axis=2),
        n("Concat", ["vp", "vn"], ["Vv"], axis=2),
        n("Transpose", ["K"], ["Kt"], perm=[0, 1, 3, 2]),
        n("MatMul", ["q", "Kt"], ["s0"]),
        n("Mul", ["s0", "scale"], ["s1"]),
        n("Shape", ["input_ids"], ["ids_shape"]),
        n("Gather", ["ids_shape", "i1"], ["S_"], axis=0),
        n("Shape", ["attention_mask"], ["m_shape"]),
        n("Gather", ["m_shape", "i1"], ["T_"], axis=0),
        n("Sub", ["T_", "S_"], ["Ppast"]),
        n("Unsqueeze", ["S_"], ["S_u"], axes=[0]),
        n("Unsqueeze", ["T_"], ["T_u"], axes=[0]),
        n("Concat", ["S_u", "T_u"], ["st"], axis=0),
        n("Expand", ["one_f", "st"], ["ones_st"]),
        n("Trilu", ["ones_st", "Ppast"], ["tril"], upper=0),
        n("Sub", ["tril", "one_f"], ["tril0"]),
        n("Mul", ["tril0", "big_neg"], ["causal_neg"]),
        n("Sub", ["one_f", "attention_mask"], ["padm"]),
        n("Mul", ["padm", "big_neg"], ["pad_neg"]),
        n("Unsqueeze", ["pad_neg"], ["pad_neg4"], axes=[1, 2]),
        n("Add", ["s1", "causal_neg"], ["s2"]),
        n("Add", ["s2", "pad_neg4"], ["s3"]),
        n("Softmax", ["s3"], ["p"], axis=-1),
        n("MatMul", ["p", "Vv"], ["ctx"]),
        n("Transpose", ["ctx"], ["ctx1"], perm=[0, 2, 1, 3]),
        n("Reshape", ["ctx1", "merge_shape"], ["ctx2"]),
        n("MatMul", ["ctx2", "w_out"], ["ho"]),
        n("Add", ["h", "ho"], ["hf"]),
        n("MatMul", ["hf", "unembed"], ["logits"]),
        n("Unsqueeze", ["K"], ["K5"], axes=[0]),
        n("Unsqueeze", ["Vv"], ["V5"], axes=[0]),
        n("Concat", ["K5", "V5"], ["present_0"], axis=0),
    ]
    vi = O.make_tensor_value_info
    return O.make_graph(
        nodes, "gpt_step",
        inputs=[vi("input_ids", np.int32, ["B", "S"]),
                vi("position_ids", np.int32, ["B", "S"]),
                vi("attention_mask", np.float32, ["B", "T"]),
                vi("past_0", np.float32, [2, "B", H, "P", HD])],
        outputs=[vi("logits", np.float32, ["B", "S", V]),
                 vi("present_0", np.float32, [2, "B", H, "T", HD])],
        initializers=init)


def _port(data, feeds):
    pm = O.convert_model(data)
    out = pm({k: torch.from_numpy(v) for k, v in pm.params.items()},
             {k: torch.from_numpy(np.array(v)) for k, v in feeds.items()})
    return {k: v.numpy() for k, v in out.items()}


def _jax(data, feeds):
    jm = J.convert_model(data)
    out = jm(jm.params, {k: jnp.asarray(v) for k, v in feeds.items()})
    return {k: np.asarray(v) for k, v in out.items()}


def _both(data, feeds):
    """Both converters; sequences bitwise, scores within the bound."""
    got, want = _port(data, feeds), _jax(data, feeds)
    assert set(got) == set(want)
    for k in got:
        assert got[k].shape == want[k].shape, k
        if want[k].dtype.kind == "f":
            tol = 1e-5 * float(np.abs(want[k]).max(initial=0.0)) + 1e-6
            assert float(np.abs(got[k] - want[k]).max(initial=0.0)) <= tol
        else:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    return got


@pytest.fixture(scope="module")
def oracle():
    """The standalone converted decoder (the port's) + full-recompute
    greedy and log-probabilities."""
    cm = O.convert_model(O.make_model(_decoder_graph()))

    def logits_for(ids_2d):
        ids = np.asarray(ids_2d, np.int32)
        B, S = ids.shape
        feeds = {"input_ids": ids,
                 "position_ids": np.tile(np.arange(S, dtype=np.int32),
                                         (B, 1)),
                 "attention_mask": np.ones((B, S), np.float32),
                 "past_0": np.zeros((2, B, H, 0, HD), np.float32)}
        out = cm({k: torch.from_numpy(v) for k, v in cm.params.items()},
                 {k: torch.from_numpy(v) for k, v in feeds.items()})
        return out["logits"].numpy()

    def greedy(prompt_row, max_length):
        ids = list(map(int, prompt_row))
        while len(ids) < max_length:
            ids.append(int(logits_for([ids])[0, -1].argmax()))
        return ids

    def seq_logprob(prompt_row, gen):
        from scipy.special import logsumexp
        ids = list(map(int, prompt_row))
        lp = 0.0
        for t in gen:
            row = logits_for([ids])[0, -1].astype(np.float64)
            lp += row[t] - logsumexp(row)
            ids.append(int(t))
        return lp

    return logits_for, greedy, seq_logprob


def _greedy_model(max_length=9, **extra):
    names = ["input_ids", "max_length"] + list(extra)
    node = O.make_node("GreedySearch", names, ["sequences"],
                       domain="com.microsoft", decoder=_decoder_graph(),
                       eos_token_id=V - 1, pad_token_id=0, model_type=0)
    g = O.make_graph(
        [node], "gen",
        inputs=[O.make_tensor_value_info("input_ids", np.int32, ["B", "P"])],
        outputs=[O.make_tensor_value_info("sequences", np.int32,
                                          ["B", "L"])],
        initializers={"max_length": np.array(max_length, np.int64),
                      **extra})
    return O.make_model(g)


def _upto_eos(want, got, start):
    if V - 1 in want[start:]:
        stop = want.index(V - 1, start)
        assert got[:stop + 1] == want[:stop + 1]
        assert all(t == 0 for t in got[stop + 1:])
    else:
        assert got == want


def test_greedy_matches_full_recompute_oracle(oracle):
    _, greedy, _ = oracle
    prompts = np.array([[1, 2, 3], [4, 0, 6]], np.int32)
    out = _both(_greedy_model(), {"input_ids": prompts})["sequences"]
    assert out.shape == (2, 9)
    for r in range(2):
        _upto_eos(greedy(prompts[r], 9), [int(t) for t in out[r]], 3)


def test_greedy_left_padded_batch_matches_per_row(oracle):
    _, greedy, _ = oracle
    node = O.make_node(
        "GreedySearch",
        ["input_ids", "max_length", "", "", "", "", "attention_mask"],
        ["sequences"], domain="com.microsoft", decoder=_decoder_graph(),
        eos_token_id=V - 1, pad_token_id=0, model_type=0)
    g = O.make_graph(
        [node], "gen",
        inputs=[O.make_tensor_value_info("input_ids", np.int32, ["B", "P"]),
                O.make_tensor_value_info("attention_mask", np.float32,
                                         ["B", "P"])],
        outputs=[O.make_tensor_value_info("sequences", np.int32,
                                          ["B", "L"])],
        initializers={"max_length": np.array(8, np.int64)})
    prompts = np.array([[1, 2, 3, 4], [0, 0, 5, 6]], np.int32)
    mask = np.array([[1, 1, 1, 1], [0, 0, 1, 1]], np.float32)
    out = _both(O.make_model(g), {"input_ids": prompts,
                                  "attention_mask": mask})["sequences"]
    for r, real in enumerate([[1, 2, 3, 4], [5, 6]]):
        want = greedy(np.array(real, np.int32), len(real) + 4)
        gen, got = want[len(real):], [int(t) for t in out[r, 4:]]
        if V - 1 in gen:
            stop = gen.index(V - 1)
            assert got[:stop + 1] == gen[:stop + 1]
        else:
            assert got == gen


def test_greedy_repetition_penalty_changes_output():
    prompts = {"input_ids": np.array([[1, 2, 3]], np.int32)}
    a = _both(_greedy_model(repetition_penalty=np.array(9.0, np.float32),
                            min_length=np.array(0, np.int64)),
              prompts)["sequences"]
    b = _both(_greedy_model(), prompts)["sequences"]
    assert not np.array_equal(a, b) or len(set(b[0].tolist())) == 9


@pytest.mark.parametrize("extra", [
    {"min_length": np.array(8, np.int64)},
    {"min_length": np.array(0, np.int64),
     "repetition_penalty": np.array(1.0, np.float32),
     "vocab_mask": np.array([1, 1, 0, 1, 1, 0, 1, 1], np.int32)}])
def test_greedy_min_length_and_vocab_mask(extra):
    prompts = np.array([[1, 2, 3], [5, 5, 7], [6, 1, 0]], np.int32)
    out = _both(_greedy_model(**extra), {"input_ids": prompts})["sequences"]
    if "vocab_mask" in extra:
        assert not np.isin(out[:, 3:], [2, 5]).any()
    else:
        # eos banned until 8 tokens: none before the last position
        assert not (out[:, 3:7] == V - 1).any()


def _greedy_with(names, inits):
    node = O.make_node("GreedySearch", names, ["sequences"],
                       domain="com.microsoft", decoder=_decoder_graph(),
                       eos_token_id=V - 1, pad_token_id=0, model_type=0)
    return O.make_model(O.make_graph(
        [node], "gen",
        inputs=[O.make_tensor_value_info("input_ids", np.int32, ["B", "P"])],
        outputs=[O.make_tensor_value_info("sequences", np.int32,
                                          ["B", "L"])],
        initializers=inits))


@pytest.mark.parametrize("case", ["prefix_vocab_mask", "max_length"])
def test_greedy_refusals(case):
    prompts = {"input_ids": np.array([[1, 2, 3]], np.int32)}
    if case == "prefix_vocab_mask":
        data = _greedy_with(["input_ids", "max_length", "", "", "", "pvm"],
                            {"max_length": np.array(9, np.int64),
                             "pvm": np.ones((1, V), np.int32)})
    else:
        data = _greedy_model(max_length=3)        # prompt 3 >= max_length
    with pytest.raises(JaxUnsupported, match=case):
        _jax(data, prompts)
    with pytest.raises(UnsupportedOp, match=case):
        _port(data, prompts)


def test_fed_max_length_is_refused():
    """``max_length`` fed to the graph is a device tensor in the port: the
    loop's length cannot come from the device, so it is refused."""
    node = O.make_node("GreedySearch", ["input_ids", "max_length"],
                       ["sequences"], domain="com.microsoft",
                       decoder=_decoder_graph(), eos_token_id=V - 1,
                       pad_token_id=0, model_type=0)
    g = O.make_graph(
        [node], "gen",
        inputs=[O.make_tensor_value_info("input_ids", np.int32, ["B", "P"]),
                O.make_tensor_value_info("max_length", np.int64, [])],
        outputs=[O.make_tensor_value_info("sequences", np.int32,
                                          ["B", "L"])])
    with pytest.raises(UnsupportedOp, match="max_length"):
        _port(O.make_model(g), {"input_ids": np.array([[1, 2]], np.int32),
                                "max_length": np.array(6, np.int64)})


def _beam_model(max_length, num_beams, num_return=1, extra=None, lp=1.0):
    extra = extra or {}
    names = (["input_ids", "max_length", "", "num_beams",
              "num_return_sequences", "length_penalty"] + list(extra))
    node = O.make_node("BeamSearch", names, ["sequences", "sequences_scores"],
                       domain="com.microsoft", decoder=_decoder_graph(),
                       eos_token_id=V - 1, pad_token_id=0, model_type=0)
    g = O.make_graph(
        [node], "gen",
        inputs=[O.make_tensor_value_info("input_ids", np.int32, ["B", "P"])],
        outputs=[O.make_tensor_value_info("sequences", np.int32,
                                          ["B", "R", "L"]),
                 O.make_tensor_value_info("sequences_scores", np.float32,
                                          ["B", "R"])],
        initializers={"max_length": np.array(max_length, np.int64),
                      "num_beams": np.array(num_beams, np.int64),
                      "num_return_sequences": np.array(num_return, np.int64),
                      "length_penalty": np.array(lp, np.float32), **extra})
    return O.make_model(g)


def test_beam1_equals_greedy(oracle):
    _, greedy, _ = oracle
    prompts = np.array([[1, 2, 3]], np.int32)
    res = _both(_beam_model(9, 1), {"input_ids": prompts})
    got = [int(t) for t in res["sequences"][0, 0]]
    want = greedy(prompts[0], 9)
    if V - 1 in want[3:]:
        stop = want.index(V - 1, 3)
        assert got[:stop + 1] == want[:stop + 1]
    else:
        assert got == want


def test_beam_full_width_is_exhaustive(oracle):
    """W = V keeps every 1-token prefix: with 2 generated tokens the best
    hypothesis equals brute force over all V² continuations (an eos-first
    candidate banks at its own length)."""
    _, _, seq_logprob = oracle
    prompts = np.array([[1, 2, 3]], np.int32)
    res = _both(_beam_model(5, V), {"input_ids": prompts})
    got = res["sequences"][0, 0]
    score = float(res["sequences_scores"][0, 0])

    def pen_score(gen):
        return seq_logprob(prompts[0], gen) / len(gen)

    best = -np.inf
    for cand in itertools.product(range(V), repeat=2):
        best = max(best, pen_score([cand[0]]) if cand[0] == V - 1
                   else pen_score(list(cand)))
    assert score == pytest.approx(best, rel=1e-4)
    gen = [int(t) for t in got[3:]]
    if V - 1 in gen:
        gen = gen[:gen.index(V - 1) + 1]
    assert pen_score(gen) == pytest.approx(best, rel=1e-4)


def test_beam_num_return_sequences_sorted():
    prompts = np.array([[1, 2], [3, 4]], np.int32)
    res = _both(_beam_model(6, 4, num_return=3), {"input_ids": prompts})
    assert res["sequences"].shape == (2, 3, 6)
    assert (np.diff(res["sequences_scores"], axis=1) <= 1e-6).all()


def test_beam_penalties_mask_and_left_padding():
    prompts = np.array([[1, 2, 3, 4], [0, 0, 5, 6], [7, 7, 7, 1]], np.int32)
    mask = np.array([[1, 1, 1, 1], [0, 0, 1, 1], [1, 1, 1, 1]], np.float32)
    names = (["input_ids", "max_length", "min_length", "num_beams",
              "num_return_sequences", "length_penalty",
              "repetition_penalty", "vocab_mask", "", "attention_mask"])
    node = O.make_node("BeamSearch", names, ["sequences", "sequences_scores"],
                       domain="com.microsoft", decoder=_decoder_graph(),
                       eos_token_id=V - 1, pad_token_id=0, model_type=0)
    g = O.make_graph(
        [node], "gen",
        inputs=[O.make_tensor_value_info("input_ids", np.int32, ["B", "P"]),
                O.make_tensor_value_info("attention_mask", np.float32,
                                         ["B", "P"])],
        outputs=[O.make_tensor_value_info("sequences", np.int32,
                                          ["B", "R", "L"]),
                 O.make_tensor_value_info("sequences_scores", np.float32,
                                          ["B", "R"])],
        initializers={"max_length": np.array(10, np.int64),
                      "min_length": np.array(6, np.int64),
                      "num_beams": np.array(3, np.int64),
                      "num_return_sequences": np.array(2, np.int64),
                      "length_penalty": np.array(0.7, np.float32),
                      "repetition_penalty": np.array(1.5, np.float32),
                      "vocab_mask": np.array([1, 1, 1, 0, 1, 1, 1, 1],
                                             np.int32)})
    res = _both(O.make_model(g), {"input_ids": prompts,
                                  "attention_mask": mask})
    assert not (res["sequences"][:, :, 4:] == 3).any()


def test_beam_validation():
    prompts = {"input_ids": np.array([[1, 2]], np.int32)}
    for data, match in [(_beam_model(6, 2, num_return=3),
                         "num_return_sequences"),
                        (_beam_model(6, V + 1), "exceeds vocab")]:
        with pytest.raises(JaxUnsupported, match=match):
            _jax(data, prompts)
        with pytest.raises(UnsupportedOp, match=match):
            _port(data, prompts)


@pytest.mark.parametrize("op", ["GreedySearch", "BeamSearch"])
def test_chip_smoke_generation_graphs_match_the_reference(op):
    """Phase 20e's graph builders (a GPT-style decoder of several layers,
    each with its own past/present) at a small width, through both
    converters, left-padding aside."""
    import sys
    from pathlib import Path
    root = str(Path(__file__).resolve().parents[1])
    if root not in sys.path:
        sys.path.insert(0, root)
    from chip_smoke import gpt_decoder_graph, ort_generation_onnx
    dec = gpt_decoder_graph(64, 32, 4, 2, 32, seed=3)
    data = ort_generation_onnx(op, dec, 14, 63, num_beams=3)
    ids = np.random.default_rng(6).integers(1, 64, (3, 5)).astype(np.int32)
    out = _both(data, {"input_ids": ids})
    assert out["sequences"].shape[-1] == 14

"""The port's featurize package (``mmlspark_tpu_torch/featurize/``)
against the JAX package's on the CPU.

Every stage here is host numpy in both packages, so the same frame, made
from a numpy seed, must come out bitwise the same: plans, one-hot and
hashed blocks, token lists, n-grams, hashed term counts (dense and scipy
CSR), WordPiece ids and masks, indexed levels and their metadata. The
one tolerance is IDF's, 1e-12 absolute on the weights and the weighted
counts (a log of counts in float64, then float32: bitwise in practice,
the tolerance states what the contract is). ``_same_frame`` and
``frames`` are shared with ``test_torch_train_automl.py`` and
``test_torch_stages_balance.py``."""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from mmlspark_tpu import featurize as jf
from mmlspark_tpu.core import DataFrame as JDataFrame
from mmlspark_tpu.core.dataframe import object_col as jobject_col
from mmlspark_tpu_torch import featurize as pf
from mmlspark_tpu_torch.core import DataFrame
from mmlspark_tpu_torch.core.dataframe import object_col

torch.set_num_threads(1)  # one a worker: README, "Testing & benchmarks"

IDF_TOL = dict(rtol=0, atol=1e-12)


# ---------------------------------------------------------------------------
# shared helpers


def _copy_col(v):
    if isinstance(v, np.ndarray) and v.dtype == object:
        return (jobject_col, object_col, [_copy_val(x) for x in v])
    return None


def _copy_val(x):
    if sp.issparse(x):
        return x.copy()
    if isinstance(x, np.ndarray):
        return x.copy()
    if isinstance(x, list):
        return list(x)
    return x


def frames(cols, npartitions=1):
    """(JAX frame, port frame) over independent copies of ``cols``."""
    j, p = {}, {}
    for name, v in cols.items():
        made = _copy_col(v)
        if made is not None:
            j[name] = made[0](made[2])
            p[name] = made[1]([_copy_val(x) for x in made[2]])
        else:
            j[name] = np.array(v, copy=True)
            p[name] = np.array(v, copy=True)
    return (JDataFrame(j, npartitions=npartitions),
            DataFrame(p, npartitions=npartitions))


def same_value(a, b, where=""):
    """Bitwise equality of two column cells or metadata values (NaN equal
    to NaN, dtypes and shapes equal, scipy matrices by their arrays)."""
    if sp.issparse(a) or sp.issparse(b):
        assert sp.issparse(a) and sp.issparse(b), where
        a, b = a.tocsr(), b.tocsr()
        assert a.shape == b.shape and a.dtype == b.dtype, where
        for x, y in ((a.indices, b.indices), (a.indptr, b.indptr),
                     (a.data, b.data)):
            np.testing.assert_array_equal(x, y, err_msg=where)
        return
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, \
            (where, a.dtype, b.dtype, a.shape, b.shape)
        if a.dtype == object:
            for i, (x, y) in enumerate(zip(a.ravel(), b.ravel())):
                same_value(x, y, f"{where}[{i}]")
        else:
            np.testing.assert_array_equal(a, b, err_msg=where)
        return
    if isinstance(a, dict):
        assert isinstance(b, dict) and sorted(a) == sorted(b), where
        for k in a:
            same_value(a[k], b[k], f"{where}.{k}")
        return
    if isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            same_value(x, y, f"{where}[{i}]")
        return
    if isinstance(a, float) and np.isnan(a):
        assert isinstance(b, float) and np.isnan(b), where
        return
    assert type(a) is type(b) and a == b, (where, a, b)


def same_frame(jdf, pdf, meta=True):
    """Columns, values, dtypes, partitions and column metadata equal."""
    assert jdf.columns == pdf.columns
    assert len(jdf) == len(pdf)
    assert jdf.npartitions == pdf.npartitions
    for c in jdf.columns:
        same_value(jdf[c], pdf[c], c)
        if meta:
            same_value(jdf.column_metadata(c), pdf.column_metadata(c),
                       f"{c} metadata")


def same_raise(fn_j, fn_p, exc=ValueError):
    with pytest.raises(exc) as ej:
        fn_j()
    with pytest.raises(exc) as ep:
        fn_p()
    assert type(ej.value) is type(ep.value)
    assert str(ej.value) == str(ep.value)


def mixed_cols(n=40, seed=0, levels=4, words=30):
    """Numeric with NaNs, an int column, a categorical string column, a
    free-text column, an object vector column and a 2-D numeric one."""
    rng = np.random.default_rng(seed)
    num = rng.normal(0, 1, n)
    num[rng.random(n) < 0.15] = np.nan
    vocab = [f"w{i}" for i in range(words)]
    text = np.empty(n, dtype=object)
    for i in range(n):
        k = int(rng.integers(1, 6))
        text[i] = " ".join(rng.choice(vocab, k)).upper() if i % 3 == 0 \
            else " ".join(rng.choice(vocab, k))
    vec = np.empty(n, dtype=object)
    for i in range(n):
        vec[i] = rng.normal(0, 1, 3)
    return {"num": num, "cnt": rng.integers(0, 9, n),
            "cat": np.array([f"c{int(v)}" for v in
                             rng.integers(0, levels, n)], dtype=object),
            "text": text, "vec": vec,
            "mat": rng.normal(0, 1, (n, 2)).astype(np.float32)}


# ---------------------------------------------------------------------------
# Featurize and VectorAssembler


@pytest.mark.parametrize("one_hot,num_features,impute", [
    (True, 256, True), (True, 8, True), (False, 16, True),
    (True, 256, False)])
def test_featurize_plans_and_outputs_bitwise(one_hot, num_features, impute):
    cols = mixed_cols()
    jdf, pdf = frames(cols)
    names = ["num", "cnt", "cat", "text", "vec", "mat"]
    kw = dict(one_hot_encode_categoricals=one_hot, num_features=num_features,
              impute_missing=impute)
    jm = jf.Featurize(names, **kw).fit(jdf)
    pm = pf.Featurize(names, **kw).fit(pdf)
    same_value(jm.get("plans"), pm.get("plans"), "plans")
    kinds = [p["kind"] for p in pm.get("plans")]
    assert kinds[0] == "numeric" and kinds[4:] == ["vector", "vector"]
    same_frame(jm.transform(jdf), pm.transform(pdf))
    # a serving frame: unseen levels, NaNs the training frame lacked
    new = mixed_cols(n=25, seed=1, levels=7, words=45)
    jnew, pnew = frames(new)
    same_frame(jm.transform(jnew), pm.transform(pnew))


def test_featurize_reads_categorical_metadata_and_round_trips(tmp_path):
    cols = mixed_cols(n=30, seed=2)
    jdf, pdf = frames(cols)
    jdf = jf.ValueIndexer(input_col="cat", output_col="cat").fit(jdf) \
        .transform(jdf)
    pdf = pf.ValueIndexer(input_col="cat", output_col="cat").fit(pdf) \
        .transform(pdf)
    jdf = jf.IndexToValue(input_col="cat", output_col="cat_s").transform(jdf)
    pdf = pf.IndexToValue(input_col="cat", output_col="cat_s").transform(pdf)
    same_frame(jdf, pdf)
    jm = jf.Featurize(["num", "cat_s", "text"]).fit(jdf)
    pm = pf.Featurize(["num", "cat_s", "text"]).fit(pdf)
    same_value(jm.get("plans"), pm.get("plans"))
    pm.save(str(tmp_path / "fm"))
    back = pf.FeaturizeModel.load(str(tmp_path / "fm"))
    same_frame(jm.transform(jdf), back.transform(pdf))


def test_featurize_rejects_what_jax_rejects():
    jdf, pdf = frames({"d": np.array([None, {"a": 1}], dtype=object)})
    same_raise(lambda: jf.Featurize(["d"]).fit(jdf),
               lambda: pf.Featurize(["d"]).fit(pdf), TypeError)


@pytest.mark.parametrize("handle", ["error", "keep"])
def test_vector_assembler_bitwise(handle):
    cols = mixed_cols(n=12, seed=3)
    cols["num"][:] = np.nan_to_num(cols["num"]) if handle == "error" \
        else cols["num"]
    jdf, pdf = frames(cols)
    names = ["num", "cnt", "vec", "mat"]
    same_frame(jf.VectorAssembler(input_cols=names, output_col="f",
                                  handle_invalid=handle).transform(jdf),
               pf.VectorAssembler(input_cols=names, output_col="f",
                                  handle_invalid=handle).transform(pdf))
    bad_j, bad_p = frames({"a": np.array([1.0, np.nan])})
    same_raise(lambda: jf.VectorAssembler(input_cols=["a"],
                                          output_col="f").transform(bad_j),
               lambda: pf.VectorAssembler(input_cols=["a"],
                                          output_col="f").transform(bad_p))


# ---------------------------------------------------------------------------
# text stages


DOCS = ["The cat sat on the mat", "a dog", "", "Ünïcode wörds, and — dashes!",
        "the  cat   ran far far away", "GREAT film great PLOT plot plot"]


def _docs(n=None, seed=0):
    if n is None:
        return np.array(DOCS, dtype=object)
    rng = np.random.default_rng(seed)
    vocab = [f"t{i}" for i in range(60)] + ["the", "a", "of", "ünï"]
    out = np.empty(n, dtype=object)
    for i in range(n):
        out[i] = " ".join(rng.choice(vocab, int(rng.integers(0, 12))))
    return out


def test_fnv1a_bitwise():
    from mmlspark_tpu.featurize.text import _fnv1a as jfnv
    from mmlspark_tpu_torch.featurize.text import _fnv1a as pfnv
    for tok in ["", "a", "the", "ünïcode", "日本語", "x" * 300] + \
            [f"t{i}" for i in range(200)]:
        for n in (1, 7, 64, 1 << 12, 1 << 18, 2 ** 32 - 1):
            assert pfnv(tok, n) == jfnv(tok, n)


@pytest.mark.parametrize("lower,pattern,min_len", [
    (True, r"\s+", 1), (False, r"\s+", 1), (True, r"[^a-zü]+", 2)])
def test_tokenizer_and_ngrams_bitwise(lower, pattern, min_len):
    jdf, pdf = frames({"text": _docs()})
    kw = dict(input_col="text", output_col="toks", to_lowercase=lower,
              pattern=pattern, min_token_length=min_len)
    jt = jf.Tokenizer(**kw).transform(jdf)
    pt = pf.Tokenizer(**kw).transform(pdf)
    same_frame(jt, pt)
    for n in (1, 2, 3):
        same_frame(jf.NGram(input_col="toks", output_col="g", n=n)
                   .transform(jt),
                   pf.NGram(input_col="toks", output_col="g", n=n)
                   .transform(pt))
    same_frame(jf.MultiNGram(input_col="toks", output_col="g",
                             lengths=[1, 2, 3]).transform(jt),
               pf.MultiNGram(input_col="toks", output_col="g",
                             lengths=[1, 2, 3]).transform(pt))


@pytest.mark.parametrize("sparse", [False, True])
@pytest.mark.parametrize("binary", [False, True])
@pytest.mark.parametrize("num_features", [16, 1 << 12])
def test_hashing_tf_dense_and_csr_bitwise_and_idf(sparse, binary,
                                                  num_features):
    jdf, pdf = frames({"text": _docs(40, seed=4)})
    jt = jf.Tokenizer(input_col="text", output_col="toks").transform(jdf)
    pt = pf.Tokenizer(input_col="text", output_col="toks").transform(pdf)
    kw = dict(input_col="toks", output_col="tf", num_features=num_features,
              binary=binary, sparse=sparse)
    jtf = jf.HashingTF(**kw).transform(jt)
    ptf = pf.HashingTF(**kw).transform(pt)
    same_frame(jtf, ptf)
    assert sp.issparse(ptf["tf"][0]) == sparse
    for mdf in (0, 2):
        jm = jf.IDF(input_col="tf", output_col="w", min_doc_freq=mdf).fit(jtf)
        pm = pf.IDF(input_col="tf", output_col="w", min_doc_freq=mdf).fit(ptf)
        np.testing.assert_allclose(pm.get("idf"), jm.get("idf"), **IDF_TOL)
        assert pm.get("idf").dtype == np.float32
        jo, po = jm.transform(jtf), pm.transform(ptf)
        for a, b in zip(jo["w"], po["w"]):
            if sparse:
                np.testing.assert_array_equal(a.indices, b.indices)
                a, b = a.data, b.data
            np.testing.assert_allclose(b, a, **IDF_TOL)


@pytest.mark.parametrize("kw", [
    dict(), dict(use_ngram=True, n_gram_length=2), dict(use_idf=False),
    dict(sparse=True, num_features=1 << 18), dict(binary=True,
                                                  to_lowercase=False)])
def test_text_featurizer_bitwise(kw, tmp_path):
    jdf, pdf = frames({"text": _docs(30, seed=5), "y": np.arange(30)})
    jm = jf.TextFeaturizer(input_col="text", output_col="features",
                           **kw).fit(jdf)
    pm = pf.TextFeaturizer(input_col="text", output_col="features",
                           **kw).fit(pdf)
    jo, po = jm.transform(jdf), pm.transform(pdf)
    assert po.columns == jo.columns == ["text", "y", "features"]
    for a, b in zip(jo["features"], po["features"]):
        same_value(a, b)
    pm.save(str(tmp_path / "tf"))
    back = pf.TextFeaturizerModel.load(str(tmp_path / "tf"))
    for a, b in zip(jo["features"], back.transform(pdf)["features"]):
        same_value(a, b)


def test_page_splitter_bitwise():
    docs = np.array(["word " * 100, "ü" * 70 + " x" * 40, "", "nospaces" * 30],
                    dtype=object)
    jdf, pdf = frames({"doc": docs})
    for lo, hi in ((50, 100), (1, 7), (90, 100)):
        kw = dict(input_col="doc", output_col="pages",
                  minimum_page_length=lo, maximum_page_length=hi)
        same_frame(jf.PageSplitter(**kw).transform(jdf),
                   pf.PageSplitter(**kw).transform(pdf))


# ---------------------------------------------------------------------------
# WordPiece


CORPUS = ["The quick brown fox jumps over the lazy dog.",
          "Tokenizers split unaffable words: un-aff-able!",
          "Café naïve résumé — coöperate, façade; déjà vu?",
          "Numbers 12345 and symbols $%^& (braces) [brackets] {curly}",
          "the the the quick quick brown"] * 3


@pytest.mark.parametrize("size,lowercase", [(60, True), (400, True),
                                            (120, False)])
def test_wordpiece_vocab_and_ids_bitwise(size, lowercase):
    from mmlspark_tpu.featurize import tokenizer as jtok
    from mmlspark_tpu_torch.featurize import tokenizer as ptok
    jv = jtok.build_wordpiece_vocab(CORPUS, size=size, lowercase=lowercase)
    pv = ptok.build_wordpiece_vocab(CORPUS, size=size, lowercase=lowercase)
    assert pv == jv
    for text in CORPUS[:5] + ["", "unseen ☃ xyzzy"]:
        assert ptok.basic_tokenize(text, lowercase) == \
            jtok.basic_tokenize(text, lowercase)
        index = {t: i for i, t in enumerate(pv)}
        for w in ptok.basic_tokenize(text, lowercase):
            assert ptok.wordpiece(w, index) == jtok.wordpiece(w, index)
    texts = np.array(CORPUS[:5] + ["", None, "unseen ☃ xyzzy " * 20],
                     dtype=object)
    jdf, pdf = frames({"text": texts})
    for max_len, special in ((16, True), (64, True), (8, False)):
        kw = dict(input_col="text", max_len=max_len, lowercase=lowercase,
                  add_special_tokens=special)
        jo = jf.BertTokenizer(jv, **kw).transform(jdf)
        po = pf.BertTokenizer(pv, **kw).transform(pdf)
        same_frame(jo, po)
        assert po["ids"].dtype == np.int32 and po["mask"].shape == \
            (len(texts), max_len)


def test_bert_tokenizer_vocab_file_and_errors(tmp_path):
    vocab = pf.build_wordpiece_vocab(CORPUS, size=200)
    path = tmp_path / "vocab.txt"
    path.write_text("\n".join(vocab) + "\n")
    jdf, pdf = frames({"text": np.array(CORPUS[:4], dtype=object)})
    same_frame(jf.BertTokenizer(vocab_file=str(path), input_col="text",
                                max_len=24).transform(jdf),
               pf.BertTokenizer(vocab_file=str(path), input_col="text",
                                max_len=24).transform(pdf))
    same_raise(lambda: jf.BertTokenizer(["a"], input_col="text")
               .transform(jdf),
               lambda: pf.BertTokenizer(["a"], input_col="text")
               .transform(pdf))
    same_raise(lambda: jf.BertTokenizer(vocab, input_col="text", max_len=2)
               .transform(jdf),
               lambda: pf.BertTokenizer(vocab, input_col="text", max_len=2)
               .transform(pdf))
    tok = pf.BertTokenizer(vocab, input_col="text", max_len=24)
    tok.save(str(tmp_path / "bt"))
    back = pf.BertTokenizer.load(str(tmp_path / "bt"))
    same_frame(jf.BertTokenizer(vocab, input_col="text", max_len=24)
               .transform(jdf), back.transform(pdf))


# ---------------------------------------------------------------------------
# indexing, cleaning, conversion, selection


@pytest.mark.parametrize("values", [
    ["b", "a", "b", "c", "a"], [3, 1, 3, 2, 10], [2.5, -1.0, 2.5, 0.0, 7.25]])
def test_value_indexer_round_trip_bitwise(values, tmp_path):
    jdf, pdf = frames({"v": np.array(values, dtype=object
                                     if isinstance(values[0], str)
                                     else None)})
    jm = jf.ValueIndexer(input_col="v", output_col="i").fit(jdf)
    pm = pf.ValueIndexer(input_col="v", output_col="i").fit(pdf)
    same_value(jm.get("levels"), pm.get("levels"))
    jo, po = jm.transform(jdf), pm.transform(pdf)
    same_frame(jo, po)
    same_frame(jf.IndexToValue(input_col="i", output_col="back")
               .transform(jo),
               pf.IndexToValue(input_col="i", output_col="back")
               .transform(po))
    pm.save(str(tmp_path / "vi"))
    same_frame(jo, pf.ValueIndexerModel.load(str(tmp_path / "vi"))
               .transform(pdf))
    unseen = {"v": np.array([values[0], "zzz" if isinstance(values[0], str)
                             else 99], dtype=object)}
    uj, up = frames(unseen)
    same_raise(lambda: jm.transform(uj), lambda: pm.transform(up))
    same_raise(lambda: jf.IndexToValue(input_col="v", output_col="o")
               .transform(jdf),
               lambda: pf.IndexToValue(input_col="v", output_col="o")
               .transform(pdf))


@pytest.mark.parametrize("mode,custom", [("Mean", None), ("Median", None),
                                         ("Custom", -7.5)])
def test_clean_missing_data_bitwise(mode, custom):
    cols = mixed_cols(n=30, seed=6)
    jdf, pdf = frames({"num": cols["num"], "cnt": cols["cnt"]})
    kw = dict(cleaning_mode=mode, custom_value=custom)
    jm = jf.CleanMissingData(["num", "cnt"], ["a", "b"], **kw).fit(jdf)
    pm = pf.CleanMissingData(["num", "cnt"], ["a", "b"], **kw).fit(pdf)
    same_value(jm.get("fill_values"), pm.get("fill_values"))
    same_frame(jm.transform(jdf), pm.transform(pdf))
    jm2 = jf.CleanMissingData(["num"], **kw).fit(jdf)
    pm2 = pf.CleanMissingData(["num"], **kw).fit(pdf)
    same_frame(jm2.transform(jdf), pm2.transform(pdf))


@pytest.mark.parametrize("target", ["boolean", "byte", "short", "integer",
                                    "long", "float", "double", "string",
                                    "toCategorical", "clearCategorical",
                                    "date"])
def test_data_conversion_bitwise(target):
    if target == "date":
        cols = {"x": np.array(["2024-01-02 03:04:05", "1999-12-31 23:59:59"],
                              dtype=object)}
    else:
        cols = {"x": np.array([1.5, -2.5, 300.25, 0.0])}
    jdf, pdf = frames(cols)
    if target == "clearCategorical":
        jdf = jf.DataConversion(input_cols=["x"], convert_to="toCategorical"
                                ).transform(jdf)
        pdf = pf.DataConversion(input_cols=["x"], convert_to="toCategorical"
                                ).transform(pdf)
    same_frame(jf.DataConversion(input_cols=["x"], convert_to=target)
               .transform(jdf),
               pf.DataConversion(input_cols=["x"], convert_to=target)
               .transform(pdf))


def test_count_selector_bitwise(tmp_path):
    rng = np.random.default_rng(7)
    X = rng.normal(0, 1, (9, 6))
    X[:, [1, 4]] = 0.0
    X[3, 4] = 2.0
    jdf, pdf = frames({"features": object_col(list(X))})
    jm = jf.CountSelector(input_col="features", output_col="out").fit(jdf)
    pm = pf.CountSelector(input_col="features", output_col="out").fit(pdf)
    assert pm.get("indices") == jm.get("indices") == [0, 2, 3, 4, 5]
    same_frame(jm.transform(jdf), pm.transform(pdf))
    pm.save(str(tmp_path / "cs"))
    same_frame(jm.transform(jdf),
               pf.CountSelectorModel.load(str(tmp_path / "cs"))
               .transform(pdf))


def test_exports_match_the_jax_package():
    assert sorted(pf.__all__) == sorted(jf.__all__)

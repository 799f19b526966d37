"""Text featurization.

Parity surface: ``TextFeaturizer:197`` (tokenize → n-grams → hashing TF →
IDF), ``MultiNGram:25`` (several n-gram widths concatenated), ``PageSplitter:23``
(split documents into byte-bounded pages) — reference
``core/.../featurize/text/*.scala``. The hashing-TF → IDF product is a dense
matmul-shaped op, so fitted transforms stay vectorized numpy feeding the
device path.

The port's copy of ``mmlspark_tpu/featurize/text.py`` (numpy (and scipy
CSR) only, host work; ``_fnv1a`` is bitwise the JAX package's).
"""

from __future__ import annotations

import re
from typing import List

import numpy as np

try:                            # guarded like models/gbdt/binning.py
    import scipy.sparse as _sp
except Exception:               # pragma: no cover - scipy is in the image
    _sp = None

from ..core.dataframe import DataFrame
from ..core.params import HasInputCol, HasOutputCol, Param
from ..core.pipeline import Estimator, Model, Transformer

__all__ = ["Tokenizer", "NGram", "MultiNGram", "HashingTF", "IDF", "IDFModel",
           "TextFeaturizer", "TextFeaturizerModel", "PageSplitter"]


def _fnv1a(token: str, n_features: int) -> int:
    h = 0x811C9DC5
    for b in token.encode("utf-8"):
        h = ((h ^ b) * 0x01000193) & 0xFFFFFFFF
    return h % n_features


class Tokenizer(Transformer, HasInputCol, HasOutputCol):
    pattern = Param(str, default=r"\s+", doc="split regex")
    to_lowercase = Param(bool, default=True, doc="lowercase before split")
    min_token_length = Param(int, default=1, doc="drop shorter tokens")

    def _transform(self, df: DataFrame) -> DataFrame:
        rx = re.compile(self.get("pattern"))
        out = np.empty(len(df), dtype=object)
        for i, text in enumerate(df[self.get("input_col")]):
            t = str(text)
            if self.get("to_lowercase"):
                t = t.lower()
            out[i] = [tok for tok in rx.split(t)
                      if len(tok) >= self.get("min_token_length")]
        return df.with_column(self.get("output_col"), out)


class NGram(Transformer, HasInputCol, HasOutputCol):
    n = Param(int, default=2, doc="gram width")

    def _transform(self, df: DataFrame) -> DataFrame:
        n = self.get("n")
        out = np.empty(len(df), dtype=object)
        for i, toks in enumerate(df[self.get("input_col")]):
            out[i] = [" ".join(toks[j:j + n]) for j in range(len(toks) - n + 1)]
        return df.with_column(self.get("output_col"), out)


class MultiNGram(Transformer, HasInputCol, HasOutputCol):
    """Concatenate n-grams for several widths
    (reference ``featurize/text/MultiNGram.scala:25``)."""

    lengths = Param((list, int), default=[1, 2, 3], doc="gram widths")

    def _transform(self, df: DataFrame) -> DataFrame:
        widths = self.get("lengths")
        out = np.empty(len(df), dtype=object)
        for i, toks in enumerate(df[self.get("input_col")]):
            grams: List[str] = []
            for n in widths:
                grams.extend(" ".join(toks[j:j + n])
                             for j in range(len(toks) - n + 1))
            out[i] = grams
        return df.with_column(self.get("output_col"), out)


class HashingTF(Transformer, HasInputCol, HasOutputCol):
    # dense vectors by default (they feed device matmuls), so the default
    # hash space is far below the reference's sparse 2^18; ``sparse=True``
    # emits scipy CSR row vectors (Spark HashingTF's SparseVector shape),
    # which lets num_features grow to the reference's 2^18+ and feeds the
    # sparse GBDT / EFB path without densifying
    num_features = Param(int, default=1 << 12, doc="hash space size")
    binary = Param(bool, default=False, doc="presence instead of counts")
    sparse = Param(bool, default=False,
                   doc="emit scipy CSR row vectors instead of dense")

    def _transform(self, df: DataFrame) -> DataFrame:
        n = self.get("num_features")
        use_sparse = self.get("sparse")
        out = np.empty(len(df), dtype=object)
        if use_sparse and _sp is None:     # pragma: no cover
            raise ImportError("HashingTF(sparse=True) requires scipy")
        for i, toks in enumerate(df[self.get("input_col")]):
            if use_sparse:
                hashed = np.fromiter((_fnv1a(t, n) for t in toks),
                                     dtype=np.int64, count=len(toks))
                idx, counts = np.unique(hashed, return_counts=True)
                vals = (np.ones(len(idx), np.float32) if self.get("binary")
                        else counts.astype(np.float32))
                out[i] = _sp.csr_matrix(
                    (vals, idx, np.array([0, len(idx)])), shape=(1, n))
                continue
            vec = np.zeros(n, dtype=np.float32)
            for tok in toks:
                vec[_fnv1a(tok, n)] += 1.0
            if self.get("binary"):
                vec = (vec > 0).astype(np.float32)
            out[i] = vec
        return df.with_column(self.get("output_col"), out)


class IDF(Estimator, HasInputCol, HasOutputCol):
    min_doc_freq = Param(int, default=0, doc="zero out rare terms")

    def _fit(self, df: DataFrame) -> "IDFModel":
        col = df[self.get("input_col")]
        # incremental docfreq: never materialize the (n_docs, n_features) stack
        docfreq = None
        for v in col:
            if _sp is not None and _sp.issparse(v):
                v = v.tocsr()
                if docfreq is None:
                    docfreq = np.zeros(v.shape[1], dtype=np.int64)
                # unique: a non-canonical CSR with a repeated index must
                # count once per document (dense presence semantics)
                np.add.at(docfreq, np.unique(v.indices[v.data > 0]), 1)
                continue
            row = np.asarray(v) > 0
            docfreq = row.astype(np.int64) if docfreq is None else docfreq + row
        n = len(col)
        if docfreq is None:
            docfreq = np.zeros(0, dtype=np.int64)
        idf = np.log((n + 1.0) / (docfreq + 1.0))
        idf[docfreq < self.get("min_doc_freq")] = 0.0
        m = IDFModel()
        m.set(input_col=self.get("input_col"), output_col=self.get("output_col"),
              idf=idf.astype(np.float32))
        return m


class IDFModel(Model, HasInputCol, HasOutputCol):
    from ..core.params import ComplexParam as _CP
    idf = _CP(default=None, doc="per-slot idf weights")

    def _transform(self, df: DataFrame) -> DataFrame:
        idf = np.asarray(self.get("idf"))
        col = df[self.get("input_col")]
        out = np.empty(len(col), dtype=object)
        for i, v in enumerate(col):
            if _sp is not None and _sp.issparse(v):
                r = v.tocsr().astype(np.float32)
                r.data = r.data * idf[r.indices].astype(np.float32)
                out[i] = r
            else:
                out[i] = (np.asarray(v, dtype=np.float32) * idf)
        return df.with_column(self.get("output_col"), out)


class TextFeaturizer(Estimator, HasInputCol, HasOutputCol):
    """Composed tokenize → [n-gram] → hashing TF → [IDF] pipeline
    (reference ``featurize/text/TextFeaturizer.scala:197``)."""

    use_tokenizer = Param(bool, default=True, doc="split text into tokens")
    tokenizer_pattern = Param(str, default=r"\s+", doc="split regex")
    to_lowercase = Param(bool, default=True, doc="lowercase text")
    use_ngram = Param(bool, default=False, doc="insert an n-gram stage")
    n_gram_length = Param(int, default=2, doc="gram width")
    num_features = Param(int, default=1 << 12, doc="hash space size")
    binary = Param(bool, default=False, doc="binary term counts")
    use_idf = Param(bool, default=True, doc="apply inverse document frequency")
    min_doc_freq = Param(int, default=1, doc="IDF min document frequency")
    sparse = Param(bool, default=False,
                   doc="emit scipy CSR row vectors (enables reference-scale "
                       "2^18 hash spaces; feeds the sparse GBDT/EFB path)")

    def _fit(self, df: DataFrame) -> "TextFeaturizerModel":
        from ..core.pipeline import Pipeline
        inp, outp = self.get("input_col"), self.get("output_col")
        stages: List = []
        cur = inp
        if self.get("use_tokenizer"):
            stages.append(Tokenizer(input_col=cur, output_col="_tf_tokens",
                                    pattern=self.get("tokenizer_pattern"),
                                    to_lowercase=self.get("to_lowercase")))
            cur = "_tf_tokens"
        if self.get("use_ngram"):
            stages.append(NGram(input_col=cur, output_col="_tf_ngrams",
                                n=self.get("n_gram_length")))
            cur = "_tf_ngrams"
        tf_out = "_tf_counts" if self.get("use_idf") else outp
        stages.append(HashingTF(input_col=cur, output_col=tf_out,
                                num_features=self.get("num_features"),
                                binary=self.get("binary"),
                                sparse=self.get("sparse")))
        if self.get("use_idf"):
            stages.append(IDF(input_col=tf_out, output_col=outp,
                              min_doc_freq=self.get("min_doc_freq")))
        pipeline_model = Pipeline(stages).fit(df)
        m = TextFeaturizerModel()
        m.set(input_col=inp, output_col=outp, pipeline=pipeline_model)
        return m


class TextFeaturizerModel(Model, HasInputCol, HasOutputCol):
    from ..core.params import ComplexParam as _CP
    pipeline = _CP(default=None, doc="fitted internal pipeline")

    def _transform(self, df: DataFrame) -> DataFrame:
        out = self.get("pipeline").transform(df)
        return out.drop("_tf_tokens", "_tf_ngrams", "_tf_counts")


class PageSplitter(Transformer, HasInputCol, HasOutputCol):
    """Split documents into byte-bounded pages on whitespace/word boundaries
    (reference ``featurize/text/PageSplitter.scala:23``)."""

    maximum_page_length = Param(int, default=5000, doc="max bytes per page")
    minimum_page_length = Param(int, default=4500,
                                doc="prefer boundaries after this many bytes")
    boundary_regex = Param(str, default=r"\s", doc="soft break pattern")

    def _transform(self, df: DataFrame) -> DataFrame:
        lo, hi = self.get("minimum_page_length"), self.get("maximum_page_length")
        rx = re.compile(self.get("boundary_regex"))
        out = np.empty(len(df), dtype=object)
        for i, text in enumerate(df[self.get("input_col")]):
            t = str(text)
            nbytes = [len(ch.encode("utf-8")) for ch in t]
            pages, start = [], 0
            while start < len(t):
                # greedily take chars while the page stays within hi BYTES,
                # remembering the last soft boundary past lo bytes
                size, j, soft = 0, start, None
                while j < len(t) and size + nbytes[j] <= hi:
                    size += nbytes[j]
                    j += 1
                    if size >= lo and rx.match(t[j - 1]):
                        soft = j
                if j >= len(t):
                    pages.append(t[start:])
                    break
                cut = soft if soft is not None else max(j, start + 1)
                pages.append(t[start:cut])
                start = cut
            out[i] = pages
        return df.with_column(self.get("output_col"), out)

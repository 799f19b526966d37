"""WordPiece tokenization: text columns → token-id tensors.

The reference leans on upstream tooling for subword tokenization (its text
stages are hashing/n-gram based, ``featurize/text``); a standalone TPU
framework running BERT-class ONNX/JAX models needs the text→ids step
in-pipeline. This is a dependency-free WordPiece implementation with the
standard BERT semantics:

* basic tokenization: lowercasing (optional), punctuation splitting,
  whitespace normalization;
* greedy longest-match-first WordPiece with ``##`` continuation pieces and
  ``[UNK]`` fallback;
* fixed-length output (``[CLS]`` ... ``[SEP]`` + padding) so the id/mask
  columns are dense ``(n, max_len)`` tensors ready for ``device_put``.

``build_wordpiece_vocab`` derives a workable vocab from a corpus
(frequency-ranked words + their prefixes/suffix pieces) for self-contained
pipelines and tests; production vocabs load via ``vocab=list`` or
``vocab_file``.

The port's copy of ``mmlspark_tpu/featurize/tokenizer.py`` (pure Python,
host work; its ids feed the port's BERT ONNX graphs).
"""

from __future__ import annotations

import unicodedata
from collections import Counter
from typing import Dict, List, Optional, Sequence

import numpy as np

from ..core.dataframe import DataFrame
from ..core.params import ComplexParam, HasInputCol, Param
from ..core.pipeline import Transformer

__all__ = ["BertTokenizer", "build_wordpiece_vocab"]

PAD, UNK, CLS, SEP, MASK = "[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"
SPECIALS = [PAD, UNK, CLS, SEP, MASK]


def _is_punct(ch: str) -> bool:
    cp = ord(ch)
    if (33 <= cp <= 47) or (58 <= cp <= 64) or (91 <= cp <= 96) \
            or (123 <= cp <= 126):
        return True
    return unicodedata.category(ch).startswith("P")


def basic_tokenize(text: str, lowercase: bool = True) -> List[str]:
    if lowercase:
        text = text.lower()
    out: List[str] = []
    word = []
    for ch in text:
        if ch.isspace():
            if word:
                out.append("".join(word))
                word = []
        elif _is_punct(ch):
            if word:
                out.append("".join(word))
                word = []
            out.append(ch)
        else:
            word.append(ch)
    if word:
        out.append("".join(word))
    return out


def wordpiece(word: str, vocab: Dict[str, int],
              max_chars: int = 100) -> List[str]:
    """Greedy longest-match-first (the BERT algorithm)."""
    if len(word) > max_chars:
        return [UNK]
    pieces: List[str] = []
    start = 0
    while start < len(word):
        end = len(word)
        piece = None
        while start < end:
            sub = word[start:end]
            if start > 0:
                sub = "##" + sub
            if sub in vocab:
                piece = sub
                break
            end -= 1
        if piece is None:
            return [UNK]
        pieces.append(piece)
        start = end
    return pieces


def build_wordpiece_vocab(corpus: Sequence[str], size: int = 8000,
                          lowercase: bool = True) -> List[str]:
    """Frequency-derived vocab: specials + single chars (+ their ##
    continuations) + the most frequent whole words, then frequent suffix
    pieces — enough coverage that common words tokenize whole and rare
    words split instead of hitting [UNK]."""
    words = Counter()
    chars = Counter()
    for text in corpus:
        for w in basic_tokenize(text, lowercase):
            words[w] += 1
            chars.update(w)
    vocab: List[str] = list(SPECIALS)
    seen = set(vocab)

    def add(tok: str):
        if tok and tok not in seen:
            vocab.append(tok)
            seen.add(tok)

    for ch, _ in chars.most_common():
        add(ch)
        add("##" + ch)
    for w, _ in words.most_common():
        if len(vocab) >= size:
            break
        add(w)
    # suffix pieces of frequent words give partial-match coverage
    for w, _ in words.most_common(2000):
        if len(vocab) >= size:
            break
        for i in range(1, len(w)):
            add("##" + w[i:])
            if len(vocab) >= size:
                break
    return vocab[:size]


class BertTokenizer(Transformer, HasInputCol):
    """Text column → dense ``(n, max_len)`` int32 ``ids``/``mask`` columns.

    ``vocab`` is a ComplexParam (persisted with the stage); ``vocab_file``
    (one token per line, BERT format) is the interop path."""

    vocab = ComplexParam(default=None, doc="token list, index = id")
    vocab_file = Param(str, default=None,
                       converter=lambda v: v,
                       doc="path to a BERT-format vocab.txt (one token "
                           "per line); loaded when `vocab` is unset")
    max_len = Param(int, default=128, doc="output sequence length")
    lowercase = Param(bool, default=True, doc="lowercase before splitting")
    ids_col = Param(str, default="ids", doc="output token-id column")
    mask_col = Param(str, default="mask", doc="output attention-mask column")
    add_special_tokens = Param(bool, default=True,
                               doc="wrap with [CLS] ... [SEP]")

    def __init__(self, vocab: Optional[Sequence[str]] = None, **kw):
        super().__init__(**kw)
        if vocab is not None:
            self.set(vocab=list(vocab))
        self._index: Optional[Dict[str, int]] = None

    def set(self, **kwargs):
        out = super().set(**kwargs)
        if kwargs and hasattr(self, "_index"):
            self._index = None  # vocab/vocab_file changes invalidate cache
        return out

    def copy(self, extra=None):
        other = super().copy(extra)
        other._index = None  # param overrides must not see a stale index
        return other

    def _vocab_index(self) -> Dict[str, int]:
        if self._index is None:
            vocab = self.get_or_none("vocab")
            if vocab is None:
                path = self.get_or_none("vocab_file")
                if not path:
                    raise ValueError(f"{self.uid}: set vocab or vocab_file")
                with open(path) as f:
                    vocab = [ln.rstrip("\n") for ln in f if ln.strip()]
                self.set(vocab=vocab)
            self._index = {tok: i for i, tok in enumerate(vocab)}
            for sp in (PAD, UNK, CLS, SEP):
                if sp not in self._index:
                    raise ValueError(f"vocab missing special token {sp}")
        return self._index

    def encode(self, text: str,
               max_pieces: Optional[int] = None) -> List[int]:
        """``max_pieces`` stops tokenization once the budget is met — long
        documents must not pay full wordpiece cost for discarded tokens."""
        index = self._vocab_index()
        pieces: List[str] = []
        for w in basic_tokenize(text, self.lowercase):
            pieces.extend(wordpiece(w, index))
            if max_pieces is not None and len(pieces) >= max_pieces:
                break
        if max_pieces is not None:
            pieces = pieces[:max_pieces]
        return [index[p] for p in pieces]

    def _transform(self, df: DataFrame) -> DataFrame:
        index = self._vocab_index()
        L = self.max_len
        special = self.add_special_tokens
        body = L - (2 if special else 0)
        if body < 1:
            raise ValueError(
                f"max_len={L} leaves no room for tokens"
                + (" after [CLS]/[SEP]" if special else ""))
        n = len(df)
        ids = np.full((n, L), index[PAD], dtype=np.int32)
        mask = np.zeros((n, L), dtype=np.int32)
        col = df[self.input_col]
        for i in range(n):
            text = col[i]
            toks = self.encode("" if text is None else str(text),
                               max_pieces=body)
            if special:
                toks = [index[CLS]] + toks + [index[SEP]]
            ids[i, :len(toks)] = toks
            mask[i, :len(toks)] = 1
        return (df.with_column(self.ids_col, ids)
                  .with_column(self.mask_col, mask))

    def _load_extra(self, path: str) -> None:
        self._index = None

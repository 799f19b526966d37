"""Featurization (counterpart of ``mmlspark_tpu/featurize/``): the
host stages that turn columns into the feature vectors the learners fit."""

from .clean_missing import CleanMissingData, CleanMissingDataModel
from .count_selector import CountSelector, CountSelectorModel
from .data_conversion import DataConversion
from .featurize import Featurize, FeaturizeModel, VectorAssembler
from .tokenizer import BertTokenizer, build_wordpiece_vocab
from .text import (IDF, HashingTF, IDFModel, MultiNGram, NGram, PageSplitter,
                   TextFeaturizer, TextFeaturizerModel, Tokenizer)
from .value_indexer import IndexToValue, ValueIndexer, ValueIndexerModel

__all__ = [
    "BertTokenizer", "build_wordpiece_vocab", "VectorAssembler",
    "CleanMissingData", "CleanMissingDataModel",
    "CountSelector", "CountSelectorModel",
    "DataConversion",
    "Featurize", "FeaturizeModel",
    "ValueIndexer", "ValueIndexerModel", "IndexToValue",
    "Tokenizer", "NGram", "MultiNGram", "HashingTF", "IDF", "IDFModel",
    "TextFeaturizer", "TextFeaturizerModel", "PageSplitter",
]

"""Text transformers (counterpart of ``bigdl_tpu/dataset/text/transforms.py``):
``Dictionary`` (vocab build/save/load), ``SentenceSplitter`` and
``SentenceTokenizer`` (regex), ``SentenceBiPadding`` (start/end tokens),
``TextToLabeledSentence`` (next-word LM pairs), ``LabeledSentenceToSample``
(one-hot or index encoding with fixed-length padding). Same rules as the
JAX package, so both build the same dictionary and samples from a text.
"""
from __future__ import annotations

import json
import re
from pathlib import Path
from typing import Iterator

import numpy as np

from bigdl_tpu_torch.dataset.sample import LabeledSentence, Sample
from bigdl_tpu_torch.dataset.transformer import Transformer

__all__ = ["Dictionary", "SentenceToken", "SentenceSplitter",
           "SentenceTokenizer", "SentenceBiPadding", "TextToLabeledSentence",
           "LabeledSentenceToSample"]


class SentenceToken:
    """(reference text/utils/SentenceToken)"""
    start = "SENTENCESTART"
    end = "SENTENCEEND"


class Dictionary:
    """Frequency-ranked vocabulary (reference text/Dictionary.scala).

    Words beyond ``vocab_size`` go to the discard list and map to an
    out-of-vocab index == vocab_size (the reference's ``getIndex`` returns
    ``_vocabSize`` for unknown words). Indices are 0-based here.
    """

    def __init__(self, sentences=None, vocab_size: int = 10000):
        self._word2index: dict[str, int] = {}
        self._index2word: dict[int, str] = {}
        self._vocabulary: list[str] = []
        self._discard: list[str] = []
        if sentences is not None:
            freq: dict[str, int] = {}
            for sent in sentences:
                for w in sent:
                    freq[w] = freq.get(w, 0) + 1
            ranked = sorted(freq.items(), key=lambda kv: (-kv[1], kv[0]))
            keep = ranked[:vocab_size]
            self._vocabulary = [w for w, _ in keep]
            self._discard = [w for w, _ in ranked[vocab_size:]]
            self._word2index = {w: i for i, w in enumerate(self._vocabulary)}
            self._index2word = {i: w for w, i in self._word2index.items()}

    @classmethod
    def load(cls, directory: str) -> "Dictionary":
        """(reference Dictionary(directory) — dictionary.txt + discard.txt)"""
        d = cls()
        folder = Path(directory)
        d._word2index = json.loads((folder / "dictionary.txt").read_text())
        d._index2word = {i: w for w, i in d._word2index.items()}
        d._vocabulary = [w for w, _ in sorted(d._word2index.items(),
                                              key=lambda kv: kv[1])]
        discard_file = folder / "discard.txt"
        if discard_file.exists():
            d._discard = discard_file.read_text().split()
        return d

    def save(self, save_folder: str) -> None:
        """(reference Dictionary.save)"""
        folder = Path(save_folder)
        folder.mkdir(parents=True, exist_ok=True)
        (folder / "dictionary.txt").write_text(json.dumps(self._word2index))
        (folder / "discard.txt").write_text("\n".join(self._discard))

    def get_vocab_size(self) -> int:
        return len(self._vocabulary)

    def get_discard_size(self) -> int:
        return len(self._discard)

    def word2index(self) -> dict:
        return dict(self._word2index)

    def index2word(self) -> dict:
        return dict(self._index2word)

    def vocabulary(self):
        return list(self._vocabulary)

    def discard_vocab(self):
        return list(self._discard)

    def get_index(self, word: str) -> int:
        """Unknown words map to vocab_size (reference Dictionary.getIndex)."""
        return self._word2index.get(word, len(self._vocabulary))

    def get_word(self, index) -> str:
        return self._index2word[int(index)]


class SentenceSplitter(Transformer):
    """Text -> sentences (reference SentenceSplitter.scala; OpenNLP sentence
    model -> punctuation regex)."""

    _pat = re.compile(r"(?<=[.!?])\s+")

    def __call__(self, it: Iterator[str]):
        for text in it:
            for sent in self._pat.split(text.strip()):
                if sent:
                    yield sent


class SentenceTokenizer(Transformer):
    """Sentence -> word array (reference SentenceTokenizer.scala; OpenNLP
    tokenizer -> word/punct regex), with optional lowercase."""

    _pat = re.compile(r"\w+(?:'\w+)?|[^\w\s]")

    def __init__(self, lower: bool = True):
        self.lower = lower

    def __call__(self, it: Iterator[str]):
        for sent in it:
            if self.lower:
                sent = sent.lower()
            toks = self._pat.findall(sent)
            if toks:
                yield toks


class SentenceBiPadding(Transformer):
    """Wrap each sentence with start/end tokens
    (reference SentenceBiPadding.scala:196-215)."""

    def __init__(self, start: str | None = None, end: str | None = None):
        self.start = start or SentenceToken.start
        self.end = end or SentenceToken.end

    def __call__(self, it):
        for x in it:
            if isinstance(x, str):
                yield f"{self.start} {x} {self.end}"
            else:
                yield [self.start, *x, self.end]


class TextToLabeledSentence(Transformer):
    """Word array -> next-word LM pair: data = tokens[:-1] indices,
    label = tokens[1:] indices (reference TextToLabeledSentence.scala)."""

    def __init__(self, dictionary: Dictionary):
        self.dictionary = dictionary

    def __call__(self, it):
        for sentence in it:
            idx = np.asarray([self.dictionary.get_index(w) for w in sentence],
                             np.int32)
            if len(idx) < 2:
                continue
            yield LabeledSentence(idx[:-1], idx[1:])


class LabeledSentenceToSample(Transformer):
    """LabeledSentence -> Sample (reference LabeledSentenceToSample.scala).

    ``one_hot=True``: feature (T, vocab) one-hot like the reference's
    dense encoding; labels become 1-based class indices (ClassNLL
    convention). ``fixed_length`` pads data with the end-token index and
    truncates longer sequences.
    """

    def __init__(self, vocab_length: int, fixed_data_length: int | None = None,
                 fixed_label_length: int | None = None, one_hot: bool = True):
        self.vocab_length = vocab_length
        self.fixed_data_length = fixed_data_length
        self.fixed_label_length = fixed_label_length
        self.one_hot = one_hot

    def _fix(self, arr, length, pad_value):
        if length is None or len(arr) == length:
            return arr
        if len(arr) > length:
            return arr[:length]
        return np.concatenate(
            [arr, np.full(length - len(arr), pad_value, arr.dtype)])

    def __call__(self, it):
        for sent in it:
            data = np.asarray(sent.data, np.int32)
            label = np.asarray(sent.label, np.int32)
            end_idx = data[-1] if len(data) else 0
            data = self._fix(data, self.fixed_data_length, end_idx)
            label = self._fix(label, self.fixed_label_length,
                              label[-1] if len(label) else 0)
            if self.one_hot:
                feat = np.zeros((len(data), self.vocab_length), np.float32)
                feat[np.arange(len(data)), np.clip(data, 0,
                                                   self.vocab_length - 1)] = 1
            else:
                feat = data
            yield Sample(feat, label.astype(np.float32) + 1.0)

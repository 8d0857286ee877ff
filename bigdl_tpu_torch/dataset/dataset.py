"""Datasets (counterpart of ``bigdl_tpu/dataset/dataset.py``): the local
in-memory dataset and transforms over it. Sharded and record-file
datasets are not ported yet (ROADMAP.md queue A, The rest)."""
from __future__ import annotations

from typing import Iterator, Sequence

import numpy as np

from bigdl_tpu_torch.dataset.transformer import Transformer
from bigdl_tpu_torch.utils.random import RandomGenerator

__all__ = ["AbstractDataSet", "TransformedDataSet", "LocalArrayDataSet"]


class AbstractDataSet:

    def data(self, train: bool) -> Iterator:
        """Endless looped iterator when ``train``; one pass otherwise."""
        raise NotImplementedError

    def size(self) -> int:
        raise NotImplementedError

    def shuffle(self) -> None:
        raise NotImplementedError

    def transform(self, transformer: Transformer) -> "AbstractDataSet":
        return TransformedDataSet(self, transformer)

    def __rshift__(self, transformer: Transformer) -> "AbstractDataSet":
        return self.transform(transformer)


class TransformedDataSet(AbstractDataSet):
    def __init__(self, base: AbstractDataSet, transformer: Transformer):
        self.base = base
        self.transformer = transformer

    def data(self, train: bool):
        return self.transformer(self.base.data(train))

    def size(self):
        return self.base.size()

    def shuffle(self):
        self.base.shuffle()


class LocalArrayDataSet(AbstractDataSet):
    """Array-backed local dataset: the training iterator loops endlessly
    over an index array that ``shuffle`` re-randomises from
    ``RandomGenerator``."""

    def __init__(self, data: Sequence):
        self._data = list(data)
        self._index = np.arange(len(self._data))

    def data(self, train: bool):
        if train:
            if not self._data:
                raise ValueError("cannot build a training iterator over an "
                                 "empty dataset")

            def endless():
                while True:
                    for i in self._index:
                        yield self._data[i]
            return endless()
        return iter([self._data[i] for i in self._index])

    def size(self):
        return len(self._data)

    def shuffle(self):
        RandomGenerator.RNG().shuffle(self._index)

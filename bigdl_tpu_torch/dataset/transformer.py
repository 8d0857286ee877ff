"""Composable data transformers (counterpart of
``bigdl_tpu/dataset/transformer.py``): a ``Transformer`` is a callable
over iterators; chain with ``>>`` or ``.then()``."""
from __future__ import annotations

from typing import Iterator

import numpy as np

from bigdl_tpu_torch.dataset.sample import MiniBatch

__all__ = ["Transformer", "ChainedTransformer", "SampleToBatch"]


class Transformer:
    """Iterator[A] -> Iterator[B]."""

    def __call__(self, it: Iterator) -> Iterator:
        raise NotImplementedError

    def then(self, other: "Transformer") -> "ChainedTransformer":
        return ChainedTransformer(self, other)

    def __rshift__(self, other: "Transformer") -> "ChainedTransformer":
        return self.then(other)


class ChainedTransformer(Transformer):
    def __init__(self, first: Transformer, last: Transformer):
        self.first, self.last = first, last

    def __call__(self, it):
        return self.last(self.first(it))


class SampleToBatch(Transformer):
    """Group Samples of one shape into MiniBatches; a partial trailing
    batch is emitted unless ``drop_remainder``. (The JAX package's
    fixed-length padding serves the RNN pipelines, not ported yet.)"""

    def __init__(self, batch_size: int, drop_remainder: bool = False):
        self.batch_size = batch_size
        self.drop_remainder = drop_remainder

    def __call__(self, it):
        feats, labels = [], []
        for s in it:
            feats.append(np.asarray(s.feature))
            labels.append(np.atleast_1d(np.asarray(s.label)))
            if len(feats) == self.batch_size:
                yield MiniBatch(np.stack(feats), self._stack_labels(labels))
                feats, labels = [], []
        if feats and not self.drop_remainder:
            yield MiniBatch(np.stack(feats), self._stack_labels(labels))

    @staticmethod
    def _stack_labels(labels):
        lab = np.stack(labels)
        # scalar labels arrive as (B, 1): flatten only that axis, never
        # the batch axis
        if lab.ndim == 2 and lab.shape[1] == 1:
            lab = lab[:, 0]
        return lab

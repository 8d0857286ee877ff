"""Data carriers (counterpart of ``bigdl_tpu/dataset/sample.py``). Host
numpy arrays; the optimizer moves a batch to the device."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import numpy as np

__all__ = ["Sample", "MiniBatch", "LabeledSentence"]


class Sample:
    """One (feature, label) pair."""

    __slots__ = ("feature", "label")

    def __init__(self, feature, label):
        self.feature = np.asarray(feature)
        self.label = np.asarray(label)

    def __repr__(self):
        return f"Sample(feature={self.feature.shape}, " \
               f"label={self.label.shape})"


class MiniBatch:
    """One training batch."""

    __slots__ = ("data", "labels")

    def __init__(self, data, labels):
        self.data = data
        self.labels = labels


@dataclass
class LabeledSentence:
    data: Any
    label: Any

"""Containers (counterpart of ``bigdl_tpu/nn/containers.py``)."""
from __future__ import annotations

import torch

from bigdl_tpu_torch.nn.module import Container

__all__ = ["Sequential", "Concat"]


class Sequential(Container):
    """Feed each child's output to the next; ``.add()`` appends and
    returns the container."""

    def forward(self, x):
        for m in self._modules.values():
            x = m(x)
        return x


class Concat(Container):
    """Run every child on the same input and concatenate their outputs
    along ``dimension`` (0-based, the batch at 0: 1 is NCHW's channels)."""

    def __init__(self, dimension: int = 1):
        super().__init__()
        self.dimension = dimension

    def forward(self, x):
        return torch.cat([m(x) for m in self._modules.values()],
                         dim=self.dimension)

"""Containers (counterpart of ``bigdl_tpu/nn/containers.py``)."""
from __future__ import annotations

from bigdl_tpu_torch.nn.module import Container

__all__ = ["Sequential"]


class Sequential(Container):
    """Feed each child's output to the next; ``.add()`` appends and
    returns the container."""

    def forward(self, x):
        for m in self._modules.values():
            x = m(x)
        return x

"""View (counterpart of ``View`` in ``bigdl_tpu/nn/structural.py``)."""
from __future__ import annotations

import math

from bigdl_tpu_torch.nn.module import Module

__all__ = ["View"]


class View(Module):
    """Reshape to ``sizes``, keeping a leading batch axis where there is
    one: with ``set_num_input_dims(n)``, an input of more than n dims;
    else, unless a size is −1, whenever dim 0 times the sizes' product
    accounts for the input (or the sizes alone do not)."""

    def __init__(self, *sizes):
        super().__init__()
        if len(sizes) == 1 and isinstance(sizes[0], (tuple, list)):
            sizes = tuple(sizes[0])
        self.sizes = tuple(sizes)
        self.num_input_dims = None

    def set_num_input_dims(self, n: int):
        self.num_input_dims = n
        return self

    def forward(self, x):
        n = math.prod(s for s in self.sizes if s > 0)
        if self.num_input_dims is not None:
            batched = x.dim() > self.num_input_dims
        elif -1 in self.sizes:
            # -1 absorbs any element count: the Torch full reshape
            batched = False
        else:
            batched = ((x.dim() > len(self.sizes)
                        and x.numel() == x.shape[0] * n) or x.numel() != n)
        if batched:
            return x.reshape((x.shape[0],) + self.sizes)
        return x.reshape(self.sizes)

    def extra_repr(self):
        return ", ".join(map(str, self.sizes))

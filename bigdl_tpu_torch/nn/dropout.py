"""Dropout (counterpart of ``Dropout`` in ``bigdl_tpu/nn/dropout.py``)."""
from __future__ import annotations

import torch

from bigdl_tpu_torch.nn.module import Module

__all__ = ["Dropout"]


class Dropout(Module):
    """Zero each element with probability p in training and, with
    ``scale``, divide the kept ones by 1 − p; the identity in
    ``evaluate()`` and at p = 0.

    The mask is drawn from ``generator`` (an attribute the caller may
    set), a ``torch.Generator`` on the activation's device that the
    caller seeds (the JAX module takes an rng key per call); each draw
    advances it. Masks are
    not JAX's threefry bits: parity with the JAX package holds at p = 0.
    """

    def __init__(self, init_p: float = 0.5, scale: bool = True, *,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.p = init_p
        self.scale = scale
        self.generator = generator

    def set_p(self, p: float):
        self.p = p
        return self

    def forward(self, x):
        if not self.training or self.p <= 0.0:
            return x
        if self.generator is None:
            raise ValueError("Dropout needs a generator in training mode")
        keep = torch.rand(x.shape, generator=self.generator,
                          device=x.device) >= self.p
        y = torch.where(keep, x, torch.zeros_like(x))
        return y / (1.0 - self.p) if self.scale else y

    def extra_repr(self):
        return f"{self.p}"

"""Linear (counterpart of ``bigdl_tpu/nn/linear.py``)."""
from __future__ import annotations

import math

import torch

from bigdl_tpu_torch.nn import init as init_mod
from bigdl_tpu_torch.nn.module import Module
from bigdl_tpu_torch.tensor import (activation_dtype, compute_dtype,
                                    resolve_device)

__all__ = ["Linear"]


class Linear(Module):
    """y = x W^T + b with W of shape (out, in); matmul operands in the
    compute dtype, output in the activation dtype."""

    def __init__(self, input_size: int, output_size: int,
                 with_bias: bool = True,
                 init_method: str = init_mod.Default, *, device="cuda",
                 generator: torch.Generator | None = None):
        super().__init__()
        device = resolve_device(device)
        self.input_size, self.output_size = input_size, output_size
        self.weight = torch.nn.Parameter(init_mod.init_weight(
            init_method, (output_size, input_size), input_size,
            output_size, generator=generator, device=device))
        self.bias = None
        if with_bias:
            if init_method == init_mod.Default:
                b = init_mod.uniform_reset(
                    (output_size,), 1.0 / math.sqrt(input_size),
                    generator=generator, device=device)
            else:
                b = init_mod.zeros((output_size,), device=device)
            self.bias = torch.nn.Parameter(b)

    def forward(self, x):
        y = x.to(compute_dtype()) @ self.weight.to(compute_dtype()).T
        if self.bias is not None:
            y = y + self.bias.to(compute_dtype())
        return y.to(activation_dtype())

    def extra_repr(self):
        return f"{self.input_size} -> {self.output_size}"

"""SpatialConvolution (counterpart of ``SpatialConvolution`` in
``bigdl_tpu/nn/conv.py``): NCHW input, OIHW weight, ``F.conv2d``
(cuDNN on the card)."""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from bigdl_tpu_torch.nn import init as init_mod
from bigdl_tpu_torch.nn.module import Module
from bigdl_tpu_torch.tensor import (activation_dtype, compute_dtype,
                                    resolve_device)

__all__ = ["SpatialConvolution"]


class SpatialConvolution(Module):
    """2-D convolution. Weight (n_output_plane, n_input_plane / n_group,
    kernel_h, kernel_w); x, the weight and the bias are cast to the
    compute dtype, the output to the activation dtype.
    ``propagate_back=False`` cuts the gradient to the input (the
    reference's propagateBack). A 3-D (C, H, W) input is taken as a batch
    of one."""

    def __init__(self, n_input_plane: int, n_output_plane: int,
                 kernel_w: int, kernel_h: int,
                 stride_w: int = 1, stride_h: int = 1,
                 pad_w: int = 0, pad_h: int = 0,
                 n_group: int = 1, propagate_back: bool = True,
                 init_method: str = init_mod.Default,
                 with_bias: bool = True, *, device="cuda",
                 generator: torch.Generator | None = None):
        super().__init__()
        if n_input_plane % n_group or n_output_plane % n_group:
            raise ValueError(f"planes {n_input_plane} -> {n_output_plane} "
                             f"not divisible by {n_group} groups")
        device = resolve_device(device)
        self.n_input_plane, self.n_output_plane = n_input_plane, n_output_plane
        self.kw, self.kh = kernel_w, kernel_h
        self.dw, self.dh = stride_w, stride_h
        self.pw, self.ph = pad_w, pad_h
        self.n_group = n_group
        self.propagate_back = propagate_back
        fan_in = kernel_w * kernel_h * n_input_plane
        fan_out = kernel_w * kernel_h * n_output_plane
        shape = (n_output_plane, n_input_plane // n_group, kernel_h,
                 kernel_w)
        self.weight = torch.nn.Parameter(init_mod.init_weight(
            init_method, shape, fan_in, fan_out, generator=generator,
            device=device))
        self.bias = None
        if with_bias:
            if init_method == init_mod.Default:
                b = init_mod.uniform_reset((n_output_plane,),
                                           1.0 / math.sqrt(fan_in),
                                           generator=generator,
                                           device=device)
            else:
                b = init_mod.zeros((n_output_plane,), device=device)
            self.bias = torch.nn.Parameter(b)

    def forward(self, x):
        squeeze = x.dim() == 3
        if squeeze:
            x = x[None]
        if not self.propagate_back:
            x = x.detach()
        cd = compute_dtype()
        y = F.conv2d(x.to(cd), self.weight.to(cd),
                     stride=(self.dh, self.dw), padding=(self.ph, self.pw),
                     groups=self.n_group)
        if self.bias is not None:
            y = y + self.bias.to(cd)[:, None, None]
        y = y.to(activation_dtype())
        return y[0] if squeeze else y

    def extra_repr(self):
        return (f"{self.n_input_plane} -> {self.n_output_plane}, "
                f"{self.kw}x{self.kh}, {self.dw},{self.dh}, "
                f"{self.pw},{self.ph}")

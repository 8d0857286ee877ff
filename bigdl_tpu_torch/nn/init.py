"""Weight initialization (counterpart of ``bigdl_tpu/nn/init.py``).

The distributions are the JAX package's: ``Default`` is uniform(-stdv,
stdv) with stdv = 1/sqrt(fan_in), ``Xavier`` is uniform with limit
sqrt(6/(fan_in+fan_out)). The values are not: JAX's threefry bits cannot
be reproduced with a ``torch.Generator``, so parity tests move weights
across (``bigdl_tpu_torch.interop``) instead of re-initializing. Values
are drawn on the CPU from the caller's generator (or torch's default one)
and then moved to ``device``, so a seed gives the same weights on every
device.
"""
from __future__ import annotations

import math

import torch

from bigdl_tpu_torch.tensor import default_dtype

__all__ = ["Default", "Xavier", "uniform_reset", "init_weight", "normal",
           "zeros", "ones"]

Default = "default"
Xavier = "xavier"


def uniform_reset(shape, stdv, *, generator=None, dtype=None,
                  device="cpu"):
    """Torch-style reset: uniform(-stdv, stdv)."""
    t = torch.empty(shape, dtype=dtype or default_dtype())
    t.uniform_(-stdv, stdv, generator=generator)
    return t.to(device)


def init_weight(method, shape, fan_in, fan_out, *, generator=None,
                dtype=None, device="cpu"):
    """Dispatch on init method."""
    if method == Default:
        return uniform_reset(shape, 1.0 / math.sqrt(fan_in),
                             generator=generator, dtype=dtype,
                             device=device)
    if method == Xavier:
        return uniform_reset(shape, math.sqrt(6.0 / (fan_in + fan_out)),
                             generator=generator, dtype=dtype,
                             device=device)
    raise ValueError(f"unknown init method: {method}")


def normal(shape, std, *, generator=None, dtype=None, device="cpu"):
    t = torch.empty(shape, dtype=dtype or default_dtype())
    t.normal_(0.0, std, generator=generator)
    return t.to(device)


def zeros(shape, *, dtype=None, device="cpu"):
    return torch.zeros(shape, dtype=dtype or default_dtype(), device=device)


def ones(shape, *, dtype=None, device="cpu"):
    return torch.ones(shape, dtype=dtype or default_dtype(), device=device)

"""Pooling (counterpart of ``SpatialMaxPooling`` and
``SpatialAveragePooling`` in ``bigdl_tpu/nn/pooling.py``), NCHW.

The padding is the JAX package's: explicit (lo, hi) per spatial dim,
extended on the high side for ``ceil()`` mode (``_pool_out`` /
``_Pool2d._padding``, ported as they are), −inf for max and 0 for
average; the pool itself runs unpadded. Max pooling's backward is the
library's, which takes the first maximum of a window in row-major order
on ties, as select-and-scatter does; the hand-written 3x3 / stride-1
backward (``ops.maxpool.maxpool3x3s1``) is opt-in and not dispatched
here, as in the JAX package.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from bigdl_tpu_torch.nn.module import Module

__all__ = ["SpatialMaxPooling", "SpatialAveragePooling"]


def _pool_out(size, k, d, pad, ceil_mode):
    if ceil_mode:
        return int(math.ceil((size + 2 * pad - k) / d)) + 1
    return int(math.floor((size + 2 * pad - k) / d)) + 1


class _Pool2d(Module):
    def __init__(self, kw, kh, dw=None, dh=None, pad_w=0, pad_h=0):
        super().__init__()
        self.kw, self.kh = kw, kh
        self.dw, self.dh = dw or kw, dh or kh
        self.pw, self.ph = pad_w, pad_h
        self.ceil_mode = False

    def ceil(self):
        self.ceil_mode = True
        return self

    def floor(self):
        self.ceil_mode = False
        return self

    def _padding(self, h, w):
        """(lo, hi) padding per spatial dim, extending for ceil_mode."""
        oh = _pool_out(h, self.kh, self.dh, self.ph, self.ceil_mode)
        ow = _pool_out(w, self.kw, self.dw, self.pw, self.ceil_mode)
        # Torch clamps so the last window starts inside the (padded) input
        if self.ph > 0 or self.pw > 0:
            if (oh - 1) * self.dh >= h + self.ph:
                oh -= 1
            if (ow - 1) * self.dw >= w + self.pw:
                ow -= 1
        hi_h = max((oh - 1) * self.dh + self.kh - h - self.ph, self.ph)
        hi_w = max((ow - 1) * self.dw + self.kw - w - self.pw, self.pw)
        return (self.ph, hi_h), (self.pw, hi_w)

    def _padded(self, x, value):
        (hl, hh), (wl, wh) = self._padding(x.shape[2], x.shape[3])
        if hl == hh == wl == wh == 0:
            return x
        return F.pad(x, (wl, wh, hl, hh), value=value)

    def forward(self, x):
        squeeze = x.dim() == 3
        if squeeze:
            x = x[None]
        y = self._pool(x)
        return y[0] if squeeze else y

    def extra_repr(self):
        return (f"{self.kw}x{self.kh}, {self.dw},{self.dh}, "
                f"{self.pw},{self.ph}" + (", ceil" if self.ceil_mode
                                          else ""))


class SpatialMaxPooling(_Pool2d):
    """Max over kh x kw windows; padding is −inf."""

    def _pool(self, x):
        (hl, hh), (wl, wh) = self._padding(x.shape[2], x.shape[3])
        if hl == hh and wl == wh and 2 * hl <= self.kh and 2 * wl <= self.kw:
            # symmetric: the library's implicit padding is −inf, the same
            # windows without the padded copy
            return F.max_pool2d(x, (self.kh, self.kw), (self.dh, self.dw),
                                (hl, wl))
        return F.max_pool2d(self._padded(x, float("-inf")),
                            (self.kh, self.kw), (self.dh, self.dw))


class SpatialAveragePooling(_Pool2d):
    """Average over kh x kw windows of the zero-padded input.
    ``count_include_pad`` (Torch's default) divides every window by
    kh·kw, the ceil-mode overhang included, as the JAX module does;
    otherwise by the count of input elements in the window.
    ``divide=False`` gives the window sums."""

    def __init__(self, kw, kh, dw=None, dh=None, pad_w=0, pad_h=0,
                 count_include_pad: bool = True, divide: bool = True):
        super().__init__(kw, kh, dw, dh, pad_w, pad_h)
        self.count_include_pad = count_include_pad
        self.divide = divide

    def _pool(self, x):
        k, s = (self.kh, self.kw), (self.dh, self.dw)
        # explicit zero padding: the library's divisor is then kh·kw
        y = F.avg_pool2d(self._padded(x, 0.0), k, s)
        if not self.divide:
            return y * (self.kh * self.kw)
        if self.count_include_pad:
            return y
        # the window's share of input elements, from a padded plane of ones
        ones = self._padded(torch.ones_like(x[:1, :1]), 0.0)
        return y / F.avg_pool2d(ones, k, s)

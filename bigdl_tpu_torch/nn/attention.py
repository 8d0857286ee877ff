"""Attention (counterpart of ``bigdl_tpu/nn/attention.py``).

``MultiHeadAttention`` holds the parameters the serving path reads and
runs the full-sequence forward of training: projections in the compute
dtype, RoPE, GQA widening, then ``parallel.sequence.dot_product_attention``
(the flash kernels whenever they support the call). The ring and Ulysses
cores are not ported yet (ROADMAP.md queue A, Multi-card).
"""
from __future__ import annotations

import torch

from bigdl_tpu_torch.nn import init as init_mod
from bigdl_tpu_torch.nn.module import Module
from bigdl_tpu_torch.parallel.sequence import dot_product_attention
from bigdl_tpu_torch.tensor import (activation_dtype, compute_dtype,
                                    resolve_device)

__all__ = ["MultiHeadAttention", "apply_rope"]


def apply_rope(x, positions, theta: float = 10000.0):
    """Rotary position embedding over the head dim (split-half
    convention: pairs are (x[..., i], x[..., i + D/2])).

    ``x``: (..., S, H, D); ``positions``: (S,) absolute positions. Angles
    in f32, the rotation itself in x's dtype."""
    d = x.shape[-1]
    half = d // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=x.device) / half)
    ang = positions.to(torch.float32)[:, None] * freqs[None, :]  # (S, hf)
    bshape = (1,) * (x.ndim - 3) + (ang.shape[0], 1, half)
    cos = torch.cos(ang).reshape(bshape).to(x.dtype)
    sin = torch.sin(ang).reshape(bshape).to(x.dtype)
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


class MultiHeadAttention(Module):
    """Self-attention parameters ``{q,k,v,out}_weight`` (out, in) and
    ``{q,k,v,out}_bias``; k/v project to ``num_kv_heads`` heads (GQA when
    fewer than ``num_heads``)."""

    def __init__(self, embed_dim: int, num_heads: int,
                 causal: bool = False, with_bias: bool = True,
                 rope: bool = False, num_kv_heads: int | None = None, *,
                 device="cuda", generator: torch.Generator | None = None):
        super().__init__()
        device = resolve_device(device)
        if embed_dim % num_heads:
            raise ValueError(f"embed_dim={embed_dim} not divisible by "
                             f"num_heads={num_heads}")
        if num_kv_heads is not None and num_kv_heads < 1:
            raise ValueError(f"num_kv_heads={num_kv_heads} must be >= 1 "
                             "(or None for full MHA)")
        self.embed_dim, self.num_heads = embed_dim, num_heads
        self.head_dim = embed_dim // num_heads
        self.num_kv_heads = num_kv_heads or num_heads
        if num_heads % self.num_kv_heads:
            raise ValueError(f"num_heads={num_heads} must be a multiple "
                             f"of num_kv_heads={self.num_kv_heads}")
        if rope and self.head_dim % 2:
            raise ValueError("rope needs an even head_dim")
        self.causal, self.rope = causal, rope
        kv_dim = self.num_kv_heads * self.head_dim
        for name in ("q", "k", "v", "out"):
            out_dim = kv_dim if name in ("k", "v") else embed_dim
            self.register_parameter(f"{name}_weight", torch.nn.Parameter(
                init_mod.init_weight(init_mod.Xavier, (out_dim, embed_dim),
                                     embed_dim, out_dim,
                                     generator=generator, device=device)))
            if with_bias:
                self.register_parameter(f"{name}_bias", torch.nn.Parameter(
                    init_mod.zeros((out_dim,), device=device)))

    def _proj(self, name, x):
        cdt = compute_dtype()
        y = x.to(cdt) @ getattr(self, f"{name}_weight").to(cdt).T
        bias = self._parameters.get(f"{name}_bias")
        if bias is not None:
            y = y + bias.to(cdt)
        return y

    def forward(self, x, *, flash: str | bool = "auto"):
        """Self-attention over (batch, seq, embed). ``flash`` is
        ``dot_product_attention``'s: "auto" (the kernels wherever they
        support the call), True or False (the plain f32 path)."""
        b, s, e = x.shape
        q = self._proj("q", x).reshape(b, s, self.num_heads, self.head_dim)
        k = self._proj("k", x).reshape(b, s, self.num_kv_heads,
                                       self.head_dim)
        v = self._proj("v", x).reshape(b, s, self.num_kv_heads,
                                       self.head_dim)
        if self.rope:
            pos = torch.arange(s, device=x.device)
            q = apply_rope(q, pos)
            k = apply_rope(k, pos)
        group = self.num_heads // self.num_kv_heads
        if group > 1:
            # kv head j serves query heads j*group .. j*group+group-1, as
            # jnp.repeat(..., axis=2); .repeat/.expand would interleave
            k = torch.repeat_interleave(k, group, dim=2)
            v = torch.repeat_interleave(v, group, dim=2)
        o = dot_product_attention(q, k, v, causal=self.causal, flash=flash)
        return self._proj("out", o.reshape(b, s, e)).to(activation_dtype())

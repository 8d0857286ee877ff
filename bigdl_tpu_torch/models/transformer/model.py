"""Transformer language model (counterpart of
``bigdl_tpu/models/transformer/model.py``).

The same Sequential structure as the JAX model — 0 embed, 1..L blocks,
L+1 final LayerNorm, L+2 LM head (L+3 LogSoftMax) — so ``state_dict``
keys are the JAX params-tree paths and ``model.params`` is read by the
decode and serving functions as the JAX tree is. ``model(x)`` is the
full-sequence forward of training, whose attention takes the flash
kernels; ``model(x, flash=False)`` runs the same forward with every
block's attention core on the plain f32 path, for checks that hold the
kernels against it.
"""
from __future__ import annotations

import math

import torch

from bigdl_tpu_torch import nn
from bigdl_tpu_torch.nn import init as init_mod
from bigdl_tpu_torch.nn.module import Container, Module
from bigdl_tpu_torch.tensor import activation_dtype, resolve_device

__all__ = ["TransformerLM", "TransformerBlock"]


class _Residual(Container):
    """y = x + inner(norm(x)) — pre-LN residual wrapper."""

    def __init__(self, d_model: int, inner: Module, *, device):
        super().__init__(nn.LayerNorm(d_model, device=device), inner)

    def forward(self, x, **kw):
        return x + self[1](self[0](x), **kw)


class _Block(nn.Sequential):
    """The two residuals of a block; ``flash`` goes to the attention."""

    def forward(self, x, *, flash: str | bool = "auto"):
        return self[1](self[0](x, flash=flash))


class _LM(nn.Sequential):
    """The LM's Sequential; ``flash`` is every block's attention core
    choice (``dot_product_attention``'s argument)."""

    def forward(self, x, *, flash: str | bool = "auto"):
        for m in self._modules.values():
            x = m(x, flash=flash) if isinstance(m, _Block) else m(x)
        return x


def TransformerBlock(d_model: int, num_heads: int, ffn_mult: int = 4,
                     dropout: float = 0.0, *, rope: bool = False,
                     num_kv_heads: int | None = None, device="cuda",
                     generator: torch.Generator | None = None):
    """Pre-LN block: x + MHA(LN(x)); x + FFN(LN(x)). ``dropout`` > 0
    appends ``nn.Dropout`` to the FFN, as the JAX block does; the caller
    sets its ``generator`` before training."""
    device = resolve_device(device)
    mha = nn.MultiHeadAttention(d_model, num_heads, causal=True, rope=rope,
                                num_kv_heads=num_kv_heads, device=device,
                                generator=generator)
    ffn = (nn.Sequential()
           .add(nn.Linear(d_model, ffn_mult * d_model, device=device,
                          generator=generator))
           .add(nn.ReLU())
           .add(nn.Linear(ffn_mult * d_model, d_model, device=device,
                          generator=generator)))
    if dropout > 0:
        ffn.add(nn.Dropout(dropout))
    return (_Block()
            .add(_Residual(d_model, mha, device=device))
            .add(_Residual(d_model, ffn, device=device)))


class _TokenAndPosition(Module):
    """Token embedding (1-based ids) plus a learned positional embedding,
    or the token embedding alone under ``with_pos=False`` (RoPE)."""

    def __init__(self, vocab: int, d_model: int, max_len: int,
                 with_pos: bool = True, *, device="cuda",
                 generator: torch.Generator | None = None):
        super().__init__()
        device = resolve_device(device)
        self.vocab, self.d_model, self.max_len = vocab, d_model, max_len
        scale = 1.0 / math.sqrt(d_model)
        self.tok = torch.nn.Parameter(init_mod.normal(
            (vocab, d_model), scale, generator=generator, device=device))
        self.pos = None
        if with_pos:
            self.pos = torch.nn.Parameter(init_mod.normal(
                (max_len, d_model), scale, generator=generator,
                device=device))

    def forward(self, x):
        idx = (x.long() - 1).clamp(0, self.vocab - 1)
        y = self.tok[idx]
        if self.pos is not None:
            y = y + self.pos[:x.shape[1]]
        return y.to(activation_dtype())


def TransformerLM(vocab_size: int, d_model: int = 128, num_heads: int = 4,
                  num_layers: int = 2, max_len: int = 512,
                  ffn_mult: int = 4, dropout: float = 0.0,
                  with_log_softmax: bool = True,
                  pos_encoding: str = "learned",
                  num_kv_heads: int | None = None, *, device="cuda",
                  generator: torch.Generator | None = None
                  ) -> nn.Sequential:
    """Causal LM over 1-based token ids. ``pos_encoding`` is "learned"
    or "rope"; ``num_kv_heads`` < ``num_heads`` selects grouped-query
    attention. Weights are drawn from ``generator`` (a CPU
    ``torch.Generator``; torch's default one when None) and placed on
    ``device``. ``dropout`` > 0 puts an ``nn.Dropout`` after every FFN,
    whose ``generator`` (one on ``device``) the caller sets."""
    if pos_encoding not in ("learned", "rope"):
        raise ValueError(f"pos_encoding={pos_encoding!r}")
    device = resolve_device(device)
    rope = pos_encoding == "rope"
    kw = dict(device=device, generator=generator)
    model = _LM().add(
        _TokenAndPosition(vocab_size, d_model, max_len, with_pos=not rope,
                          **kw).set_name("embed"))
    for i in range(num_layers):
        model.add(TransformerBlock(d_model, num_heads, ffn_mult, dropout,
                                   rope=rope, num_kv_heads=num_kv_heads,
                                   **kw)
                  .set_name(f"block_{i}"))
    model.add(nn.LayerNorm(d_model, device=device).set_name("final_norm"))
    model.add(nn.Linear(d_model, vocab_size, init_method=init_mod.Xavier,
                        **kw).set_name("lm_head"))
    if with_log_softmax:
        model.add(nn.LogSoftMax())
    # decode-path metadata (models/transformer/generate.py)
    model.lm_meta = {"num_layers": num_layers, "num_heads": num_heads,
                     "max_len": max_len, "d_model": d_model,
                     "vocab": vocab_size, "pos_encoding": pos_encoding,
                     "num_kv_heads": num_kv_heads}
    return model


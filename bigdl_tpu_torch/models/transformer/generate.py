"""Decode building blocks for ``TransformerLM`` (counterpart of
``bigdl_tpu/models/transformer/generate.py:32-222``).

The functions read the model's params tree (``model.params``: embed,
blocks, final norm and LM head keyed by their Sequential positions)
rather than threading a cache through module classes, exactly as the
JAX ones do, so the paged serving path in ``serving.py`` can share them.
The static-cache ``generate`` and ``beam_search`` loops are not part of
this slice (ROADMAP.md).
"""
from __future__ import annotations

import torch

from bigdl_tpu_torch.tensor import activation_dtype, compute_dtype

__all__ = ["GenerationConfig"]


class GenerationConfig:
    """Decode knobs: temperature 0 = greedy; top_k limits the softmax
    support."""

    def __init__(self, max_new_tokens: int = 32, temperature: float = 0.0,
                 top_k: int | None = None):
        if top_k is not None and top_k < 1:
            raise ValueError(f"top_k must be >= 1, got {top_k}")
        if max_new_tokens < 1:
            raise ValueError(f"max_new_tokens must be >= 1, got "
                             f"{max_new_tokens}")
        self.max_new_tokens = max_new_tokens
        self.temperature = temperature
        self.top_k = top_k


def _split_heads(x, num_heads):
    b, s, e = x.shape
    return x.reshape(b, s, num_heads, e // num_heads)


def _ln(p, x, eps=1e-5):
    x32 = x.to(torch.float32)
    mu = x32.mean(dim=-1, keepdim=True)
    var = x32.var(dim=-1, unbiased=False, keepdim=True)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    return (y * p["weight"] + p["bias"]).to(x.dtype)


def _proj(p, name, x):
    # mirrors MultiHeadAttention's projection: compute-dtype operands and
    # output
    cdt = compute_dtype()
    y = x.to(cdt) @ p[f"{name}_weight"].to(cdt).T
    if f"{name}_bias" in p:
        y = y + p[f"{name}_bias"].to(cdt)
    return y


def _linear(p, x):
    # mirrors nn.Linear's dtype path
    cdt = compute_dtype()
    y = x.to(cdt) @ p["weight"].to(cdt).T
    y = y + p["bias"].to(cdt)
    return y.to(activation_dtype())


def _ffn(p, x):
    return _linear(p["2"], torch.relu(_linear(p["0"], x)))


def _model_parts(params, num_layers):
    """Sequential positions: 0 embed, 1..L blocks, L+1 final LN,
    L+2 lm head (L+3 LogSoftMax is parameterless)."""
    embed = params["0"]
    blocks = [params[str(1 + i)] for i in range(num_layers)]
    norm = params[str(num_layers + 1)]
    head = params[str(num_layers + 2)]
    return embed, blocks, norm, head


def _embed(ep, tokens, start: int):
    """Token (+ learned position) embedding of (B, T) 1-based ids whose
    first column sits at position ``start``."""
    vocab = ep["tok"].shape[0]
    y = ep["tok"][(tokens.long() - 1).clamp(0, vocab - 1)]
    if "pos" in ep:        # learned positions; absent under RoPE
        y = y + ep["pos"][start:start + tokens.shape[1]]
    return y


def _logits(params, num_layers, x):
    _, _, norm, head = _model_parts(params, num_layers)
    return _linear(head, _ln(norm, x[:, -1]))


def _sample(logits, temperature, top_k, generator=None):
    """Next 1-based ids from (B, V) logits: greedy argmax at temperature
    0 (ties go to the lowest id, like ``jnp.argmax``), else a draw from
    the tempered, optionally top-k-limited softmax using ``generator``."""
    logits = logits.to(torch.float32)
    if temperature == 0.0:
        return torch.argmax(logits, dim=-1) + 1          # back to 1-based
    logits = logits / temperature
    if top_k is not None:
        k_eff = min(top_k, logits.shape[-1])
        kth = torch.sort(logits, dim=-1).values[:, -k_eff][:, None]
        logits = torch.where(logits < kth, -1e9, logits)
    probs = torch.softmax(logits, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0] + 1

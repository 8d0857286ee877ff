"""Attention over (batch, seq, heads, head_dim) (counterpart of
``dot_product_attention`` in ``bigdl_tpu/parallel/sequence.py``).

Ring and Ulysses sequence parallelism are not ported yet (ROADMAP.md
queue A, Multi-card).
"""
from __future__ import annotations

from bigdl_tpu_torch.ops.flash_attention import (flash_attention,
                                                 flash_attention_ref,
                                                 flash_supported)

__all__ = ["dot_product_attention"]


def dot_product_attention(q, k, v, *, causal: bool = False,
                          scale: float | None = None,
                          q_offset: int = 0, kv_offset: int = 0,
                          flash: str | bool = "auto"):
    """Attention over (B, S, H, D).

    ``q_offset``/``kv_offset`` are the global positions of element 0 (how
    causal masking stays correct on sequence shards).

    ``flash="auto"`` routes to the flash kernels
    (``ops/flash_attention.py``) for every call they support: any head
    dim (zero-padded to a width the kernels are built for, see
    ``padded_head_dim``), float32 or bfloat16, zero offsets when causal. On a CUDA tensor that is the
    hand-written kernel, on a CPU tensor its plain version. A call they
    do not support raises under ``flash=True``, and under ``"auto"`` too
    unless the tensors lie on the CPU: on the card the plain path is
    taken only when asked for. ``flash=False`` takes
    ``flash_attention_ref``, the reference semantics: f32 scores and
    softmax materialised as a (B, H, Sq, Skv) matrix."""
    if flash:
        offsets_ok = not causal or (q_offset == 0 and kv_offset == 0)
        supported = offsets_ok and flash_supported(q, k) and \
            v.shape == k.shape and v.dtype == q.dtype
        if not supported and (flash is True or q.device.type != "cpu"):
            raise ValueError(
                f"flash={flash!r} on {q.device.type} tensors but the "
                f"kernel does not support this call: q{tuple(q.shape)} "
                f"{q.dtype}, k{tuple(k.shape)} {k.dtype}, "
                f"q_offset={q_offset} kv_offset={kv_offset} (need "
                f"float32 or bfloat16, equal batch, heads and head dim, "
                f"zero offsets when causal); "
                f"flash=False takes the plain path")
        if supported:
            return flash_attention(q, k, v, causal=causal, scale=scale)
    o, _ = flash_attention_ref(q, k, v, causal=causal, scale=scale,
                               q_offset=q_offset, kv_offset=kv_offset)
    return o

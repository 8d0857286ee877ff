"""Flash attention, forward and FlashAttention-2 backward (counterpart of
``bigdl_tpu/ops/pallas/flash_attention.py``).

Three kernels, each with its plain PyTorch version beside it:

- ``flash_fwd``  — online-softmax attention, emits o and the per-row lse;
- ``flash_dq``   — dq = Σ_k dS·K·scale with dS = P∘(dO·Vᵀ − delta);
- ``flash_dkdv`` — dk = Σ_q dSᵀ·Q·scale and dv = Σ_q Pᵀ·dO, fused.

On a CUDA tensor each launches the hand-written Hopper kernel of
``csrc/flash_attention.cu`` (built at first use, see ``_build.py``) or
raises; on a CPU tensor it takes its plain version (``*_ref``). The
choice follows the tensor's device alone. ``_Flash`` (a
``torch.autograd.Function``) saves (q, k, v, o, lse) and its backward
computes ``delta = rowsum(dO∘O) − g_lse`` in torch, as the JAX package
does on the XLA side, so the lse cotangent (ring attention's merge) folds
into the same two kernels.

Layout is the public (B, S, H, D) throughout: the kernels index
``[b, s, h, :]`` with a row stride of H·D, so no (B·H, S, D) transpose is
materialised. lse is (B, S, H) f32. Arithmetic matches the TPU kernel:
f32 scores times ``scale``, the finite −1e9 causal mask (key position >
query position, both counted from 0), P rounded to v's dtype before P·V
and to dO's dtype before dv, dS rounded to k's dtype for dq and to q's
dtype for dk; o/dq/dk/dv in the input dtype. The f32 kernels, the
forward, dq and dk/dv at every head dim, form their products on the
tensor cores in 3xTF32 (each operand split into tf32 high and low parts,
hi·lo + lo·hi + hi·hi summed in f32), which keeps about 22 of f32's 24
bits; they take a workspace for the parts (``_work``).

``fwd_launches``, ``dq_launches`` and ``dkdv_launches`` count kernel
launches, so a run can show its main path went through the kernels;
``fwd_tf32_launches``, ``dq_tf32_launches`` and ``dkdv_tf32_launches``
count those of them on the 3xTF32 routes (``TF32_ROUTES``,
``flash_route``): every f32 launch.
"""
from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from . import padded_head_dim

__all__ = ["flash_attention", "flash_attention_with_lse", "flash_supported",
           "flash_route", "TF32_ROUTES", "padded_head_dim",
           "flash_attention_ref",
           "flash_fwd", "flash_dq", "flash_dkdv", "flash_fwd_ref",
           "flash_dq_ref", "flash_dkdv_ref",
           "fwd_launches", "dq_launches", "dkdv_launches",
           "fwd_tf32_launches", "dq_tf32_launches", "dkdv_tf32_launches"]

_NEG = -1e9  # finite mask value, as in the JAX package
#: the routes of ``flash_route`` whose kernels run in 3xTF32 and take a
#: workspace
TF32_ROUTES = ("rows_tf32", "sliced_tf32")
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

#: kernel launches since import (reset by assigning 0)
fwd_launches = 0
dq_launches = 0
dkdv_launches = 0
#: of those, the launches on a 3xTF32 route (``TF32_ROUTES``)
fwd_tf32_launches = 0
dq_tf32_launches = 0
dkdv_tf32_launches = 0


def _head_dim_ok(d: int) -> bool:
    """Head dims the kernels are built for (the C entries take no other):
    32, 64, 128, 192, 256 and past 256 every multiple of 64."""
    return d >= 1 and padded_head_dim(d) == d


def flash_supported(q, k) -> bool:
    """Shapes and dtypes the kernels take: (B, S, H, D) q and k with equal
    B, H and D, any D >= 1, float32 or bfloat16. Any sequence lengths
    (ragged tile tails are masked in the kernel).

    A head dim the kernels are not built for runs zero-padded to
    :func:`padded_head_dim` (D 16 -> 32, 80 and 96 -> 128, 288 -> 320).
    Past D 256 the C entries route to D-sliced kernels on the tensor
    cores: a CTA owns a slice of the output's columns (up to 256 in
    bf16, forward and backward; in f32, in 3xTF32, up to 512 for the
    forward and dq and 256 for dk/dv) and sums the scores over all of D.
    Every f32 kernel runs in 3xTF32 on the tensor cores at every head
    dim: one slice of all of D up to 256, and the forward and dq up to
    128 in CTAs of 128 rows whose warpgroups each form the scores of
    their own 64 (``flash_route``; csrc/flash_attention.cu's
    header)."""
    return (q.dim() == 4 and k.dim() == 4 and q.shape[-1] >= 1
            and q.shape[0] == k.shape[0] and q.shape[2:] == k.shape[2:]
            and q.dtype in _DTYPE_CODES and k.dtype == q.dtype
            and q.shape[1] > 0 and k.shape[1] > 0)


def flash_route(dtype, d: int, kernel: str = "fwd") -> str | None:
    """The kernel family the C entry of ``kernel`` ("fwd", "dq" or
    "dkdv") runs for ``dtype`` at head dim ``d``, as
    ``BIGDL_FLASH_DISPATCH`` in csrc/flash_attention.cu picks it:
    ``"tc"`` (bf16 at D 32-256: ``wgmma`` with TMA tiles),
    ``"sliced_tc"`` (bf16 past 256: ``flash_fwd_sliced_tc_kernel``,
    ``flash_dq_sliced_tc_kernel`` and ``flash_dkdv_sliced_tc_kernel``,
    slices of up to 256 output columns on the tensor cores), and for
    f32, in 3xTF32 on the tensor cores (each product split into tf32 high
    and low parts, hi·hi + hi·lo + lo·hi summed in f32; ``TF32_ROUTES``),
    ``"rows_tf32"`` (the forward and dq at D 32-128:
    ``flash_fwd_rows_tf32_kernel`` and ``flash_dq_rows_tf32_kernel``,
    128-row CTAs, each warpgroup forming the scores of its own 64 rows)
    and ``"sliced_tf32"`` (``flash_fwd_sliced_tf32_kernel`` and
    ``flash_dq_sliced_tf32_kernel`` past 128,
    ``flash_dkdv_sliced_tf32_kernel`` at every D, one slice of all of D up
    to 256); None where no kernel takes the call. A head dim the kernels
    are not built for reports the route of :func:`padded_head_dim`, the
    width it runs at."""
    if d < 1 or kernel not in ("fwd", "dq", "dkdv"):
        return None
    width = padded_head_dim(d)
    if dtype == torch.bfloat16:
        return "tc" if width <= 256 else "sliced_tc"
    if dtype != torch.float32:
        return None
    return ("rows_tf32" if kernel != "dkdv" and width <= 128
            else "sliced_tf32")


# --------------------------------------------------------------------------
# plain versions
# --------------------------------------------------------------------------

def _wide(x):
    """x in f32, or in float64 if it is: the plain versions' sums."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


def _scores(q, k, scale, causal, q_offset=0, kv_offset=0):
    """(B, H, Sq, Skv) f32 (float64 for float64 inputs) scaled scores
    with the −1e9 causal mask (positions counted from the offsets)."""
    s = torch.einsum("bqhd,bkhd->bhqk", _wide(q), _wide(k)) * scale
    if causal:
        qpos = q_offset + torch.arange(q.shape[1], device=q.device)[:, None]
        kpos = kv_offset + torch.arange(k.shape[1], device=q.device)[None, :]
        s = torch.where(kpos > qpos, _NEG, s)
    return s


def _row(x):
    """(B, S, H) per-row statistic -> (B, H, S, 1) for score broadcast."""
    return x.permute(0, 2, 1)[..., None]


def flash_fwd_ref(q, k, v, scale, causal):
    """Plain version of :func:`flash_fwd`: o (q's dtype) and lse (B, S, H)
    f32 (in float64 for float64 inputs, as the backward's plain
    versions). P is rounded to v's dtype before P·V, unnormalised, as the
    kernel rounds it."""
    s = _scores(q, k, scale, causal)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bhqk,bkhd->bqhd", _wide(p.to(v.dtype)), _wide(v))
    o = o / l.squeeze(-1).permute(0, 2, 1)[..., None]
    lse = (m + torch.log(l)).squeeze(-1).permute(0, 2, 1)
    return o.to(q.dtype), lse.contiguous()


def _probs_and_ds(q, k, v, do, lse, delta, scale, causal):
    s = _scores(q, k, scale, causal)
    p = torch.exp(s - _row(lse))
    dp = torch.einsum("bqhd,bkhd->bhqk", _wide(do), _wide(v))
    return p, p * (dp - _row(delta)) * scale


def flash_dq_ref(q, k, v, do, lse, delta, scale, causal):
    """Plain version of :func:`flash_dq` (in float64 for float64
    inputs, as :func:`flash_dkdv_ref`)."""
    _, ds = _probs_and_ds(q, k, v, do, lse, delta, scale, causal)
    dq = torch.einsum("bhqk,bkhd->bqhd", _wide(ds.to(k.dtype)), _wide(k))
    return dq.to(q.dtype)


def flash_dkdv_ref(q, k, v, do, lse, delta, scale, causal):
    """Plain version of :func:`flash_dkdv`: (dk, dv)."""
    p, ds = _probs_and_ds(q, k, v, do, lse, delta, scale, causal)
    dv = torch.einsum("bhqk,bqhd->bkhd", _wide(p.to(do.dtype)), _wide(do))
    dk = torch.einsum("bhqk,bqhd->bkhd", _wide(ds.to(q.dtype)), _wide(q))
    return dk.to(k.dtype), dv.to(v.dtype)


def flash_attention_ref(q, k, v, *, causal: bool = False,
                        scale: float | None = None, q_offset: int = 0,
                        kv_offset: int = 0):
    """The plain version of :func:`flash_attention_with_lse` as one
    differentiable torch function: f32 scores, the −1e9 causal mask and
    softmax, giving o (q's dtype) and lse (B, S, H) f32. The offsets are
    the global positions of element 0 (``dot_product_attention``'s)."""
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    s = _scores(q, k, scale, causal, q_offset, kv_offset)
    lse = torch.logsumexp(s, dim=-1)
    p = torch.exp(s - lse[..., None])
    o = torch.einsum("bhqk,bkhd->bqhd", p, v.float())
    return o.to(q.dtype), lse.permute(0, 2, 1)


# --------------------------------------------------------------------------
# kernel wrappers
# --------------------------------------------------------------------------

@functools.cache
def _kernel_fns():
    """The three C entries of csrc/flash_attention.cu, built at first
    use."""
    from bigdl_tpu_torch.ops._build import load_library
    return bind(load_library("flash_attention.cu"))


def bind(lib: ctypes.CDLL) -> dict:
    """The typed entries ``{"fwd", "dq", "dkdv"}`` of a library built from
    csrc/flash_attention.cu. Each takes a last pointer, the f32 workspace
    of the 3xTF32 routes (``_work``), after the stream."""
    dims = [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_int,
                                 ctypes.c_void_p, ctypes.c_void_p]
    fns = {}
    for name, n_ptr in (("fwd", 5), ("dq", 7), ("dkdv", 8)):
        fn = getattr(lib, f"bigdl_flash_{name}")
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * n_ptr + dims
        fns[name] = fn
    return fns


def _check(cond, msg):
    if not cond:
        raise ValueError(f"flash_attention: {msg}")


def _check_cuda(q, k, v, *rest):
    """Device, shape, dtype, contiguity and alignment of the inputs."""
    _check(q.is_cuda and all(x.device == q.device for x in (k, v, *rest)),
           "all tensors must be on one CUDA device")
    _check(flash_supported(q, k) and _head_dim_ok(q.shape[-1])
           and v.shape == k.shape and v.dtype == q.dtype,
           f"unsupported q{tuple(q.shape)} k{tuple(k.shape)} "
           f"v{tuple(v.shape)} {q.dtype}: need (B, S, H, D) with D in "
           f"(32, 64, 128, 192, 256) or a multiple of 64 past 256, equal "
           f"B/H/D, float32 or bfloat16")
    for x in (q, k, v, *rest):
        _check(x.is_contiguous(), "inputs must be contiguous")
        _check(x.data_ptr() % 16 == 0, "inputs must be 16-byte aligned")


def _check_cuda_bwd(q, k, v, do, lse, delta):
    _check_cuda(q, k, v, do, lse, delta)
    _check(do.shape == q.shape and do.dtype == q.dtype
           and lse.dtype == delta.dtype == torch.float32
           and lse.shape == delta.shape == q.shape[:3],
           "dO must match q; lse and delta must be (B, S, H) float32")


def _work(name, q, k):
    """The workspace of kernel ``name`` on a 3xTF32 route (every f32
    call): the tf32 high and low parts of the operands it walks, 2 floats
    an element of K for the forward, 4 for dq (K and V), 4 an element of
    Q for dk/dv (Q and dO); else None."""
    if flash_route(q.dtype, q.shape[-1], name) not in TF32_ROUTES:
        return None
    n = {"fwd": 2 * k.numel(), "dq": 4 * k.numel(), "dkdv": 4 * q.numel()}
    return torch.empty(n[name], dtype=torch.float32, device=q.device)


def _launch(name, q, k, ptrs, scale, causal):
    """Launch kernel ``name``; True where it ran on a 3xTF32 route (it
    took a workspace)."""
    b, sq, h, d = q.shape
    fn = _kernel_fns()[name]
    work = _work(name, q, k)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(_DTYPE_CODES[q.dtype], *[x.data_ptr() for x in ptrs], b, h,
                 sq, k.shape[1], d, float(scale), int(bool(causal)),
                 stream, None if work is None else work.data_ptr())
    if err:
        raise RuntimeError(f"flash_{name} kernel launch failed (code {err})")
    return work is not None


def flash_fwd(q, k, v, scale, causal):
    """Forward: (o, lse) of q (B, Sq, H, D) against k, v (B, Skv, H, D)."""
    if q.device.type == "cpu":
        return flash_fwd_ref(q, k, v, scale, causal)
    global fwd_launches, fwd_tf32_launches
    _check_cuda(q, k, v)
    o = torch.empty_like(q)
    lse = torch.empty(q.shape[:3], dtype=torch.float32, device=q.device)
    fwd_tf32_launches += _launch("fwd", q, k, (q, k, v, o, lse), scale,
                                 causal)
    fwd_launches += 1
    return o, lse


def flash_dq(q, k, v, do, lse, delta, scale, causal):
    """dq from the saved lse and delta = rowsum(dO∘O) − g_lse."""
    if q.device.type == "cpu":
        return flash_dq_ref(q, k, v, do, lse, delta, scale, causal)
    global dq_launches, dq_tf32_launches
    _check_cuda_bwd(q, k, v, do, lse, delta)
    dq = torch.empty_like(q)
    dq_tf32_launches += _launch("dq", q, k, (q, k, v, do, lse, delta, dq),
                                scale, causal)
    dq_launches += 1
    return dq


def flash_dkdv(q, k, v, do, lse, delta, scale, causal):
    """(dk, dv) from the saved lse and delta."""
    if q.device.type == "cpu":
        return flash_dkdv_ref(q, k, v, do, lse, delta, scale, causal)
    global dkdv_launches, dkdv_tf32_launches
    _check_cuda_bwd(q, k, v, do, lse, delta)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    dkdv_tf32_launches += _launch(
        "dkdv", q, k, (q, k, v, do, lse, delta, dk, dv), scale, causal)
    dkdv_launches += 1
    return dk, dv


class _Flash(torch.autograd.Function):
    """(o, lse) with the FlashAttention-2 backward; both outputs are
    differentiable."""

    @staticmethod
    def forward(ctx, q, k, v, scale, causal):
        o, lse = flash_fwd(q, k, v, scale, causal)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.scale, ctx.causal = scale, causal
        return o, lse

    @staticmethod
    def backward(ctx, g, g_lse):
        q, k, v, o, lse = ctx.saved_tensors
        if g is None:
            g = torch.zeros_like(o)
        # with lse an output, dS gains + g_lse·P: fold it into delta
        delta = (g.float() * o.float()).sum(dim=-1)
        if g_lse is not None:
            delta = delta - g_lse.float()
        g = g.to(q.dtype).contiguous()
        delta = delta.contiguous()
        dq = flash_dq(q, k, v, g, lse, delta, ctx.scale, ctx.causal)
        dk, dv = flash_dkdv(q, k, v, g, lse, delta, ctx.scale, ctx.causal)
        return dq, dk, dv, None, None


def flash_attention_with_lse(q, k, v, *, causal: bool = False,
                             scale: float | None = None):
    """Tiled online-softmax attention over (B, S, H, D) that also returns
    the per-row logsumexp (B, S, H) f32 of the scaled scores. Both
    outputs are differentiable.

    Any head dim D: where the kernels are not built for D, q, k and v are
    zero-padded to :func:`padded_head_dim` and o is sliced back to D. The
    scale comes from the true D; the zero columns add exact zeros to the
    scores, and autograd through the pad and the slice gives dq, dk and
    dv at D (delta = rowsum(dO∘O) sums o's zero columns, adding nothing).
    """
    d = q.shape[-1]
    scale = d ** -0.5 if scale is None else float(scale)
    q, k, v = (x.contiguous() for x in (q, k, v))
    width = padded_head_dim(d) if d >= 1 else d
    if width == d:
        return _Flash.apply(q, k, v, scale, bool(causal))
    q, k, v = (F.pad(x, (0, width - d)) for x in (q, k, v))
    o, lse = _Flash.apply(q, k, v, scale, bool(causal))
    return o[..., :d], lse


def flash_attention(q, k, v, *, causal: bool = False,
                    scale: float | None = None):
    """Attention over (B, S, H, D) through the flash kernels;
    differentiable via the fused FlashAttention-2 backward."""
    o, _ = flash_attention_with_lse(q, k, v, causal=causal, scale=scale)
    return o

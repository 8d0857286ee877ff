"""Fused LM-head cross-entropy (counterpart of
``bigdl_tpu/ops/pallas/fused_ce.py``): the negative log-likelihood of
``logits = h·Wᵀ + b`` without materialising the (N, V) logits.

Three kernels, each with its plain PyTorch version beside it:

- ``fused_ce_fwd`` — per-row nll and lse, online over vocab tiles;
- ``fused_ce_dh``  — dh = Σ_v dlogits·W;
- ``fused_ce_dw``  — dW = Σ_n dlogitsᵀ·h and db = Σ_n dlogits.

Which kernel of ``csrc/fused_ce.cu`` runs a call is :func:`kernel_route`:
in bf16 all three run on the tensor cores, dh and dW/db past D 1024 as
two passes a chunk of rows (dl into a workspace, then dl times the
walked operand); in f32 all three run in 3xTF32 on the tensor cores
(each operand split into tf32 high and low parts, summed in f32), with
the parts of the operand they walk written first to a workspace. The
wrapper allocates each workspace (:func:`workspace_floats`).

On a CUDA tensor each launches the hand-written Hopper kernel of
``csrc/fused_ce.cu`` (built at first use, see ``_build.py``) or raises;
on a CPU tensor it takes its plain version (``*_ref``). ``_LinearCE``
(a ``torch.autograd.Function``) saves (h, w, b, t, lse) and its backward
launches dh, then dW/db, as the JAX package's ``_linear_ce_bwd`` does.

Arithmetic matches the TPU kernel: logits are f32 sums of products of
the storage dtype plus the f32 bias; dlogits = (exp(s − lse) − onehot)·g
in f32, rounded to W's dtype before dh and to h's dtype before dW; db
sums the unrounded f32 dlogits. Targets are 1-based; a target outside
[1, V] (a 0 padding label) matches no class, so its nll is lse and its
one-hot is zero in the backward. A bias of None counts as zeros.

``fwd_launches``, ``dh_launches`` and ``dw_launches`` count kernel
launches, so a run can show its main path went through the kernels;
``fwd_tf32_launches``, ``dh_tf32_launches`` and ``dw_tf32_launches``
count those on the route "tf32" (f32: the 3xTF32 kernels) apart, and
``dh_chunked_launches`` and ``dw_chunked_launches`` those on the route
"tc_chunked" (bf16 past D 1024).
"""
from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

__all__ = ["linear_cross_entropy", "linear_ce_supported",
           "linear_cross_entropy_ref", "fused_ce_fwd", "fused_ce_dh",
           "fused_ce_dw", "fused_ce_fwd_ref", "fused_ce_dh_ref",
           "fused_ce_dw_ref", "kernel_route", "workspace_floats",
           "fwd_launches", "dh_launches", "dw_launches",
           "fwd_tf32_launches", "dh_tf32_launches", "dw_tf32_launches",
           "dh_chunked_launches", "dw_chunked_launches"]

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
#: the bf16 backward's cluster kernels take D up to this (four CTAs of
#: 256 columns: ``kClusterD`` in csrc/fused_ce.cu)
_CLUSTER_D = 1024
#: past it the two chunked passes: the bytes of their workspace, one chunk
#: of resident rows' bf16 dl and dW's db partials (``kChunkBytes``), in
#: tiles of 128 rows x 256 walked columns (``kFwdRows`` x ``kFwdCols``)
_CHUNK_BYTES = 128 << 20
_TILE_ROWS, _TILE_COLS = 128, 256

#: kernel launches since import (reset by assigning 0)
fwd_launches = 0
dh_launches = 0
dw_launches = 0
#: of them, launches on the route "tf32"
fwd_tf32_launches = 0
dh_tf32_launches = 0
dw_tf32_launches = 0
#: and on the route "tc_chunked"
dh_chunked_launches = 0
dw_chunked_launches = 0


def linear_ce_supported(h, w) -> bool:
    """Shapes and dtypes ``linear_cross_entropy`` takes to the kernels:
    (N, D) h and (V, D) w of one dtype, float32 or bfloat16. Any N, V and
    D (ragged tiles are masked in the kernels; a D that is not a multiple
    of 8, which the kernels need, is zero-padded to one first)."""
    return (h.dim() == 2 and w.dim() == 2 and h.shape[1] == w.shape[1]
            and h.shape[1] > 0 and h.shape[0] > 0 and w.shape[0] > 0
            and h.dtype in _DTYPE_CODES and w.dtype == h.dtype)


def kernel_route(dtype, d: int, kernel: str) -> str | None:
    """The kernel of csrc/fused_ce.cu that ``kernel`` ("fwd", "dh" or
    "dw") runs for ``dtype`` at feature width ``d``, as its C entries
    pick it: the forward ``"tc"`` in bf16 (``fce_fwd_tc_kernel``) and
    ``"tf32"`` in f32 (``fce_fwd_tf32_kernel``: 3xTF32 on the tensor
    cores); dh and dW/db ``"tc_cluster"`` in bf16 up to D 1024
    (``fce_bwd_tc_kernel``: wgmma in four-CTA clusters), ``"tc_chunked"``
    in bf16 past it (``fce_dl_tc_kernel`` then ``fce_gemm_tc_kernel``, a
    chunk of resident rows at a time: wgmma fed by TMA) and ``"tf32"`` in
    f32 at every D (``fce_bwd_tf32_kernel``: 3xTF32 on the tensor cores,
    two-CTA clusters). None where no kernel takes the call. A width the
    kernels do not take (no multiple of 8) reports the route of the
    width ``linear_cross_entropy`` pads it to."""
    if d < 1 or dtype not in _DTYPE_CODES or kernel not in ("fwd", "dh",
                                                            "dw"):
        return None
    d += -d % 8
    if dtype == torch.float32:
        return "tf32"
    if kernel == "fwd":
        return "tc"
    return "tc_cluster" if d <= _CLUSTER_D else "tc_chunked"


def _chunk_rows(n_res: int, n_walk: int, fixed: int) -> int:
    """Resident rows a chunk of the route "tc_chunked" takes
    (``chunk_rows`` in csrc/fused_ce.cu): the most tiles of 128 whose
    bf16 dl, ``n_walk`` columns rounded up to 8 a row, fits
    ``_CHUNK_BYTES`` beside ``fixed`` bytes, at least one, no more than
    ``n_res`` rows need."""
    row = (n_walk + -n_walk % 8) * 2
    fit = max(1, (_CHUNK_BYTES - fixed) // row // _TILE_ROWS) * _TILE_ROWS
    return min(fit, -(-n_res // _TILE_ROWS) * _TILE_ROWS)


def workspace_floats(kernel: str, n: int, v: int, d: int, dtype) -> int:
    """f32 elements of the workspace ``kernel`` needs at (N, V, D): on
    the route "tf32" the tf32 high and low parts of the operand it walks,
    2·V·D for the forward and dh (W's) and 2·N·D for dW (h's); on
    "tc_chunked" one chunk of bf16 dl (``_chunk_rows`` resident rows x
    the walked rows rounded up to 8: V for dh, N for dW) and, for dW, db's
    f32 partials (one a vocab row and tile of 256 tokens), together at
    most ``_CHUNK_BYTES`` where one tile of rows fits; else 0."""
    route = kernel_route(dtype, d, kernel)
    if route == "tf32":
        return 2 * (n if kernel == "dw" else v) * d
    if route != "tc_chunked":
        return 0
    n_res, n_walk = (v, n) if kernel == "dw" else (n, v)
    parts = -(-n_walk // _TILE_COLS) * n_res if kernel == "dw" else 0
    return (_chunk_rows(n_res, n_walk, 4 * parts)
            * (n_walk + -n_walk % 8) // 2 + parts)


# --------------------------------------------------------------------------
# plain versions
# --------------------------------------------------------------------------

def _logits(h, w, b):
    """(N, V) f32 logits: f32 products of the storage dtype plus the f32
    bias (as the TPU kernel's ``_logits_tile``)."""
    return h.float() @ w.float().T + b.float()


def _onehot(t, v):
    """(N, V) f32 one-hot of the 1-based targets; out-of-contract targets
    give a zero row."""
    cols = torch.arange(v, device=t.device)
    return (cols[None, :] == (t.long() - 1)[:, None]).float()


def _dlogits(h, w, b, t, lse, g):
    p = torch.exp(_logits(h, w, b) - lse[:, None])
    return (p - _onehot(t, w.shape[0])) * g.float()[:, None]


def fused_ce_fwd_ref(h, w, b, t):
    """Plain version of :func:`fused_ce_fwd`: (nll, lse), each (N,) f32."""
    s = _logits(h, w, b)
    lse = torch.logsumexp(s, dim=-1)
    return lse - (s * _onehot(t, w.shape[0])).sum(dim=-1), lse


def fused_ce_dh_ref(h, w, b, t, lse, g):
    """Plain version of :func:`fused_ce_dh`: dh in h's dtype."""
    dl = _dlogits(h, w, b, t, lse, g)
    return (dl.to(w.dtype).float() @ w.float()).to(h.dtype)


def fused_ce_dw_ref(h, w, b, t, lse, g):
    """Plain version of :func:`fused_ce_dw`: (dW in w's dtype, db in
    f32)."""
    dl = _dlogits(h, w, b, t, lse, g)
    dw = (dl.to(h.dtype).float().T @ h.float()).to(w.dtype)
    return dw, dl.sum(dim=0)


def linear_cross_entropy_ref(h, w, b, targets, *, reduction: str = "mean"):
    """The materialised-logits path (the JAX package's ``use_kernel=False``)
    as one differentiable torch function: ``h @ wᵀ`` in h's dtype, then
    f32 plus the bias, logsumexp, and the target logit of in-contract
    targets."""
    v = w.shape[0]
    bias = b if b is not None else torch.zeros(v, dtype=h.dtype,
                                               device=h.device)
    logits = (h @ w.T.to(h.dtype)).float() + bias
    lse = torch.logsumexp(logits, dim=-1)
    t0 = targets.long() - 1
    tl = torch.gather(logits, 1, t0.clamp(0, v - 1)[:, None])[:, 0]
    in_contract = (t0 >= 0) & (t0 < v)
    nll = lse - torch.where(in_contract, tl, torch.zeros_like(tl))
    total = nll.sum()
    return total / h.shape[0] if reduction == "mean" else total


# --------------------------------------------------------------------------
# kernel wrappers
# --------------------------------------------------------------------------

@functools.cache
def _kernel_fns():
    """The three C entries of csrc/fused_ce.cu, built at first use."""
    from bigdl_tpu_torch.ops._build import load_library
    return bind(load_library("fused_ce.cu"))


def bind(lib: ctypes.CDLL) -> dict:
    """The typed entries ``{"fwd", "fwd_splits", "dh", "dh_splits",
    "dw"}`` of a library built from csrc/fused_ce.cu. Each of the three
    kernels' entries takes the workspace last, after the stream (a
    library built before it took one ignores it)."""
    dims = [ctypes.c_int] * 3
    fns = {}
    for name, n_ptr, extra in (("fwd", 7, 1), ("dh", 8, 1), ("dw", 8, 0)):
        fn = getattr(lib, f"bigdl_fce_{name}")
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * n_ptr + dims
                       + [ctypes.c_int] * extra + [ctypes.c_void_p] * 2)
        fns[name] = fn
    for name, n_int in (("fwd_splits", 5), ("dh_splits", 4)):
        fn = getattr(lib, f"bigdl_fce_{name}")
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_int] * n_int
        fns[name] = fn
    return fns


def _check(cond, msg):
    if not cond:
        raise ValueError(f"fused_ce: {msg}")


def _check_cuda(h, w, b, t, *rest):
    """Device, shape, dtype, contiguity and alignment of the inputs."""
    n, v = h.shape[0], w.shape[0]
    _check(h.is_cuda and all(x.device == h.device for x in (w, b, t, *rest)),
           "all tensors must be on one CUDA device")
    _check(linear_ce_supported(h, w) and h.shape[1] % 8 == 0,
           f"unsupported h{tuple(h.shape)} {h.dtype}, w{tuple(w.shape)} "
           f"{w.dtype}: need (N, D) and (V, D) of one dtype, float32 or "
           f"bfloat16, D a multiple of 8")
    _check(b.shape == (v,) and b.dtype == torch.float32
           and t.shape == (n,) and t.dtype == torch.int32,
           "bias must be (V,) float32 and targets (N,) int32")
    for x in rest:
        _check(x.shape == (n,) and x.dtype == torch.float32,
               "lse and g must be (N,) float32")
    for x in (h, w, b, t, *rest):
        _check(x.is_contiguous(), "inputs must be contiguous")
        _check(x.data_ptr() % 16 == 0, "inputs must be 16-byte aligned")


def _launch(name, h, ptrs, *extra):
    n, d = h.shape
    v = ptrs[1].shape[0]
    fn = _kernel_fns()[name]
    floats = workspace_floats(name, n, v, d, h.dtype)
    work = (torch.empty(floats, dtype=torch.float32, device=h.device)
            if floats else None)
    with torch.cuda.device(h.device):
        stream = torch.cuda.current_stream(h.device).cuda_stream
        err = fn(_DTYPE_CODES[h.dtype],
                 *[0 if x is None else x.data_ptr() for x in ptrs], n, v, d,
                 *extra, stream, None if work is None else work.data_ptr())
    if err:
        raise RuntimeError(f"fused_ce_{name} kernel launch failed "
                           f"(code {err})")


def fused_ce_fwd(h, w, b, t):
    """Forward: (nll, lse), each (N,) f32, of (N, D) h against (V, D) w,
    (V,) f32 bias and (N,) int32 1-based targets."""
    if h.device.type == "cpu":
        return fused_ce_fwd_ref(h, w, b, t)
    global fwd_launches, fwd_tf32_launches
    _check_cuda(h, w, b, t)
    (n, d), v = h.shape, w.shape[0]
    # the kernel splits the vocab so that a few rows still fill the card
    sms = torch.cuda.get_device_properties(h.device).multi_processor_count
    splits = _kernel_fns()["fwd_splits"](_DTYPE_CODES[h.dtype], n, v, d, sms)
    part = torch.empty((3, splits, n), dtype=torch.float32, device=h.device)
    nll = torch.empty(n, dtype=torch.float32, device=h.device)
    lse = torch.empty_like(nll)
    _launch("fwd", h, (h, w, b, t, part, nll, lse), splits)
    fwd_launches += 1
    fwd_tf32_launches += kernel_route(h.dtype, d, "fwd") == "tf32"
    return nll, lse


def fused_ce_dh(h, w, b, t, lse, g):
    """dh (h's dtype) from the saved lse and the nll cotangent g."""
    if h.device.type == "cpu":
        return fused_ce_dh_ref(h, w, b, t, lse, g)
    global dh_launches, dh_tf32_launches, dh_chunked_launches
    _check_cuda(h, w, b, t, lse, g)
    (n, d), v = h.shape, w.shape[0]
    dh = torch.empty_like(h)
    # the cluster kernels may split the vocab into walks whose f32
    # partial sums they add up, so that the last wave is not near empty
    splits = _kernel_fns()["dh_splits"](_DTYPE_CODES[h.dtype], n, v, d)
    part = (torch.empty((splits, n, d), dtype=torch.float32, device=h.device)
            if splits > 1 else None)
    _launch("dh", h, (h, w, b, t, lse, g, dh, part), splits)
    dh_launches += 1
    route = kernel_route(h.dtype, d, "dh")
    dh_tf32_launches += route == "tf32"
    dh_chunked_launches += route == "tc_chunked"
    return dh


def fused_ce_dw(h, w, b, t, lse, g):
    """(dW in w's dtype, db in f32) from the saved lse and g."""
    if h.device.type == "cpu":
        return fused_ce_dw_ref(h, w, b, t, lse, g)
    global dw_launches, dw_tf32_launches, dw_chunked_launches
    _check_cuda(h, w, b, t, lse, g)
    dw = torch.empty_like(w)
    db = torch.empty(w.shape[0], dtype=torch.float32, device=w.device)
    _launch("dw", h, (h, w, b, t, lse, g, dw, db))
    dw_launches += 1
    route = kernel_route(h.dtype, h.shape[1], "dw")
    dw_tf32_launches += route == "tf32"
    dw_chunked_launches += route == "tc_chunked"
    return dw, db


class _LinearCE(torch.autograd.Function):
    """Per-row nll with the two-kernel backward (dh; dW and db)."""

    @staticmethod
    def forward(ctx, h, w, b, t):
        bias = (b if b is not None else torch.zeros(
            w.shape[0], device=w.device)).float().contiguous()
        nll, lse = fused_ce_fwd(h, w, bias, t)
        ctx.save_for_backward(h, w, bias, t, lse)
        ctx.bias_dtype = None if b is None else b.dtype
        return nll

    @staticmethod
    def backward(ctx, g):
        h, w, bias, t, lse = ctx.saved_tensors
        g = g.float().contiguous()
        dh = fused_ce_dh(h, w, bias, t, lse, g)
        dw, db = fused_ce_dw(h, w, bias, t, lse, g)
        db = None if ctx.bias_dtype is None else db.to(ctx.bias_dtype)
        return dh, dw, db, None


def linear_cross_entropy(h, w, b, targets, *, reduction: str = "mean",
                         use_kernel: str | bool = "auto"):
    """Cross-entropy over ``logits = h @ w.T + b`` for (N, D) activations,
    (V, D) torch-layout weight, (V,) bias (or None) and 1-based integer
    ``targets`` (N,); the scalar mean (or, for any other ``reduction``,
    summed) negative log-likelihood.

    ``use_kernel``: "auto" or True take the kernels (on a CPU tensor their
    plain versions, inside the same autograd function) for every call they
    support (``linear_ce_supported``). A call they do not support raises
    under True, and under "auto" too unless the tensors lie on the CPU: on
    the card the materialised path is taken only when asked for. False
    takes ``linear_cross_entropy_ref`` (materialised logits).

    The kernels read rows of D elements in 16-byte pieces, so a D that is
    not a multiple of 8 runs on h and w zero-padded to the next multiple:
    the zero columns add exact zeros to every logit, and autograd through
    the pad gives dh and dW at D."""
    if use_kernel:
        supported = linear_ce_supported(h, w)
        if not supported and (use_kernel is True or h.device.type != "cpu"):
            raise ValueError(
                f"use_kernel={use_kernel!r} on {h.device.type} tensors but "
                f"the fused CE kernels do not support this call: "
                f"h{tuple(h.shape)} {h.dtype}, w{tuple(w.shape)} {w.dtype} "
                f"(need (N, D) and (V, D) of one dtype, float32 or "
                f"bfloat16); use_kernel=False takes the "
                f"materialised path")
        if supported:
            t = targets.reshape(-1).to(torch.int32).contiguous()
            pad = -h.shape[1] % 8
            if pad:
                h, w = F.pad(h, (0, pad)), F.pad(w, (0, pad))
            nll = _LinearCE.apply(h.contiguous(), w.contiguous(), b, t)
            total = nll.sum()
            return total / h.shape[0] if reduction == "mean" else total
    return linear_cross_entropy_ref(h, w, b, targets, reduction=reduction)

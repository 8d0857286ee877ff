"""Cross-map LRN, forward and analytic backward (counterpart of
``bigdl_tpu/ops/pallas/lrn.py``):

    y = r · (k + α/n · Σ_win r²)^−β,    r = x, or max(x, 0) with ``relu``

over the channels of an NCHW activation, the window of channel c being
[c − half, c + n − 1 − half] with half = (n − 1) // 2 (asymmetric for an
even n). The backward is the analytic one of the TPU kernel:

    dx = g·s^−β − (2αβ/n) · r · Σ_adj (g·r·s^−β / s)

summed over the adjoint (mirrored) window, and masked by x > 0 on the
pre-ReLU x under ``relu``.

Two kernels, each with its plain PyTorch version beside it:

- ``lrn_fwd`` — read x, write y;
- ``lrn_bwd`` — read g and x, recompute the window sums, write dx.

On a CUDA tensor each launches the hand-written Hopper kernel of
``csrc/lrn.cu`` (built at first use, see ``_build.py``) or raises; on a
CPU tensor it takes its plain version (``lrn_ref`` / ``lrn_bwd_ref``).
Past window 9 the forward is the tiled walk (:func:`walk_plan`). The
backward has two routes, named by :func:`bwd_route` and reported by the
C entry: ``"staged"`` (every window up to 9, and past it every window
whose slots min(size, C) fit the cap) and ``"any"`` (past the cap: the
tiled walk's one-launch backward, :func:`bwd_plan`, or where no tile of
it fits shared memory its two-launch form, the only one that takes an
f32 scratch, twice as large as x: :func:`any_scratch`).
``lrn`` is a ``torch.autograd.Function`` that saves only x, as the JAX
``custom_vjp`` does. All arithmetic is f32; inputs and outputs keep the
activation dtype (float32 or bfloat16).

``fwd_launches`` and ``bwd_launches`` count kernel launches, so a run
can show its main path went through the kernels; ``fwd_any_launches``
counts the forwards past window 9 (the tiled walk),
``bwd_wide_launches`` the backwards past it (the staged kernel's
runtime-window form, or the "any" route), ``bwd_staged_launches`` and
``bwd_any_launches`` the backwards by route.
"""
from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from bigdl_tpu_torch.ops import pow_neg_beta

__all__ = ["lrn", "lrn_fwd", "lrn_bwd", "lrn_ref", "lrn_bwd_ref",
           "bwd_route", "run_positions", "chunk_channels", "u_slots",
           "staged_smem", "walk_plan", "bwd_plan", "any_scratch",
           "fwd_launches", "bwd_launches",
           "fwd_any_launches", "bwd_wide_launches", "bwd_staged_launches",
           "bwd_any_launches"]

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
#: widest window with kernels of its own (each size up to it an
#: instantiation, the window kept in registers); past it the window is a
#: runtime value (kMaxSize in csrc/lrn.cu)
_RING_MAX = 9
#: the C entry's backward route codes (kRouteStaged, kRouteAny)
_ROUTES = ("staged", "any")
#: the staged backward (csrc/lrn.cu): a run's row of x or g in bytes
#: (kRowBytes), the ring's stages (kStages), the fewest channels a stage
#: holds (kChunk), the mbarriers' bytes (kBarBytes), a block's shared
#: memory (kSmemMax); past window 9 the shortest run (kAnyRunMin), the
#: bytes a CTA shrinks its run to (kAnyCtaBytes), the channels a stage
#: holds (kSlotChunk) and the most slots min(size, C) (kAnyMaxSlots: the
#: cap of the "staged" route)
_ROW_BYTES = 896
_STAGES = 3
_CHUNK = 8
_BAR_BYTES = 128
_SMEM_MAX = 232448
_ANY_RUN_MIN = 64
_ANY_CTA_BYTES = 116224
_SLOT_CHUNK = 4
_ANY_MAX_SLOTS = 256

#: the tiled walk past window 9 (csrc/lrn.cu): output channels a thread
#: sums (kWalkM), a CTA's tile of output channels (kWalkTile), warps along
#: a run at most (kWalkWarps), the grid below which a run is one warp
#: (kWalkMinCtas), rows a chunk's mbarrier covers (kWalkChunk), the
#: backward's consumer warps at most (kWalkGroups), and the bytes past
#: which a staged span is a ring of chunks (kWalkCtaBytes)
_WALK_M = 8
_WALK_TILE = 64
_WALK_WARPS = 2
_WALK_MIN_CTAS = 528
_WALK_CHUNK = 16
_WALK_GROUPS = 16
_WALK_CTA_BYTES = 116224

#: kernel launches since import (reset by assigning 0)
fwd_launches = 0
bwd_launches = 0
#: launches past ``_RING_MAX``, among the above
fwd_any_launches = 0
bwd_wide_launches = 0
#: backward launches by route, among ``bwd_launches``
bwd_staged_launches = 0
bwd_any_launches = 0


def bwd_route(dtype, shape, size: int) -> str:
    """The backward route the C entry's ``route_of`` takes for an NCHW
    ``shape`` of ``dtype`` at window ``size``: ``"staged"`` up to window
    9, and past it while min(size, C) slots fit the cap (256: every
    window at C <= 256); else ``"any"``. Shapes only."""
    if size <= _RING_MAX:
        return "staged"
    return "staged" if min(size, shape[1]) <= _ANY_MAX_SLOTS else "any"


def chunk_channels(size: int) -> int:
    """Channels a stage of the staged backward holds (``chunk_of``): the
    least multiple of the window not below 8 (a whole number of turns of
    its register rings), 4 past window 9."""
    if size > _RING_MAX:
        return _SLOT_CHUNK
    return size * -(-_CHUNK // size)


def u_slots(size: int, slots: int) -> int:
    """Slots of u past window 9 (``u_slots``): channels c .. c + lo."""
    return min((size - 1) // 2 + 1, slots)


def _row_bytes(p: int, elt: int) -> int:
    return (p * elt + 16 - elt + 15) // 16 * 16


def _consumers(p: int, elt: int) -> int:
    return (p * elt // 4 + 31) // 32 * 32


def staged_smem(p: int, elt: int, size: int, slots: int) -> int:
    """Dynamic shared memory of a staged CTA (``staged_smem``): the
    mbarriers, the ring of x and g rows, and past window 9 the ``slots``
    rows of r and t and the :func:`u_slots` of u of each consumer's
    positions."""
    ring = _STAGES * 2 * chunk_channels(size) * _row_bytes(p, elt)
    extra = ((2 * slots + u_slots(size, slots)) * _consumers(p, elt)
             * (4 // elt) * 4 if size > _RING_MAX else 0)
    return _BAR_BYTES + ring + extra


def run_positions(hw: int, dtype, size: int, c: int) -> int:
    """Positions of a plane a staged CTA walks (``run_len`` of
    ``run_cap``): at most 896 bytes of a row (448 bf16, 224 f32; past
    window 9 shrunk a warp's positions at a time until the CTA, with its
    slots for C channels, fits 116,224 bytes), the plane cut into as few
    runs as that takes, as even as multiples of 16 bytes allow; the last
    run may end mid-plane."""
    elt = dtype.itemsize
    cap = _ROW_BYTES // elt
    if size > _RING_MAX:
        slots = min(size, c)
        while cap > _ANY_RUN_MIN and staged_smem(
                cap, elt, size, slots) > _ANY_CTA_BYTES:
            cap -= 32 * (4 // elt)
    runs = -(-hw // cap)
    a = 16 // elt
    return -(-(-(-hw // runs)) // a) * a


def _walk_bar_bytes(slots: int) -> int:
    return (16 * slots + 127) // 128 * 128


def walk_plan(dtype, shape, size: int, staged=None) -> dict:
    """The tiled walk's launch (``walk_plan``) for an NCHW ``shape`` of
    ``dtype`` at window ``size`` (past 9), its staged rows of ``staged``
    (default ``dtype``; float32 for the two-launch backward's second
    pass): runs of P = 32·VEC·W positions (VEC 4 bytes of ``dtype``, W
    halved from 2 while the grid is under 528 CTAs), tiles of CT = 64
    output channels (C rounded up to 8 where fewer), a span of min(C, CT
    + size − 1) rows staged whole in chunks of 16: into two buffers
    (``bufs`` 2: persistent CTAs stage a tile's span while they walk the
    last one's) where both fit 116,224 bytes, else one, and past that
    through a ring of ``slots`` chunks."""
    n, c = shape[0], shape[1]
    hw = shape[2] * shape[3]
    vec = 4 // dtype.itemsize
    selt = (staged or dtype).itemsize
    ct = min(_WALK_TILE, -(-c // _WALK_M) * _WALK_M)
    tiles = -(-c // ct)
    w = _WALK_WARPS
    while w > 1 and n * -(-hw // (32 * vec * w)) * tiles < _WALK_MIN_CTAS:
        w //= 2
    p = 32 * vec * w
    rb = _row_bytes(p, selt)
    slots = -(-min(c, ct + size - 1) // _WALK_CHUNK)
    bufs = 2 if (_walk_bar_bytes(2 * slots) + 2 * slots * _WALK_CHUNK * rb
                 <= _WALK_CTA_BYTES) else 1
    while slots > 2 and (_walk_bar_bytes(bufs * slots)
                         + bufs * slots * _WALK_CHUNK * rb) > _WALK_CTA_BYTES:
        slots -= 1
    return dict(P=p, W=w, CT=ct, tiles=tiles, runs=-(-hw // p), slots=slots,
                bufs=bufs, smem=_walk_bar_bytes(bufs * slots)
                + bufs * slots * _WALK_CHUNK * rb)


def bwd_plan(dtype, shape, size: int) -> dict:
    """The one-launch "any" backward's launch (``bwd_plan``): runs of P =
    32·VEC positions and the widest tile CT (a multiple of 8, all of C
    where it fits) whose staged x span, f32 t rows (the tile's adjoint
    windows) and f32 u rows (its own channels) fit a block's shared
    memory (232,448 bytes); ``CT`` 0 where none fits (the two-launch
    form)."""
    c, hw = shape[1], shape[2] * shape[3]
    m, k = _WALK_M, _WALK_CHUNK
    lo = (size - 1) // 2
    hi = size - 1 - lo
    p = 32 * (4 // dtype.itemsize)
    rb = _row_bytes(p, dtype.itemsize)
    groups = -(-c // m)
    for ct in range(groups * m, 0, -m):
        trows = m * min(-(-hi // m) + (ct - 1 + lo) // m + 1, groups)
        slots = -(-min(c, trows + size - 1) // k)
        smem = (_walk_bar_bytes(slots) + slots * k * rb
                + (trows + ct) * p * 4)
        if smem <= _SMEM_MAX:
            return dict(P=p, CT=ct, tiles=-(-c // ct), runs=-(-hw // p),
                        slots=slots, warps=min(trows // m, _WALK_GROUPS),
                        smem=smem)
    return dict(P=p, CT=0, tiles=0, runs=-(-hw // p), slots=0, warps=0,
                smem=0)


def any_scratch(dtype, shape, size: int) -> bool:
    """Whether the backward takes the "any" route's two-launch form, the
    one that needs an f32 scratch of twice x's elements (t, then u):
    where no tile of the one-launch form fits (:func:`bwd_plan`)."""
    return (bwd_route(dtype, shape, size) == "any"
            and bwd_plan(dtype, shape, size)["CT"] == 0)


# --------------------------------------------------------------------------
# plain versions
# --------------------------------------------------------------------------

def _window_sum(v, size, adjoint=False):
    """Sum over the size-wide channel window (NCHW axis 1) as shifted
    slices of a zero-padded tensor. ``adjoint`` mirrors the window: the
    sum over the windows that cover a channel."""
    half = (size - 1) // 2
    lo, hi = (size - 1 - half, half) if adjoint else (half, size - 1 - half)
    c = v.shape[1]
    p = F.pad(v, (0, 0, 0, 0, lo, hi))
    out = p[:, 0:c]
    for d in range(1, size):
        out = out + p[:, d:d + c]
    return out


def _s(r, size, alpha, k):
    return k + (alpha / size) * _window_sum(r * r, size)


def lrn_ref(x, size=5, alpha=1.0, beta=0.75, k=1.0, relu=False):
    """Plain version of :func:`lrn_fwd`: f32 math, y in x's dtype."""
    r = x.float()
    if relu:
        r = torch.clamp_min(r, 0.0)
    return (r * pow_neg_beta(_s(r, size, alpha, k), beta)).to(x.dtype)


def lrn_bwd_ref(g, x, size=5, alpha=1.0, beta=0.75, k=1.0, relu=False):
    """Plain version of :func:`lrn_bwd`: dx in x's dtype from the
    cotangent g and the (pre-ReLU) input x, s recomputed in f32."""
    xf, gf = x.float(), g.float()
    r = torch.clamp_min(xf, 0.0) if relu else xf
    s = _s(r, size, alpha, k)
    sb = pow_neg_beta(s, beta)
    acc = _window_sum(gf * r * sb / s, size, adjoint=True)
    dx = gf * sb - (2.0 * alpha * beta / size) * r * acc
    if relu:
        dx = torch.where(xf > 0.0, dx, torch.zeros_like(dx))
    return dx.to(x.dtype)


# --------------------------------------------------------------------------
# kernel wrappers
# --------------------------------------------------------------------------

_TAIL = ([ctypes.c_int] * 4 + [ctypes.c_float] * 3
         + [ctypes.c_int, ctypes.c_void_p])
#: the C entries' parameters: dtype, the tensors (the backward's last the
#: two-launch form's f32 scratch), N, C, H*W, size, alpha, beta, k, relu,
#: the stream; the backward reports its route last
_ARGTYPES = {
    "fwd": [ctypes.c_int] + [ctypes.c_void_p] * 2 + _TAIL,
    "bwd": ([ctypes.c_int] + [ctypes.c_void_p] * 4 + _TAIL
            + [ctypes.POINTER(ctypes.c_int)]),
}


@functools.cache
def _kernel_fns():
    """The typed C entries ``{"fwd", "bwd"}`` of csrc/lrn.cu, built at
    first use."""
    from bigdl_tpu_torch.ops._build import load_library
    lib = load_library("lrn.cu")
    fns = {}
    for name, argtypes in _ARGTYPES.items():
        fn = getattr(lib, f"bigdl_lrn_{name}")
        fn.restype = ctypes.c_int
        fn.argtypes = argtypes
        fns[name] = fn
    return fns


def _check(cond, msg):
    if not cond:
        raise ValueError(f"lrn: {msg}")


def _check_cuda(x, size, *rest):
    _check(x.is_cuda and all(t.device == x.device for t in rest),
           "all tensors must be on one CUDA device")
    _check(x.dim() == 4, f"need an NCHW tensor, got shape {tuple(x.shape)}")
    _check(x.dtype in _DTYPE_CODES,
           f"dtype {x.dtype} not supported (float32 or bfloat16)")
    _check(size >= 1, f"size {size}: need a window of at least 1")
    for t in (x, *rest):
        _check(t.shape == x.shape and t.dtype == x.dtype,
               "g must match x in shape and dtype")
        _check(t.is_contiguous(), "inputs must be contiguous NCHW")


def _launch(name, x, ptrs, size, alpha, beta, k, relu):
    """Run C entry ``name`` on the current stream; the backward's route
    as the entry reports it (None for the forward). Raises on an error
    code."""
    n, c, h, w = x.shape
    fn = _kernel_fns()[name]
    took = ctypes.c_int(-1)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(_DTYPE_CODES[x.dtype],
                 *[None if t is None else t.data_ptr() for t in ptrs], n, c,
                 h * w, size, float(alpha), float(beta), float(k),
                 int(bool(relu)), stream,
                 *((ctypes.byref(took),) if name == "bwd" else ()))
    if err:
        raise RuntimeError(f"lrn_{name} kernel launch failed (code {err})")
    return _ROUTES[took.value] if name == "bwd" else None


def lrn_fwd(x, size=5, alpha=1.0, beta=0.75, k=1.0, relu=False):
    """Forward: y (x's dtype) of NCHW x."""
    if x.device.type == "cpu":
        return lrn_ref(x, size, alpha, beta, k, relu)
    global fwd_launches, fwd_any_launches
    _check_cuda(x, size)
    y = torch.empty_like(x)
    if x.numel():
        _launch("fwd", x, (x, y), size, alpha, beta, k, relu)
        fwd_launches += 1
        fwd_any_launches += size > _RING_MAX
    return y


def lrn_bwd(g, x, size=5, alpha=1.0, beta=0.75, k=1.0, relu=False):
    """Backward: dx (x's dtype) from the cotangent g and the saved x."""
    if x.device.type == "cpu":
        return lrn_bwd_ref(g, x, size, alpha, beta, k, relu)
    global bwd_launches, bwd_wide_launches, bwd_staged_launches
    global bwd_any_launches
    _check_cuda(x, size, g)
    dx = torch.empty_like(x)
    want = bwd_route(x.dtype, x.shape, size)
    # the "any" route's two-launch form parks t = g·r·s^-β/s and u =
    # g·s^-β in an f32 scratch
    scratch = (torch.empty(2 * x.numel(), dtype=torch.float32,
                           device=x.device)
               if any_scratch(x.dtype, x.shape, size) else None)
    if x.numel():
        took = _launch("bwd", x, (g, x, dx, scratch), size, alpha, beta, k,
                       relu)
        if took != want:
            raise RuntimeError(f"lrn_bwd: the C entry took the {took} route "
                               f"where bwd_route names {want}")
        bwd_launches += 1
        bwd_wide_launches += size > _RING_MAX
        bwd_staged_launches += want == "staged"
        bwd_any_launches += want == "any"
    return dx


class _LRN(torch.autograd.Function):
    """The forward kernel, and the backward kernel from the saved x."""

    @staticmethod
    def forward(ctx, x, size, alpha, beta, k, relu):
        ctx.save_for_backward(x)
        ctx.args = (size, alpha, beta, k, relu)
        return lrn_fwd(x, size, alpha, beta, k, relu)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        # autograd may hand over a broadcast or strided cotangent
        return (lrn_bwd(g.contiguous(), x, *ctx.args),
                None, None, None, None, None)


def lrn(x, size: int = 5, alpha: float = 1.0, beta: float = 0.75,
        k: float = 1.0, relu: bool = False):
    """Cross-map LRN over NCHW ``x``; ``relu=True`` applies ReLU first in
    the same pass (y = lrn(max(x, 0)), gradient masked on the pre-ReLU
    x). Differentiable in x; saves only x for the backward."""
    return _LRN.apply(x, size, alpha, beta, k, relu)

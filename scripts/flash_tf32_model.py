#!/usr/bin/env python3
"""How the f32 flash backward past head dim 256 sums dP = dO·Vᵀ on the
tensor cores, and how the f32 plain version sums it, modelled on the
host (no card, no build).

The model of one TF32 ``wgmma`` K step (``tc_dot``): the 8 products are
exact, each term (with the accumulator's value) is truncated toward zero
to a multiple of 2^(E - bits), 2^E the next power of two above the
largest term, and the sum is truncated toward zero to f32. At ``bits``
24 it gives, to the digits the card printed, the dP errors read on an
NVIDIA H100 at the element below for the kernel's 3xTF32 sums
(``dp_3xtf32``), for the group-grid variant of
``flash_sliced_knockout.py``'s ``dp_grid`` (``dp_grid``) and, for the
f32 plain version (cuBLAS), a sequential f32 FMA chain (``dp_fma``).
It prints each one's error against float64:

* over ``--rows`` random rows of ``--dim`` columns (numpy, ``--seed``),
  rms and worst, at bits 20 and 24;
* at one row of ``scripts/flash_ab.py``'s draw (``--ab-dims``, its f32
  draw of the last head dim at ``--ab-batch``/``--ab-seq``/``--ab-heads``
  and its ``--seed``, drawn by its own ``draw``): dO and V of query and
  key 0 of (b 0, h 0), where a causal dS = P∘(dP - delta) cancels, so
  dq's row 0 moves by scale·K[0]·(dP's error); the script prints
  scale·K at ``--at``, which turns a dq error read on the card into
  dP's.

    python3 scripts/flash_tf32_model.py [--rows 3000] [--dim 1024]
        [--seed 0] [--ab-dims 320 384 512 576 1024] [--at 930]
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]


def tf32(x):
    """x rounded to tf32 (10 mantissa bits, to nearest, ties away from
    zero: ``cvt.rna.tf32.f32``) by integer operations on its bits, as
    ``to_tf32`` in csrc/hopper.cuh does."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def split_tf32(x):
    """(hi, lo) = (tf32(x), tf32(x - hi)), as ``split_tf32``."""
    hi = tf32(x)
    return hi, tf32(x - hi)


def split_grid(x):
    """(hi, lo) of x (rows, D) f32 on the grid of each row's groups of 8
    columns, as ``split_tf32_grid`` splits: hi the nearest multiple of
    2^(e - 10) for a group below 2^e, lo = tf32(x - hi)."""
    g = x.reshape(x.shape[0], -1, 8)
    e = torch.frexp(g.abs().amax(-1, keepdim=True))[1]
    step = torch.ldexp(torch.ones_like(g[..., :1]), e - 10)
    hi = (torch.round(g / step) * step).reshape(x.shape)
    return hi, tf32(x - hi)


def to_f32_rz(x):
    """float64 x to f32, truncated toward zero."""
    f = x.float()
    over = f.double().abs() > x.abs()
    return torch.where(over, torch.nextafter(f, torch.zeros_like(f)), f)


def tc_dot(a, b, c=None, bits=24):
    """Each row of a·b over its 8 columns (plus c), as the model of one
    tensor-core K step (the module docstring), as float64 values of
    f32."""
    t = a.double() * b.double()
    if c is not None:
        t = torch.cat([t, c.double()[:, None]], 1)
    top = t.abs().amax(1)
    e = torch.frexp(torch.where(top > 0, top, torch.ones_like(top)))[1]
    unit = torch.ldexp(torch.ones_like(top), e - bits)[:, None]
    return to_f32_rz((torch.trunc(t / unit) * unit).sum(1)).double()


def dp_3xtf32(a, b, bits=24):
    """Rows of a·b as the kernels' score steps sum them (``tf_score_step``):
    tf32 splits; per 2 K steps hi·lo and lo·hi in a fresh sum, hi·hi on
    top, added to the row's sum in f32."""
    (ah, al), (bh, bl) = split_tf32(a), split_tf32(b)
    s = torch.zeros(a.shape[0], dtype=torch.float32)
    for k0 in range(0, a.shape[1], 16):
        acc = torch.zeros(a.shape[0], dtype=torch.float64)
        ks = (slice(k0, k0 + 8), slice(k0 + 8, k0 + 16))
        for k in ks:
            acc = tc_dot(ah[:, k], bl[:, k], acc, bits)
            acc = tc_dot(al[:, k], bh[:, k], acc, bits)
        for k in ks:
            acc = tc_dot(ah[:, k], bh[:, k], acc, bits)
        s = s + acc.float()
    return s.double()


def dp_grid(a, b, bits=24):
    """Rows of a·b as knockout ``dp_grid`` forms dP: grid splits; per K
    step hi·lo, lo·hi and lo·lo in a fresh sum, then hi·hi alone, each
    added in f32."""
    (ah, al), (bh, bl) = split_grid(a), split_grid(b)
    s = torch.zeros(a.shape[0], dtype=torch.float32)
    for k0 in range(0, a.shape[1], 8):
        k = slice(k0, k0 + 8)
        low = tc_dot(ah[:, k], bl[:, k], None, bits)
        low = tc_dot(al[:, k], bh[:, k], low, bits)
        low = tc_dot(al[:, k], bl[:, k], low, bits)
        s = s + low.float()
        s = s + tc_dot(ah[:, k], bh[:, k], None, bits).float()
    return s.double()


def dp_fma(a, b, bits=None):
    """Rows of a·b as one f32 FMA chain over the columns in order."""
    s = torch.zeros(a.shape[0], dtype=torch.float32)
    for k in range(a.shape[1]):
        s = (s.double() + a[:, k].double() * b[:, k].double()).float()
    return s.double()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", type=int, default=3000)
    ap.add_argument("--dim", type=int, default=1024)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ab-dims", type=int, nargs="+",
                    default=[320, 384, 512, 576, 1024])
    ap.add_argument("--ab-batch", type=int, default=2)
    ap.add_argument("--ab-seq", type=int, default=2048)
    ap.add_argument("--ab-heads", type=int, default=2)
    ap.add_argument("--at", type=int, default=930,
                    help="the column of dq's row 0 to convert at")
    args = ap.parse_args(argv)
    rs = np.random.default_rng(args.seed)
    a, b = (torch.from_numpy(rs.standard_normal((args.rows, args.dim),
                                                np.float32))
            for _ in range(2))
    truth = (a.double() * b.double()).sum(1)
    for bits in (20, 24):
        for fn in (dp_3xtf32, dp_grid, dp_fma):
            err = fn(a, b, bits) - truth
            print(f"[model] rows={args.rows} D={args.dim} bits={bits} "
                  f"{fn.__name__} " + json.dumps(dict(
                      rms=float(err.square().mean().sqrt()),
                      worst=float(err.abs().max()))), flush=True)
    sys.path.insert(0, str(ROOT / "scripts"))
    import flash_ab
    gen = torch.Generator().manual_seed(args.seed)
    for d in args.ab_dims:
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v, do = flash_ab.draw(gen, args.ab_batch, args.ab_seq,
                                        args.ab_heads, d, dtype)
    a, b = do[0, 0, 0][None], v[0, 0, 0][None]
    truth = (a.double() * b.double()).sum(1)
    for bits in (20, 24):
        print(f"[model] flash_ab draw B={args.ab_batch} S={args.ab_seq} "
              f"H={args.ab_heads} D={d} f32, dO·V of (b 0, q 0, h 0) "
              f"bits={bits} " + json.dumps(dict(
                  dp=float(truth[0]),
                  dp_3xtf32_err=float(dp_3xtf32(a, b, bits)[0] - truth[0]),
                  dp_grid_err=float(dp_grid(a, b, bits)[0] - truth[0]),
                  dp_fma_err=float(dp_fma(a, b)[0] - truth[0]),
                  dq_row0_per_dp_err=float(d ** -0.5 * k[0, 0, 0, args.at]),
                  at=args.at)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

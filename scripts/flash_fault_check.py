#!/usr/bin/env python3
"""Planted-fault check of ``chip_smoke.py``'s flash tolerances on one
NVIDIA card.

Builds ``bigdl_tpu_torch/csrc/flash_attention.cu`` as it is and in
broken copies (written to a temporary directory, never into the
checkout), runs each forward and backward at B4 S2048, bf16, causal,
with ``--heads`` heads of ``--dim`` (the training shapes H8 D128 by
default; D 128 and below, where the planted dk/dv fault's kernel runs)
and prints, for each, the max abs error of o, dq, dk and dv against the
plain versions and their worst error over the elementwise limits that
``chip_smoke.py`` applies (pass: <= 1), beside o's earlier limit, 1e-2
x max(1, max|plain|), and the gradients' earlier one, (2^-7, 2^-7);
for each gradient also where its worst element lies (b, s, h, d), that
element's plain value, and how far flipped roundings could move it:
the sum over the element's terms whose P (dv) or dS (dk, dq) lies
within 2^-16 of it of a bf16 rounding midpoint of one bf16 step of that
P or dS times the other factor (``*_flip_room``; an error past that
room and one step of the output is no rounding). One build serves every
``--seed`` given; the sound rows over several seeds give the spread
that the gradient limits rest on. ``--skip-draws N`` drops N draws of
the inputs' size first (``scripts/flash_ab.py`` draws 8 before its
D 64 inputs at its defaults).

The forward faults, each in the bf16 tensor-core forward
(``flash_fwd_tc_kernel``, the one the bf16 training path runs) on its
last key tile (the diagonal one) of every query tile after the first,
where P·V could be handed the wrong stage of the K/V ring:

- ``v_prev_tile``: P·V reads V from the previous ring stage (the
  previous key tile);
- ``v_prev_tile_late``: the same, in the query tiles of the second half
  of the sequence only (late rows average many keys, so their |o| is
  small and a wrong V moves them least);
- ``v_prev_tile_last``: the same, in the last query tile only.

The backward fault, in the bf16 dk/dv kernel (``flash_dkdv_tc_kernel``),
which the looser gradient limit must still catch:

- ``do_prev_tile``: on the last query tile of every key tile, dPᵀ and
  Pᵀ·dO read dO from the previous ring stage (the previous 64 queries).

    python3 scripts/flash_fault_check.py [--seed N ...] [--heads H]
        [--dim D] [--skip-draws N]
"""
from __future__ import annotations

import argparse
import json
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from bigdl_tpu_torch.ops import _build  # noqa: E402
from bigdl_tpu_torch.ops import flash_attention as fa  # noqa: E402

# the bf16 forward's V stage, first match (the dq kernel has the second)
_V_LINE = "    const uint32_t vs = ks + kKV;\n"
_PREV = "kv0 + ((kt - 1) % kStages) * 2 * kKV + kKV"
FAULTS = {
    "v_prev_tile": f"    const uint32_t vs = (kt >= 1 && kt == nkt - 1) ? "
                   f"{_PREV} : ks + kKV;\n",
    "v_prev_tile_late": f"    const uint32_t vs = (kt >= 1 && kt == nkt - 1 "
                        f"&& 2 * q0 >= Sq) ? {_PREV} : ks + kKV;\n",
    "v_prev_tile_last": f"    const uint32_t vs = (kt >= 1 && kt == nkt - 1 "
                        f"&& q0 + kRows >= Sq) ? {_PREV} : ks + kKV;\n",
}
# the bf16 dk/dv kernel's dO stage (the only such line in
# flash_dkdv_tc_kernel; flash_dkdv_split_tc_kernel, past D 128, has its
# own)
_DO_LINE = "    const uint32_t dos = qs + kQD;\n"
BWD_FAULTS = {
    "do_prev_tile": "    const uint32_t dos = (it >= 1 && it == n - 1) ? "
                    "qd0 + ((it - 1) % kStages) * 2 * kQD + kQD : "
                    "qs + kQD;\n",
}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, nargs="+", default=[0])
    ap.add_argument("--heads", type=int, default=8)
    ap.add_argument("--dim", type=int, default=128,
                    help="head dim: 32, 64 or 128 (the dk/dv kernel that "
                         "the planted fault breaks)")
    ap.add_argument("--skip-draws", type=int, default=0)
    args = ap.parse_args(argv)
    if args.dim not in (32, 64, 128):
        ap.error("--dim must be 32, 64 or 128")
    if not torch.cuda.is_available():
        print("flash_fault_check: CUDA is not available", file=sys.stderr)
        return 2
    src = (ROOT / "bigdl_tpu_torch/csrc/flash_attention.cu").read_text()
    if (src.count(_V_LINE) != 2         # forward first, then dq
            or src.index(_V_LINE) > src.index("flash_dq_tc_kernel(")
            or src.index(_V_LINE) < src.index("flash_fwd_tc_kernel(")):
        raise RuntimeError("the bf16 forward's V stage line has moved; "
                           "update the planted faults")
    dkdv = src.index("flash_dkdv_tc_kernel(")
    split = src.index("flash_dkdv_split_tc_kernel(")
    if not dkdv < split or src.count(_DO_LINE, dkdv, split) != 1:
        raise RuntimeError("the bf16 dk/dv kernel's dO stage line has "
                           "moved; update the planted faults")
    sources = {"sound": src,
               **{name: src.replace(_V_LINE, line, 1)
                  for name, line in FAULTS.items()},
               **{name: src[:dkdv] + src[dkdv:split].replace(_DO_LINE, line)
                  + src[split:] for name, line in BWD_FAULTS.items()}}
    b, s, h, d = 4, 2048, args.heads, args.dim
    with tempfile.TemporaryDirectory() as tmp:
        with ThreadPoolExecutor(len(sources)) as pool:
            libs = dict(zip(sources, pool.map(
                lambda kv: _build.build_copy(kv[1], Path(tmp) / kv[0]),
                sources.items())))
        for seed in args.seed:
            _check_seed(libs, seed, b, s, h, d, args.skip_draws)
    print(chip_smoke._card())
    return 0


def _flip_room(x, y):
    """Per element of the plain ``x``·``y`` products (x (B, H, Sq, Skv)
    f32 P or dS, y its (B, S, H, D) partner, already indexed to the
    element's terms: x (n,), y (n,)): the sum of one bf16 step of x
    times |y| over the terms whose x lies within 2^-16 of x of a bf16
    rounding midpoint, i.e. how far other f32 sums could move the
    element by flipping roundings."""
    lo = x.to(torch.bfloat16).float()
    hi = torch.nextafter(lo.to(torch.bfloat16), torch.where(
        x >= lo, torch.full_like(lo, float("inf")),
        torch.full_like(lo, -float("inf"))).to(torch.bfloat16)).float()
    step = (hi - lo).abs()
    near = (x - (lo + hi) / 2).abs() <= x.abs() * 2 ** -16
    return float((step * y.abs() * near).sum())


def _check_seed(libs, seed, b, s, h, d, skip):
    """Every built version at (b, s, h, d) on inputs drawn from ``seed``
    (after ``skip`` dropped draws): one line each."""
    scale = d ** -0.5
    gen = torch.Generator().manual_seed(seed)
    for _ in range(skip):
        torch.randn((b, s, h, d), generator=gen)
    q, k, v, do = (torch.randn((b, s, h, d), generator=gen)
                   .to(torch.bfloat16).cuda() for _ in range(4))
    want, lse = fa.flash_fwd_ref(q, k, v, scale, True)
    delta = (do.float() * want.float()).sum(-1)
    want_dq = fa.flash_dq_ref(q, k, v, do, lse, delta, scale, True)
    want_dk, want_dv = fa.flash_dkdv_ref(q, k, v, do, lse, delta, scale,
                                         True)
    old_limit = 1e-2 * max(1.0, float(want.float().abs().max()))
    rms = float(want.float().square().mean().sqrt())
    p, ds = fa._probs_and_ds(q, k, v, do, lse, delta, scale, True)
    for name, lib in libs.items():
        fns = fa.bind(lib)
        fa._kernel_fns = lambda fns=fns: fns
        o, _ = fa.flash_fwd(q, k, v, scale, True)
        dq = fa.flash_dq(q, k, v, do, lse, delta, scale, True)
        dk, dv = fa.flash_dkdv(q, k, v, do, lse, delta, scale, True)
        torch.cuda.synchronize()
        err, worst = chip_smoke._flash_err("o", o, want)
        row = dict(seed=seed, shape=[b, s, h, d], max_abs_err=err,
                   worst_over_limit=worst, old_limit=old_limit,
                   caught_by_old=not err <= old_limit, rms_o=rms,
                   max_abs_o=float(want.float().abs().max()))
        for what, got, ref in (("dq", dq, want_dq), ("dk", dk, want_dk),
                               ("dv", dv, want_dv)):
            e, w = chip_smoke._flash_err(what, got, ref)
            rtol, atol = chip_smoke._flash_tol(torch.bfloat16, what, d)
            r = ref.float()
            ratio = ((got.float() - r).abs()
                     / (rtol * r.abs() + atol * r.square().mean().sqrt()))
            at = [int(i) for i in torch.unravel_index(ratio.argmax(),
                                                      ratio.shape)]
            bi, si, hi, di = at
            # the element's terms: dq sums dS·k over keys, dk dS·q and
            # dv P·dO over queries
            x, y = {"dq": (ds[bi, hi, si, :], k[bi, :, hi, di]),
                    "dk": (ds[bi, hi, :, si], q[bi, :, hi, di]),
                    "dv": (p[bi, hi, :, si], do[bi, :, hi, di])}[what]
            row.update({f"{what}_max_abs_err": e,
                        f"{what}_err_there": float(
                            (got.float() - r)[tuple(at)].abs()),
                        f"{what}_flip_room": _flip_room(x, y.float()),
                        f"{what}_worst_over_limit": w,
                        f"{what}_worst_at": at,
                        f"{what}_plain_there": float(r[tuple(at)]),
                        f"{what}_rms": float(r.square().mean().sqrt()),
                        # the earlier limit, for bit-equal P and dS
                        f"{what}_worst_over_old_limit": chip_smoke._worst(
                            got, ref, 2 ** -7, 2 ** -7)[1]})
            worst = max(worst, w)
        print(f"[fault] {name}: caught={not worst <= 1} "
              + json.dumps(row), flush=True)


if __name__ == "__main__":
    sys.exit(main())

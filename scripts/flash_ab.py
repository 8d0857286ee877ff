#!/usr/bin/env python3
"""Time two versions of the flash kernels in turns on one NVIDIA card.

Builds ``bigdl_tpu_torch/csrc/flash_attention.cu`` of this checkout and
the one under ``--other`` (a directory holding a ``flash_attention.cu``,
such as another checkout's ``bigdl_tpu_torch/csrc``; both built with
this checkout's headers) into a temporary directory and runs each
version's forward, dq and dk/dv at the ``[train]`` shapes B4 S2048 with
H·D = 1024 (H8 at D 128; ``--heads`` fixes H instead, as the wide head
dims need: ``--dims 320 512 576 1024 --batch 2 --heads 2``), causal, in
bf16 (tensor cores) and f32 (every kernel at every D in 3xTF32 on the
tensor cores: the forward and dq up to D 128 on the 128-row kernels,
route "rows_tf32", the rest "sliced_tf32"; each given a workspace by
this checkout's ``flash_route`` as the last pointer, so another
version's entry that takes none, or routes the call to a kernel that
needs none, such as an older CUDA-core f32 forward, ignores it). For
each head dim and dtype it prints whether the two versions' outputs are
bit-equal (the kernels use no atomics, so unchanged code gives equal
bits) and each version's worst error over ``chip_smoke.py``'s limits
against the plain versions (bit-equality also output by output: where
this checkout routes a call to a new kernel, this checkout's
``flash_route`` is printed beside it), then times the kernels in turns
(this, other, other, this; ``chip_smoke._time_ms`` each: L2 flushed,
median of 20): one line per kernel with both versions' times and the
ratio of their means (this / other). Last, the card's name and power
limit. It exits 1 if any output of either version is non-finite or past
its limit (after every head dim and dtype has been checked and timed, so
that a known fault does not hide the other readings). The f32 gradients
are held against the plain versions evaluated in float64
(``chip_smoke._flash_outputs``); ``--worst N`` also prints, for each f32
draw, the N elements of each version's dq, dk and dv farthest from them
(in units of their limit), each beside the f32 plain version's value and
distance.

    python3 scripts/flash_ab.py --other DIR [--dims 32 64 128]
        [--batch 4] [--seq 2048] [--heads H] [--seed N] [--worst N]
"""
from __future__ import annotations

import argparse
import json
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from bigdl_tpu_torch.ops import _build  # noqa: E402
from bigdl_tpu_torch.ops import flash_attention as fa  # noqa: E402

_ORDER = ("this", "other", "other", "this")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", required=True,
                    help="directory holding the other flash_attention.cu")
    ap.add_argument("--dims", type=int, nargs="+", default=[32, 64, 128])
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=2048)
    ap.add_argument("--heads", type=int, default=None,
                    help="heads at every head dim (default 1024 // D)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--worst", type=int, default=0,
                    help="the N worst f32 gradient elements of each draw")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("flash_ab: CUDA is not available", file=sys.stderr)
        return 2
    sources = {"this": (ROOT / "bigdl_tpu_torch/csrc/flash_attention.cu")
               .read_text(),
               "other": (Path(args.other) / "flash_attention.cu")
               .read_text()}
    card = chip_smoke._card()
    chosen = fa._kernel_fns
    gen = torch.Generator().manual_seed(args.seed)
    with tempfile.TemporaryDirectory() as tmp:
        with ThreadPoolExecutor(len(sources)) as pool:
            fns = dict(zip(sources, pool.map(
                lambda kv: fa.bind(_build.build_copy(kv[1],
                                                     Path(tmp) / kv[0])),
                sources.items())))
        chip_smoke._warm_card()
        past = []
        try:
            for d in args.dims:
                for dtype in (torch.bfloat16, torch.float32):
                    past += _ab(fns, gen, args.batch, args.seq, d, dtype,
                                card, args.heads or 1024 // d, args.worst)
        finally:
            fa._kernel_fns = chosen
    if past:
        print("[ab] past the limit (or non-finite): " + "; ".join(past),
              flush=True)
    print(card)
    return 1 if past else 0


def draw(gen, b, s, h, d, dtype):
    """q, k, v and dO of one head dim and dtype (B ``b``, S ``s``, H
    ``h``), on the host, from ``gen``: the script draws them so, head dim
    by head dim, bf16 before f32."""
    return [torch.randn((b, s, h, d), generator=gen).to(dtype)
            for _ in range(4)]


def _ab(fns, gen, b, s, d, dtype, card, h, worst_n):
    """One head dim and dtype at B ``b``, S ``s`` and H ``h``: both
    versions checked (in f32 with the ``worst_n`` worst gradient
    elements), then timed in turns; returns the outputs that are
    non-finite or past their limit, by version."""
    scale = d ** -0.5
    q, k, v, do = (x.to(chip_smoke._DEV) for x in draw(gen, b, s, h, d,
                                                        dtype))
    want = chip_smoke._flash_outputs(fa, q, k, v, do, scale, True, False)
    lse = want[1]
    delta = (do.float() * want[0].float()).sum(-1)
    name = str(dtype)[6:]
    outs, worst, past = {}, {}, []
    for version in fns:
        fa._kernel_fns = lambda f=fns[version]: f
        outs[version] = chip_smoke._flash_outputs(fa, q, k, v, do, scale,
                                                  True, True)
        torch.cuda.synchronize()
        worst[version] = {
            what: chip_smoke._flash_err(what, got, ref)[1]
            for what, got, ref in zip(("o", "lse", "dq", "dk", "dv"),
                                      outs[version], want)}
        past += [f"{version} H={h} D={d} {name} {what} ({w})"
                 for (what, w), x in zip(worst[version].items(),
                                         outs[version])
                 if not (w <= 1.0 and torch.isfinite(x).all())]
    if worst_n and dtype == torch.float32:
        _worst_elements(outs, want, (q, k, v, do, lse, delta), scale,
                        worst_n, f"B={b} S={s} H={h} D={d}")
    each = {what: torch.equal(x, y) for what, x, y in
            zip(("o", "lse", "dq", "dk", "dv"), *outs.values())}
    routes = {k: fa.flash_route(dtype, d, k) for k in ("fwd", "dq", "dkdv")}
    print(f"[ab] check B={b} S={s} H={h} D={d} {name}: bit_equal="
          f"{all(each.values())} by output {json.dumps(each)} this "
          f"checkout's routes {json.dumps(routes)} worst error / limit "
          + json.dumps(worst), flush=True)
    calls = {
        "flash_fwd": lambda: fa.flash_fwd(q, k, v, scale, True),
        "flash_dq": lambda: fa.flash_dq(q, k, v, do, lse, delta, scale,
                                        True),
        "flash_dkdv": lambda: fa.flash_dkdv(q, k, v, do, lse, delta, scale,
                                            True),
    }
    times = {kname: {"this": [], "other": []} for kname in calls}
    for version in _ORDER:
        fa._kernel_fns = lambda f=fns[version]: f
        for kname, call in calls.items():
            times[kname][version].append(chip_smoke._time_ms(call))
    for kname, t in times.items():
        row = dict(this_ms=t["this"], other_ms=t["other"],
                   ratio=float(np.mean(t["this"]) / np.mean(t["other"])))
        print(f"[ab] {kname}[{name}] B={b} S={s} H={h} D={d} causal "
              f"card='{card}' " + json.dumps(row), flush=True)
    return past


def _worst_elements(outs, want, inputs, scale, n, label):
    """The ``n`` elements of each version's dq, dk and dv farthest from
    ``want`` (``chip_smoke._flash_bwd_refs``: the plain versions in
    float64 on the same q, k, v, dO, lse and delta) by
    ``chip_smoke._worst``'s limit, each beside the f32 plain version's
    value and its distance from ``want`` in units of that limit."""
    plain = (fa.flash_dq_ref(*inputs, scale, True),
             *fa.flash_dkdv_ref(*inputs, scale, True))
    rtol, atol = chip_smoke._FLASH_TOL[(torch.float32, "grad")]
    for version, got in outs.items():
        for what, g, w, p in zip(("dq", "dk", "dv"), got[2:], want[2:],
                                 plain):
            w64, g64, p64 = w.double(), g.double(), p.double()
            limit = rtol * w64.abs() + atol * w64.square().mean().sqrt()
            top = torch.topk(((g64 - w64).abs() / limit).flatten(), n)
            for r, i in zip(top.values.tolist(), top.indices.tolist()):
                at = [int(x) for x in torch.unravel_index(
                    torch.tensor(i), g.shape)]
                lim = float(limit.flatten()[i])
                wv, pv = float(w64.flatten()[i]), float(p64.flatten()[i])
                print(f"[ab] worst {version} {what} {label} " + json.dumps(
                    dict(at_bshd=at, vs_float64=r,
                         value=float(g64.flatten()[i]), float64=wv,
                         f32_plain=pv, f32_plain_vs_float64=(pv - wv) / lim)),
                      flush=True)

if __name__ == "__main__":
    sys.exit(main())

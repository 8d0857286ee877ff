#!/usr/bin/env python3
"""Time the max-pool backward kernel against another version's in turns,
and the Inception-v1 step with and without it on the in-block pools.

(a) ``kernels``: builds this checkout's ``csrc/maxpool.cu`` and the one
of the checkout whose root is ``--parent`` (such as a ``git archive`` of
the parent commit unpacked under the git-ignored ``build/``), and at the
shapes of Inception-v1's nine in-block pools (``chip_smoke.
_MAXPOOL_POOLS``: batch 256, bf16, random normals made on the card)
times both C entries in turns (parent, this, this, parent; CUDA events,
L2 flushed, the median of 20, ``chip_smoke._time_ms``). Prints per shape
each version's ms (the mean of its two turns), this / parent, and
whether the two dx are bit-equal (this one's is also held bit for bit
against the plain version), then the sums over the nine pools.

(b) ``step``: runs ``perf -m inception_v1 -b 256`` four times in turns,
each in a process of its own: as it is ("library": every pool's
backward is the library's), with the nine in-block
``SpatialMaxPooling(3, 3, 1, 1, 1, 1)`` modules routed to
``ops.maxpool.maxpool3x3s1`` by this script in that process ("kernel":
the hand-written backward, 9 launches a step, checked), again routed,
and as it is. No module of the package dispatches the kernel. Prints
each run's ms a step and images/s, then the means and their ratio.

(c) ``knockout`` (only when named): builds copies of this checkout's
``maxpool.cu`` with one part knocked out or one setting changed
(``_KNOCKOUTS``: exact text replacements, which an edit of those lines
must update) and times each against the kept kernel in turns (kept,
copy, copy, kept) at ``_KNOCKOUT_SHAPES``; prints each copy's ms over
the kept kernel's. A copy without a stage computes garbage and is not
checked; a copy that changes a setting is held bit for bit against the
kept kernel.

Last it prints the card's name and power limit. It exits 1 if a run
fails, the versions' dx differ or a launch count is off.

    python3 scripts/maxpool_ab.py --parent DIR [--only kernels|step]
        [--warmUp 2] [-i 8]
    python3 scripts/maxpool_ab.py --only knockout
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402

_ORDER = ("parent", "this", "this", "parent")
_STEP_ORDER = ("library", "kernel", "kernel", "library")
_IN_BLOCK = (3, 3, 1, 1, 1, 1)   # (kh, kw, dh, dw, ph, pw)
_ARGTYPES = ([ctypes.c_int] + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4
             + [ctypes.c_void_p])


#: (name, [(text, replacement)], computes the same dx)
_KNOCKOUTS = (
    ("no_stage1", [("    const Units& un = un1;",
                    "    Units un = un1;\n    un.n = 0;")],
     False),
    ("no_stage2", [("    const Units& un = un2;",
                    "    Units un = un2;\n    un.n = 0;")],
     False),
    ("staging_only", [("    const Units& un = un1;",
                       "    Units un = un1;\n    un.n = 0;"),
                      ("    const Units& un = un2;",
                       "    Units un = un2;\n    un.n = 0;")],
     False),
    ("no_loads", [("  hopper::bar_expect(bar, bytes);",
                   "  hopper::bar_expect(bar, 0);\n  return;")], False),
    ("no_store", [("      hopper::bulk_store((void*)sp.lo, sp.body(buf), "
                   "sp.bytes());", "      ;")], False),
    ("stage_16k", [("kPlaneStageBytes = 32 * 1024",
                    "kPlaneStageBytes = 16 * 1024")], True),
    ("stage_64k", [("kPlaneStageBytes = 32 * 1024",
                    "kPlaneStageBytes = 64 * 1024")], True),
    ("seg_2", [("constexpr int kSeg = 4;", "constexpr int kSeg = 2;")],
     True),
    ("seg_8", [("constexpr int kSeg = 4;", "constexpr int kSeg = 8;")],
     True),
    ("threads_256", [("constexpr int kThreads = 128;",
                      "constexpr int kThreads = 256;")], True),
)
_KNOCKOUT_SHAPES = (((256, 256, 28, 28), torch.bfloat16),
                    ((256, 512, 14, 14), torch.bfloat16),
                    ((256, 832, 7, 7), torch.bfloat16),
                    ((256, 192, 28, 28), torch.float32))


def _entry(lib):
    fn = lib.bigdl_maxpool3x3s1_bwd
    fn.restype = ctypes.c_int
    fn.argtypes = _ARGTYPES
    return fn


def _call(fn, x, y, dy, dx):
    """One launch of a version's C entry on the current stream."""
    n, c, h, w = x.shape
    err = fn(1 if x.dtype == torch.bfloat16 else 0, x.data_ptr(),
             y.data_ptr(), dy.data_ptr(), dx.data_ptr(), n, c, h, w,
             torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"maxpool3x3s1_bwd launch failed (code {err})")


def ab_kernels(parent: Path, seed: int) -> bool:
    import torch.nn.functional as F
    from bigdl_tpu_torch.ops import _build
    from bigdl_tpu_torch.ops import maxpool as mp
    src = parent / "bigdl_tpu_torch" / "csrc" / "maxpool.cu"
    with tempfile.TemporaryDirectory() as tmp:
        fns = {"this": _entry(_build.load_library("maxpool.cu")),
               "parent": _entry(_build.build_copy(src.read_text(),
                                                  Path(tmp) / "parent"))}
    gen = torch.Generator(device="cuda").manual_seed(seed)
    sums = {"this": 0.0, "parent": 0.0}
    ok = True
    for name, c, side, count in chip_smoke._MAXPOOL_POOLS:
        shape = (chip_smoke._MAXPOOL_BATCH, c, side, side)
        x = torch.randn(shape, generator=gen, device="cuda",
                        dtype=torch.bfloat16)
        dy = torch.randn(shape, generator=gen, device="cuda",
                         dtype=torch.bfloat16)
        y = F.max_pool2d(x, 3, 1, 1)
        out = {k: torch.empty_like(x) for k in fns}
        for k, fn in fns.items():
            _call(fn, x, y, dy, out[k])
        torch.cuda.synchronize()
        plain = torch.equal(out["this"],
                            mp.maxpool3x3s1_bwd_ref(x, y, dy))
        same = torch.equal(out["this"], out["parent"])
        ok &= plain and same
        times = {"this": [], "parent": []}
        for who in _ORDER:
            times[who].append(chip_smoke._time_ms(
                lambda: _call(fns[who], x, y, dy, out[who])))
        ms = {k: float(np.mean(v)) for k, v in times.items()}
        for k in sums:
            sums[k] += count * ms[k]
        print(f"[maxpool_ab] {name} shape={list(shape)} " + json.dumps({
            "this_ms": ms["this"], "parent_ms": ms["parent"],
            "this_over_parent": ms["this"] / ms["parent"],
            "turns": times, "bit_equal": same,
            "this_bit_equal_plain": plain, "pools": count}), flush=True)
        del x, dy, y, out
        torch.cuda.empty_cache()
    print("[maxpool_ab] nine pools " + json.dumps({
        "this_ms": sums["this"], "parent_ms": sums["parent"],
        "this_over_parent": sums["this"] / sums["parent"]}), flush=True)
    return ok


def knockouts(seed: int) -> bool:
    from concurrent.futures import ThreadPoolExecutor

    import torch.nn.functional as F
    from bigdl_tpu_torch.ops import _build
    text = (_build._CSRC / "maxpool.cu").read_text()
    copies = {}
    for name, edits, _ in _KNOCKOUTS:
        t = text
        for old, new in edits:
            if old not in t:
                raise SystemExit(f"knockout {name}: {old!r} is not in "
                                 f"maxpool.cu")
            t = t.replace(old, new)
        copies[name] = t
    with tempfile.TemporaryDirectory() as tmp, ThreadPoolExecutor(
            len(copies) + 1) as pool:
        kept = pool.submit(_build.load_library, "maxpool.cu")
        built = {k: pool.submit(_build.build_copy, t, Path(tmp) / k)
                 for k, t in copies.items()}
        fns = {"kept": _entry(kept.result()),
               **{k: _entry(f.result()) for k, f in built.items()}}
    gen = torch.Generator(device="cuda").manual_seed(seed)
    ok = True
    for shape, dtype in _KNOCKOUT_SHAPES:
        x = torch.randn(shape, generator=gen, device="cuda", dtype=dtype)
        dy = torch.randn(shape, generator=gen, device="cuda", dtype=dtype)
        y = F.max_pool2d(x, 3, 1, 1)
        out = {k: torch.empty_like(x) for k in fns}
        row = {}
        for name, _, same in _KNOCKOUTS:
            times = {"kept": [], name: []}
            for who in ("kept", name, name, "kept"):
                times[who].append(chip_smoke._time_ms(
                    lambda: _call(fns[who], x, y, dy, out[who])))
            if same:
                _call(fns[name], x, y, dy, out[name])
                _call(fns["kept"], x, y, dy, out["kept"])
                torch.cuda.synchronize()
                ok &= torch.equal(out[name], out["kept"])
            row[name] = dict(ms=float(np.mean(times[name])),
                             kept_ms=float(np.mean(times["kept"])),
                             ratio=float(np.mean(times[name])
                                         / np.mean(times["kept"])),
                             **({"bit_equal": torch.equal(
                                 out[name], out["kept"])} if same else {}))
        print(f"[maxpool_ab] knockout shape={list(shape)} "
              f"{str(dtype)[6:]} " + json.dumps(row), flush=True)
        del x, dy, y, out
        torch.cuda.empty_cache()
    return ok


def _route_in_block_pools():
    """Route every SpatialMaxPooling(3, 3, 1, 1, 1, 1) of this process to
    ``ops.maxpool.maxpool3x3s1``; the set of the modules routed."""
    from bigdl_tpu_torch.nn import pooling
    from bigdl_tpu_torch.ops import maxpool as mp
    library = pooling.SpatialMaxPooling._pool
    routed = set()

    def _pool(self, x):
        if (self.kh, self.kw, self.dh, self.dw, self.ph,
                self.pw) == _IN_BLOCK:
            routed.add(id(self))
            return mp.maxpool3x3s1(x)
        return library(self, x)
    pooling.SpatialMaxPooling._pool = _pool
    return routed


def child(route: str, warm_up: int, iterations: int) -> int:
    """One Inception-v1 harness run in this process; one JSON line."""
    from bigdl_tpu_torch.models.utils import perf
    from bigdl_tpu_torch.ops import maxpool as mp
    routed = _route_in_block_pools() if route == "kernel" else set()
    c = chip_smoke._INCEPTION
    mp.bwd_launches = 0
    out = perf.main(["-m", "inception_v1", "-b", str(c["batch"]),
                     "--warmUp", str(warm_up), "-i", str(iterations),
                     "--classNum", str(c["classes"]), "--device", "cuda"])
    print("[maxpool_ab] " + json.dumps({
        "route": route, "routed_modules": len(routed),
        "launches": mp.bwd_launches, "steps": warm_up + iterations,
        **{k: out[k] for k in ("ms_per_step", "records_per_s",
                               "peak_bytes", "first_loss",
                               "final_loss")}}), flush=True)
    return 0


def ab_step(warm_up: int, iterations: int) -> bool:
    runs = {"library": [], "kernel": []}
    for route in _STEP_ORDER:
        done = subprocess.run(
            [sys.executable, __file__, "--child", route, "--warmUp",
             str(warm_up), "-i", str(iterations)], cwd=ROOT,
            capture_output=True, text=True, timeout=900)
        line = [x for x in done.stdout.splitlines()
                if x.startswith("[maxpool_ab] {")]
        if done.returncode or not line:
            print(f"[maxpool_ab] step {route} failed (rc "
                  f"{done.returncode}): " + done.stderr[-2000:],
                  flush=True)
            return False
        got = json.loads(line[-1][len("[maxpool_ab] "):])
        print(f"[maxpool_ab] step {route} " + json.dumps(got), flush=True)
        pools = 9 if route == "kernel" else 0
        if (got["routed_modules"], got["launches"]) != (
                pools, pools * got["steps"]):
            print(f"[maxpool_ab] step {route}: {got['routed_modules']} "
                  f"modules routed, {got['launches']} launches; expected "
                  f"{pools} and {pools * got['steps']}", flush=True)
            return False
        runs[route].append(got)
    mean = {k: {m: float(np.mean([r[m] for r in v]))
                for m in ("ms_per_step", "records_per_s")}
            for k, v in runs.items()}
    print("[maxpool_ab] step means " + json.dumps({
        **mean, "kernel_over_library_ms": mean["kernel"]["ms_per_step"]
        / mean["library"]["ms_per_step"]}), flush=True)
    return True


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", help="the root of the other checkout")
    ap.add_argument("--only", choices=("kernels", "step", "knockout"))
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--warmUp", type=int, default=2)
    ap.add_argument("-i", "--iteration", type=int, default=8)
    ap.add_argument("--child", choices=("library", "kernel"),
                    help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("maxpool_ab: CUDA is not available; this script needs the "
              "card", file=sys.stderr)
        return 2
    if args.child:
        return child(args.child, args.warmUp, args.iteration)
    ok = True
    if args.only == "knockout":
        ok &= knockouts(args.seed)
        print(chip_smoke._card())
        return 0 if ok else 1
    if args.only != "step":
        if not args.parent:
            ap.error("--parent is needed for the kernel turns")
        ok &= ab_kernels(Path(args.parent).resolve(), args.seed)
    if args.only != "kernels":
        ok &= ab_step(args.warmUp, args.iteration)
    print(chip_smoke._card())
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())

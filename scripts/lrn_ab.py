#!/usr/bin/env python3
"""Check the LRN kernels, time them against another version's in turns,
knock parts out of the staged backward, and time the Inception-v1 step
of two checkouts.

(a) ``check``: builds this checkout's ``csrc/lrn.cu`` (the compiler's
register/spill report for the LRN kernels, as ``chip_smoke.py`` prints
it) and holds the forward and the backward at every
``chip_smoke._LRN_CASES`` row, in bf16 and f32, against their plain
versions within ``chip_smoke._LRN_TOL`` (the backward on the route
``ops.lrn.bwd_route`` names). Untimed: the quick check of a new build.

(b) ``kernels``: builds this checkout's ``lrn.cu`` and the one of the
checkout whose root is ``--parent`` (such as a ``git archive`` of the
parent commit unpacked under the git-ignored ``build/``) and, at every
timed ``_LRN_CASES`` row in bf16 and f32, times each version's forward
and backward C entries in turns (parent, this, this, parent; CUDA
events, L2 flushed, the median of 20, ``chip_smoke._time_ms``). Prints
per row each version's ms (the mean of its two turns), this / parent,
the largest |this - parent| of dx, and whether the two forwards are
bit-equal (they must be: the forward kernels are the same code).

(c) ``knockout`` (only when named): builds copies of this checkout's
``lrn.cu`` with one part knocked out or one setting changed
(``_KNOCKOUTS``: exact text replacements, which an edit of those lines
must update) and times each backward against the kept kernel in turns
(kept, copy, copy, kept) at ``_KNOCKOUT_CASES``; prints each copy's ms
over the kept kernel's. ``no_loads`` stages nothing (the walk computes
on whatever the stages hold), ``no_math`` writes dx = g from
the staged g rows with no ring or window (register windows only; the
runtime window's walk is kept in that copy): together they show
whether bytes or issue set the pace. A copy that changes a setting
(stages, channels a chunk, bytes a row; past window 9 the bytes a CTA
shrinks its run to and the channels a stage) changes no arithmetic and
is held bit for bit against the kept kernel.

(c') ``walk`` (only when named): the same for the tiled walk past
window 9 (``_WALK_KNOCKOUTS``): its forward at windows 11, 16 and 288
and its "any" backward at 288, each copy against the kept kernel in
turns; ``any_past_9`` times the tiled backward at windows 11 and 16
against the staged slots form.

(c'') ``build`` (with ``--parent``): nvcc's wall time for both versions'
``lrn.cu`` in turns. ``sass``: the tiled walk's kernels' instruction
counts, by opcode, from ``cuobjdump --dump-sass``.

(d) ``step``: ``perf -m inception_v1 -b 256`` (``chip_smoke._INCEPTION``)
of the ``--parent`` checkout and of this one in turns (parent, this,
this, parent), each in a process of its own started from that
checkout's root; prints each run's ms a step and images/s, then the
ratio of the means.

Last it prints the card's name and power limit. It exits 1 if a check
fails, the forwards differ or a run fails.

    python3 scripts/lrn_ab.py --only check
    python3 scripts/lrn_ab.py --parent DIR [--only kernels|step]
    python3 scripts/lrn_ab.py --only knockout|walk
    python3 scripts/lrn_ab.py --parent DIR --only build
    python3 scripts/lrn_ab.py --only sass
"""
from __future__ import annotations

import argparse
import ctypes
import json
import math
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
_CODES = {torch.float32: 0, torch.bfloat16: 1}
_TAIL = ([ctypes.c_int] * 4 + [ctypes.c_float] * 3
         + [ctypes.c_int, ctypes.c_void_p])

#: the register walk of a chunk, and its dx store (no_store keeps the
#: store's condition on the computed value, so the walk is not dropped)
_WALKS = ("      if (kc * CC < SIZE - 1 || (kc + 1) * CC > a.C)\n"
          "        walk_regs<true, SIZE, ALIGNED, MODE>(R, U, Tt, dx, l, kc, "
          "a);\n      else\n"
          "        walk_regs<false, SIZE, ALIGNED, MODE>(R, U, Tt, dx, l, kc, "
          "a);\n")
_STORE = ("      if (l.active)\n"
          "        write_row<T, VEC, ALIGNED>(dx + l.base + (int64_t)c * "
          "a.HW,\n"
          "                                   l.md + c * l.dm, l.col, l.len, "
          "o);\n    }\n  }\n}\n\n// VEC floats")

#: (name, [(text, replacement)], computes the same dx)
_KNOCKOUTS = (
    ("no_loads", [("        const int first = kc * CC - (t ? hi : 0);",
                   "        continue;  // no loads\n"
                   "        const int first = kc * CC - (t ? hi : 0);")],
     False),
    ("no_math", [("// the ring as a consumer sees it",
                  "template <int CC, bool ALIGNED, typename T>\n"
                  "__device__ __forceinline__ void copy_g(\n"
                  "    T* __restrict__ dx, const Lane& l, int kc,\n"
                  "    const Walk& a) {\n"
                  "  constexpr int VEC = 4 / sizeof(T);\n"
                  "#pragma unroll\n"
                  "  for (int q = 0; q < CC; ++q) {\n"
                  "    const int j = kc * CC + q - a.hi;\n"
                  "    if (j < 0 || j >= a.C) continue;\n"
                  "    float v[VEC];\n"
                  "    read_row<T, VEC, ALIGNED>(\n"
                  "        l.st + (CC + q) * a.row_bytes + l.toff,\n"
                  "        (l.mg + j * l.dm) & 15, v);\n"
                  "    if (l.active)\n"
                  "      write_row<T, VEC, ALIGNED>(\n"
                  "          dx + l.base + (int64_t)j * a.HW,\n"
                  "          l.md + j * l.dm, l.col, l.len, v);\n"
                  "  }\n"
                  "}\n\n"
                  "// the ring as a consumer sees it"),
                 (_WALKS, "      copy_g<CC, ALIGNED>(dx, l, kc, a);\n")],
     False),
    ("no_store", [(_STORE, _STORE.replace(
        "if (l.active)", "if (l.active && o[0] == 1234.5f)"))], False),
    ("stages_2", [("constexpr int kStages = 3;",
                   "constexpr int kStages = 2;")], True),
    ("stages_4", [("constexpr int kStages = 3;",
                   "constexpr int kStages = 4;")], True),
    ("chunk_4", [("constexpr int kChunk = 8;", "constexpr int kChunk = 4;")],
     True),
    ("chunk_16", [("constexpr int kChunk = 8;", "constexpr int kChunk = 16;")],
     True),
    ("rows_448", [("constexpr int kRowBytes = 896;",
                   "constexpr int kRowBytes = 448;")], True),
    ("rows_1792", [("constexpr int kRowBytes = 896;",
                    "constexpr int kRowBytes = 1792;")], True),
    ("any_cta_58k", [("constexpr int kAnyCtaBytes = 116224;",
                      "constexpr int kAnyCtaBytes = 58112;")], True),
    ("slot_chunk_8", [("constexpr int kSlotChunk = 4;",
                       "constexpr int kSlotChunk = 8;")], True),
)
#: (_LRN_CASES row, dtype) the knockouts are timed at
_KNOCKOUT_CASES = (("norm2", torch.bfloat16), ("norm1", torch.bfloat16),
                   ("norm2", torch.float32), ("size11", torch.bfloat16),
                   ("size16", torch.bfloat16),
                   ("alexnet_norm2", torch.bfloat16))

#: the tiled walk past window 9: (_LRN_CASES row, dtype, kernel) its
#: knockouts are timed at: the forward at windows 11, 16 and 288, the
#: "any" backward at 288
#: the forward's rows, for the copies that change only the forward
_WALK_FWD_ROWS = (("size11", torch.bfloat16, "fwd"),
                  ("size16", torch.bfloat16, "fwd"),
                  ("past_cap", torch.bfloat16, "fwd"),
                  ("size11", torch.float32, "fwd"),
                  ("size16", torch.float32, "fwd"))
_WALK_ROWS = (("size11", torch.bfloat16, "fwd"),
              ("size16", torch.bfloat16, "fwd"),
              ("past_cap", torch.bfloat16, "fwd"),
              ("past_cap", torch.bfloat16, "bwd"),
              ("past_cap", torch.float32, "fwd"),
              ("past_cap", torch.float32, "bwd"))


def _setting(name, value):
    line = next(ln for ln in (_build_src().splitlines())
                if ln.startswith(f"constexpr int {name} = "))
    return line, line.replace(line.split("=")[1].split(";")[0], f" {value}",
                              1)


def _build_src():
    from bigdl_tpu_torch.ops import _build
    return (_build._CSRC / "lrn.cu").read_text()


#: the walk's copies: (name, [(text, replacement)], computes the same
#: outputs, rows). walk_no_loads stages nothing (the walk sums whatever
#: the chunks hold: bytes against issue); M 4 (with one warp a run: 16
#: groups of two warps would pass the launch bound) and 16 (at windows
#: of 16 and more only: the unrolled ramps need M no wider than the
#: window); CT halved (the
#: backward's widest tile too) and doubled (one warp a run, as M 4); P
#: halved (one warp a run where it was two); walk_one_buffer stages one
#: tile a CTA (no persistent CTAs), walk_bounds_1 drops the launch
#: bound's two CTAs an SM (ptxas then gave the bf16 forward 87
#: registers), walk_small_ctas halves CT and P
#: together; walk_no_store and
#: walk_no_pow leave out the forward's stores and its powers (pace
#: knockouts, outputs wrong by design). any_past_9 sends every
#: backward past window 9 to "any" (the one-launch tiled backward), timed
#: against the staged slots form at windows 11 and 16: a lead only, its
#: outputs differ in the last bits
_WALK_KNOCKOUTS = (
    ("walk_no_loads",
     [("    if (lane < kWalkChunk && ch <= x1) {",
       "    if (false && lane < kWalkChunk && ch <= x1) {")], False,
     _WALK_ROWS),
    ("walk_one_buffer", [("<= kWalkCtaBytes ? 2 : 1;",
                          "<= kWalkCtaBytes ? 1 : 1;")], True,
     _WALK_FWD_ROWS),
    ("walk_bounds_1", [("__launch_bounds__(kWalkThreads, 2)\n"
                        "    lrn_tiled_kernel(",
                        "__launch_bounds__(kWalkThreads)\n"
                        "    lrn_tiled_kernel(")], True, _WALK_FWD_ROWS),
    ("walk_small_ctas", [_setting("kWalkTile", 32),
                         _setting("kWalkWarps", 1)], True, _WALK_FWD_ROWS),
    ("walk_m_4", [_setting("kWalkM", 4), _setting("kWalkWarps", 1)], True,
     _WALK_ROWS),
    ("walk_m_16", [_setting("kWalkM", 16),
                   ("static_assert(kWalkM <= kMaxSize + 1,", "static_assert("
                    "true,")], True,
     tuple(r for r in _WALK_ROWS if r[0] != "size11")),
    ("walk_ct_half", [_setting("kWalkTile", 32),
                      ("for (int ct = groups * M; ct >= M; ct -= M) {",
                       "for (int ct = (groups + 1) / 2 * M; ct >= M; "
                       "ct -= M) {")], True, _WALK_ROWS),
    ("walk_ct_double", [_setting("kWalkTile", 128),
                        _setting("kWalkWarps", 1)], True, _WALK_ROWS),
    ("walk_p_half", [_setting("kWalkWarps", 1)], True, _WALK_ROWS),
    ("walk_no_store",
     [("        write_row<T, VEC, ALIGNED>(out + at, md + c * dmo, col, "
       "pl.len, o);\n      } else if constexpr (KIND == kKindT) {",
       "        if (o[0] == 1234.5f)\n"
       "        write_row<T, VEC, ALIGNED>(out + at, md + c * dmo, col, "
       "pl.len, o);\n      } else if constexpr (KIND == kKindT) {")], False,
     _WALK_ROWS[:3]),
    ("walk_no_pow",
     [("          o[u] = r[u] * pow_neg_beta_at<MODE>(fmaf(a.coef, acc[m][u], "
       "a.k),\n                                              a.mode, a.beta);",
       "          o[u] = r[u] * fmaf(a.coef, acc[m][u], a.k);")], False,
     _WALK_ROWS[:3]),
    ("any_past_9",
     [("  return (size < C ? size : C) <= kAnyMaxSlots ? kRouteStaged : "
       "kRouteAny;", "  return kRouteAny;")], False,
     (("size11", torch.bfloat16, "bwd"), ("size16", torch.bfloat16, "bwd"),
      ("size11", torch.float32, "bwd"), ("size16", torch.float32, "bwd"))),
)


def _entries(lib):
    """The forward and backward C entries of a built ``lrn.cu``. The
    backward is bound with this checkout's last argument, the route it
    reports; an older entry without it ignores it."""
    fwd, bwd = lib.bigdl_lrn_fwd, lib.bigdl_lrn_bwd
    fwd.restype = bwd.restype = ctypes.c_int
    fwd.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 2 + _TAIL
    bwd.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 4 + _TAIL
                    + [ctypes.c_void_p])
    return fwd, bwd


def _args(x, a):
    n, c, h, w = x.shape
    return (n, c, h * w, a["size"], float(a["alpha"]), float(a["beta"]),
            float(a["k"]), int(a["relu"]),
            torch.cuda.current_stream().cuda_stream)


def _fwd(fn, x, y, a):
    err = fn(_CODES[x.dtype], x.data_ptr(), y.data_ptr(), *_args(x, a))
    if err:
        raise RuntimeError(f"lrn forward launch failed (code {err})")


def _bwd(fn, g, x, dx, tbuf, a):
    err = fn(_CODES[x.dtype], g.data_ptr(), x.data_ptr(), dx.data_ptr(),
             None if tbuf is None else tbuf.data_ptr(), *_args(x, a), None)
    if err:
        raise RuntimeError(f"lrn backward launch failed (code {err})")


def _cases(timed_only):
    for case, shape, a in chip_smoke._LRN_CASES:
        if timed_only and case in chip_smoke._LRN_UNTIMED:
            continue
        for dtype in (torch.bfloat16, torch.float32):
            yield case, shape, a, dtype


def check(seed: int) -> bool:
    from bigdl_tpu_torch.ops import _build
    from bigdl_tpu_torch.ops import lrn
    lib = _build.load_library("lrn.cu")
    chip_smoke._print_ptxas(
        Path(lib._name).with_suffix(".ptxas.txt").read_text())
    gen = torch.Generator().manual_seed(seed)
    ok = True
    for case, shape, a, dtype in _cases(False):
        x, g = chip_smoke._lrn_inputs(case, shape, dtype, gen)
        args = (a["size"], a["alpha"], a["beta"], a["k"], a["relu"])
        tol = chip_smoke._LRN_TOL[dtype]
        y = lrn.lrn_fwd(x, *args)
        dx = lrn.lrn_bwd(g, x, *args)
        torch.cuda.synchronize()
        worst = {"fwd": chip_smoke._worst(y, lrn.lrn_ref(x, *args), *tol),
                 "bwd": chip_smoke._worst(dx, lrn.lrn_bwd_ref(g, x, *args),
                                          *tol)}
        good = all(w[1] <= 1 for w in worst.values())
        ok &= good
        print(f"[lrn_ab] check {case} {str(dtype)[6:]} shape={list(shape)} "
              f"route={lrn.bwd_route(dtype, shape, a['size'])} "
              f"(max abs err, worst / limit) " + json.dumps(worst)
              + ("" if good else " FAILED"), flush=True)
        del x, g, y, dx
        torch.cuda.empty_cache()
    return ok


def kernels(parent: Path, seed: int) -> bool:
    from bigdl_tpu_torch.ops import _build
    src = parent / "bigdl_tpu_torch" / "csrc" / "lrn.cu"
    with tempfile.TemporaryDirectory() as tmp:
        fns = {"this": _entries(_build.load_library("lrn.cu")),
               "parent": _entries(_build.build_copy(src.read_text(),
                                                    Path(tmp) / "parent"))}
    gen = torch.Generator().manual_seed(seed)
    ok = True
    for case, shape, a, dtype in _cases(True):
        x, g = chip_smoke._lrn_inputs(case, shape, dtype, gen)
        # the parent's "any" backward takes an f32 scratch as large as x,
        # this one's two-launch form one twice as large; allocated once,
        # outside the turns (a version that needs none ignores it)
        tbuf = (torch.empty(2 * x.numel(), dtype=torch.float32,
                            device="cuda") if a["size"] > 9 else None)
        y = {k: torch.empty_like(x) for k in fns}
        dx = {k: torch.empty_like(x) for k in fns}
        for k, (fwd, bwd) in fns.items():
            _fwd(fwd, x, y[k], a)
            _bwd(bwd, g, x, dx[k], tbuf, a)
        torch.cuda.synchronize()
        same_fwd = torch.equal(y["this"], y["parent"])
        ok &= same_fwd
        diff = float((dx["this"].float() - dx["parent"].float()).abs().max())
        row = {"fwd_bit_equal": same_fwd, "bwd_max_abs_diff": diff}
        for what in ("fwd", "bwd"):
            times = {"this": [], "parent": []}
            for who in _ORDER:
                fwd, bwd = fns[who]
                run = ((lambda: _fwd(fwd, x, y[who], a)) if what == "fwd"
                       else (lambda: _bwd(bwd, g, x, dx[who], tbuf, a)))
                times[who].append(chip_smoke._time_ms(run))
            ms = {k: float(np.mean(v)) for k, v in times.items()}
            row[what] = {"this_ms": ms["this"], "parent_ms": ms["parent"],
                         "this_over_parent": ms["this"] / ms["parent"],
                         "turns": times}
        print(f"[lrn_ab] {case} {str(dtype)[6:]} shape={list(shape)} "
              + json.dumps(row), flush=True)
        del x, g, tbuf, y, dx
        torch.cuda.empty_cache()
    return ok


def knockouts(seed: int, walk: bool) -> bool:
    from concurrent.futures import ThreadPoolExecutor

    from bigdl_tpu_torch.ops import _build
    text = _build_src()
    table = (_WALK_KNOCKOUTS if walk else tuple(
        (name, edits, same, tuple((c, d, "bwd") for c, d in
                                  _KNOCKOUT_CASES))
        for name, edits, same in _KNOCKOUTS))
    copies = {}
    for name, edits, _, _ in table:
        t = text
        for old, new in edits:
            if old not in t:
                raise SystemExit(f"knockout {name}: {old!r} is not in "
                                 f"lrn.cu")
            t = t.replace(old, new)
        copies[name] = t
    marks = (("lrn_tiled_kernel", "lrn_bwd_tiled_kernel") if walk
             else ("lrn_bwd_staged",))
    with tempfile.TemporaryDirectory() as tmp, ThreadPoolExecutor(
            len(copies) + 1) as pool:
        kept = pool.submit(_build.load_library, "lrn.cu")
        built = {k: pool.submit(_build.build_copy, t, Path(tmp) / k)
                 for k, t in copies.items()}
        fns = {"kept": _entries(kept.result()),
               **{k: _entries(f.result()) for k, f in built.items()}}
        for k in copies:
            # each marked kernel's entry line and the register line after
            regs, name = [], None
            for ln in (Path(tmp) / k).with_suffix(
                    ".ptxas.txt").read_text().splitlines():
                if "Compiling entry" in ln:
                    name = next((ln.split("'")[1].split(m, 1)[1][:40]
                                 for m in marks if m in ln), None)
                elif name and "registers" in ln:
                    regs.append(name + " " + ln.split(":", 1)[-1].strip())
                    name = None
            print(f"[lrn_ab] knockout {k} build: " + " | ".join(regs),
                  flush=True)
    cases = {c: (shape, a) for c, shape, a in chip_smoke._LRN_CASES}
    rows = sorted({r for *_, where in table for r in where},
                  key=lambda r: [w for *_, where in table
                                 for w in where].index(r))
    gen = torch.Generator().manual_seed(seed)
    ok = True
    for case, dtype, what in rows:
        shape, a = cases[case]
        x, g = chip_smoke._lrn_inputs(case, shape, dtype, gen)
        scratch = torch.empty(2 * x.numel(), dtype=torch.float32,
                              device="cuda")
        out = {k: torch.empty_like(x) for k in fns}

        def run(who):
            fwd, bwd = fns[who]
            if what == "fwd":
                _fwd(fwd, x, out[who], a)
            else:
                _bwd(bwd, g, x, out[who], scratch, a)
        row = {}
        for name, _, same, where in table:
            if (case, dtype, what) not in where:
                continue
            times = {"kept": [], name: []}
            for who in ("kept", name, name, "kept"):
                times[who].append(chip_smoke._time_ms(lambda: run(who)))
            entry = dict(ms=float(np.mean(times[name])),
                         kept_ms=float(np.mean(times["kept"])))
            entry["ratio"] = entry["ms"] / entry["kept_ms"]
            run(name)
            run("kept")
            torch.cuda.synchronize()
            if same:
                entry["bit_equal"] = torch.equal(out[name], out["kept"])
                ok &= entry["bit_equal"]
            else:
                entry["max_abs_diff"] = float(
                    (out[name].float() - out["kept"].float()).abs().max())
            row[name] = entry
        print(f"[lrn_ab] knockout {what} {case} {str(dtype)[6:]} "
              f"shape={list(shape)} " + json.dumps(row), flush=True)
        del x, g, out, scratch
        torch.cuda.empty_cache()
    return ok


def builds(parent: Path) -> bool:
    """nvcc's wall time for the parent's lrn.cu and this one's, each
    built afresh into a temporary directory, in turns (parent, this, this,
    parent), one at a time."""
    import time

    from bigdl_tpu_torch.ops import _build
    texts = {"this": _build_src(), "parent": (
        parent / "bigdl_tpu_torch" / "csrc" / "lrn.cu").read_text()}
    secs = {"this": [], "parent": []}
    with tempfile.TemporaryDirectory() as tmp:
        for i, who in enumerate(_ORDER):
            t0 = time.perf_counter()
            _build.build_copy(texts[who], Path(tmp) / f"{who}{i}")
            secs[who].append(time.perf_counter() - t0)
    print("[lrn_ab] build lrn.cu s " + json.dumps(
        {k: {"turns": v, "mean": float(np.mean(v))} for k, v in
         secs.items()}), flush=True)
    return True


def sass() -> bool:
    """The SASS of this checkout's tiled walk kernels (``cuobjdump
    --dump-sass`` beside nvcc): each kernel's instruction count and its
    counts of the opcodes that pace it."""
    import collections
    import re

    from bigdl_tpu_torch.ops import _build
    lib = _build.load_library("lrn.cu")._name
    tool = Path(_build.find_nvcc()).parent / "cuobjdump"
    text = subprocess.run([str(tool), "--dump-sass", lib], check=True,
                          capture_output=True, text=True).stdout
    name, ops = None, collections.Counter()

    def flush():
        if name and "tiled_kernel" in name:
            keys = ("FFMA", "FADD", "FMUL", "LDS", "LDG", "STG", "MUFU",
                    "FSEL", "FSETP", "ISETP", "BRA", "SYNCS", "IMAD",
                    "LOP3", "SHF")
            print(f"[lrn_ab] sass {name} " + json.dumps(
                {"instructions": sum(ops.values()),
                 **{k: ops[k] for k in keys}}), flush=True)
    for line in text.splitlines():
        if "Function :" in line:
            flush()
            name, ops = line.split("Function :")[1].strip(), \
                collections.Counter()
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?"
                     r"([A-Z][A-Z0-9]*)", line)
        if m:
            ops[m.group(1)] += 1
    flush()
    return True


#: the child: the harness's main from the checkout it starts in
_RUN = ("import json, sys\n"
        "sys.path.insert(0, '.')\n"
        "from bigdl_tpu_torch.models.utils import perf\n"
        "out = perf.main(sys.argv[1:])\n"
        "print('[lrn_ab] ' + json.dumps({k: out[k] for k in ("
        "'ms_per_step', 'records_per_s', 'peak_bytes', 'first_loss', "
        "'final_loss')}), flush=True)\n")


def step(parent: Path, warm_up: int, iterations: int) -> bool:
    c = chip_smoke._INCEPTION
    harness = ["-m", "inception_v1", "-b", str(c["batch"]), "--warmUp",
               str(warm_up), "-i", str(iterations), "--classNum",
               str(c["classes"]), "--device", "cuda"]
    roots = {"this": ROOT, "parent": parent}
    runs = {"this": [], "parent": []}
    for who in _ORDER:
        done = subprocess.run([sys.executable, "-c", _RUN, *harness],
                              cwd=roots[who], capture_output=True,
                              text=True, timeout=900)
        line = [x for x in done.stdout.splitlines()
                if x.startswith("[lrn_ab] {")]
        if done.returncode or not line:
            print(f"[lrn_ab] step {who} failed (rc {done.returncode}): "
                  + done.stderr[-2000:], flush=True)
            return False
        got = json.loads(line[-1][len("[lrn_ab] "):])
        runs[who].append(got)
        print(f"[lrn_ab] step {who} " + json.dumps(got), flush=True)
        if not all(math.isfinite(got[k]) for k in ("first_loss",
                                                   "final_loss")):
            return False
    ms = {who: float(np.mean([r["ms_per_step"] for r in rs]))
          for who, rs in runs.items()}
    print("[lrn_ab] step inception_v1 " + json.dumps(harness) + " "
          + json.dumps({"this_ms": ms["this"], "parent_ms": ms["parent"],
                        "this_over_parent": ms["this"] / ms["parent"]}),
          flush=True)
    return True


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", help="the root of the other checkout")
    ap.add_argument("--only", choices=("check", "kernels", "step",
                                       "knockout", "walk", "build",
                                       "sass"))
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--warmUp", type=int, default=2)
    ap.add_argument("-i", "--iteration", type=int, default=8)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("lrn_ab: CUDA is not available; this script needs the card",
              file=sys.stderr)
        return 2
    ok = True
    if args.only == "check":
        ok &= check(args.seed)
    elif args.only == "sass":
        ok &= sass()
    elif args.only in ("knockout", "walk"):
        ok &= knockouts(args.seed, args.only == "walk")
    elif args.only == "build" and not args.parent:
        ap.error("--only build times this and the --parent build")
    elif args.only == "build":
        ok &= builds(Path(args.parent).resolve())
    else:
        if not args.parent:
            ap.error("--parent is needed for the kernel and step turns")
        parent = Path(args.parent).resolve()
        if args.only != "step":
            ok &= kernels(parent, args.seed)
        if args.only != "kernels":
            ok &= step(parent, args.warmUp, args.iteration)
    print(chip_smoke._card())
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())

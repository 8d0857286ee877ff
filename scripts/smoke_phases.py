#!/usr/bin/env python3
"""Run a checkout's ``chip_smoke.py`` with its phases timed on the host
clock, to compare the smoke's wall time of two checkouts on one card.

Imports ``chip_smoke`` from ROOT (this checkout when no ROOT is given,
else a directory holding another checkout, such as a ``git archive`` of
the parent unpacked under the git-ignored ``build/``), wraps each of its
phase functions and the helpers that hold most of their time in a
``time.perf_counter`` timer, runs its ``main()`` with no arguments, as
the smoke is run, and prints after its output one line::

    [phases] {"<function>": seconds, ...} total <seconds> rc <exit code>

A function called more than once (``_serve_tail``, one call a tail) is
keyed by its tail's label and its calls summed. Host seconds of one run,
builds included; only a comparison of two checkouts run one after the
other in one call on one card says anything. It exits with the smoke's
own code.

    python3 scripts/smoke_phases.py [ROOT]
"""
from __future__ import annotations

import functools
import json
import os
import sys
import time
from pathlib import Path

#: chip_smoke's helpers timed beside its ``phase_*`` functions
_HELPERS = ("_check_tensor_cores", "_print_ptxas", "_pool_geometries",
            "_decode_geometries", "_prefill_buckets", "_prefill_geometries",
            "_prefill_nan_pool", "_split_breakdown", "_serve_tail",
            "_profile_decode", "_warm_card")


def _timed(module, name, times):
    fn = getattr(module, name)

    @functools.wraps(fn)
    def run(*args, **kwargs):
        t0 = time.perf_counter()
        try:
            return fn(*args, **kwargs)
        finally:
            key = f"{name}[{args[3]}]" if name == "_serve_tail" else name
            times[key] = times.get(key, 0.0) + time.perf_counter() - t0

    setattr(module, name, run)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    root = Path(argv[0] if argv else Path(__file__).resolve().parents[1])
    root = root.resolve()
    os.chdir(root)
    sys.path.insert(0, str(root))
    import chip_smoke as cs

    times = {}
    for name in dir(cs):
        if ((name.startswith("phase_") or name in _HELPERS)
                and callable(getattr(cs, name))):
            _timed(cs, name, times)
    sys.argv = [sys.argv[0]]
    t0 = time.perf_counter()
    rc = cs.main()
    print("[phases] " + json.dumps(times), "total",
          time.perf_counter() - t0, "rc", rc, flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())

"""Build a kernel source under ``csrc/`` into a plain-C shared library at
first use, and load it with ctypes.

``nvcc -gencode arch=compute_90a,code=sm_90a`` compiles one ``.cu`` file
(no PyTorch headers, so a build takes seconds), with ``csrc/`` on the
include path for the shared ``*.cuh`` headers, into
``<checkout>/build/bigdl_tpu_torch/``, a directory ``.gitignore`` lists.
The library's file name carries a hash of the source, the headers, the
flags and the nvcc path, so an edited source or header builds anew and
an unchanged one is loaded as it is. ``nvcc`` and the CUDA headers are
the only requirements. Nothing here runs at import time.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

__all__ = ["build_copy", "build_dir", "find_nvcc", "inline_header",
           "load_library"]

_PKG = Path(__file__).resolve().parents[1]
_CSRC = _PKG / "csrc"
#: Hopper only: the `a` keeps wgmma/setmaxnreg available to later kernels
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
FLAGS = ("-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
         "-Xptxas=-v")

_loaded: dict[str, ctypes.CDLL] = {}


def build_dir() -> Path:
    return _PKG.parent / "build" / "bigdl_tpu_torch"


def find_nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME") and
                 os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"),
                 shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on "
                       "PATH): the CUDA kernels build from source at "
                       "first use")


def _nvcc(cu, lib) -> str:
    """Compile ``cu`` into the shared library ``lib``; the compiler's
    register/spill report."""
    proc = subprocess.run([find_nvcc(), *ARCH_FLAGS, *FLAGS, "-I",
                           str(_CSRC), "-o", str(lib), str(cu)],
                          capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed on {cu}:\n{proc.stderr}")
    return proc.stderr


def build_copy(text: str, out: Path) -> ctypes.CDLL:
    """Build ``text``, an edited copy of a ``csrc/`` source, as
    ``out.cu`` into ``out.so`` and load it (for the scripts that plant
    faults or knock parts out of a kernel; ``out`` lies outside the
    checkout, and the copy includes the checkout's headers). The
    compiler's register/spill report is kept as ``out.ptxas.txt``."""
    cu, lib = out.with_suffix(".cu"), out.with_suffix(".so")
    cu.write_text(text)
    out.with_suffix(".ptxas.txt").write_text(_nvcc(cu, lib))
    return ctypes.CDLL(str(lib))


def inline_header(text: str, header: str) -> str:
    """``text``, a ``csrc/`` source, with its ``#include "<header>"``
    line replaced by that header's text, less its ``#pragma once`` and
    its includes of headers ``text`` includes before it: the form in
    which the fault and knockout scripts edit code that lives in a
    shared header (their copies build against the checkout's headers,
    which they cannot edit)."""
    line = next(ln for ln in text.splitlines()
                if ln.startswith(f'#include "{header}"'))
    before = text[:text.index(line)]
    body = [ln for ln in (_CSRC / header).read_text().splitlines()
            if ln != "#pragma once" and not (
                ln.startswith('#include "') and ln.split('"')[1] in before)]
    return text.replace(line, "\n".join(body), 1)


def load_library(source: str) -> ctypes.CDLL:
    """The ctypes handle of ``csrc/<source>``, built if needed. The
    compiler's register/spill report is kept beside the library as
    ``<name>.ptxas.txt``."""
    if source in _loaded:
        return _loaded[source]
    src = _CSRC / source
    nvcc = find_nvcc()
    headers = b"".join(h.read_bytes() for h in sorted(_CSRC.glob("*.cuh")))
    key = hashlib.sha256(src.read_bytes() + headers
                         + " ".join(ARCH_FLAGS + FLAGS + (nvcc,)).encode()
                         ).hexdigest()[:16]
    out_dir = build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    lib = out_dir / f"{src.stem}-{key}.so"
    if not lib.exists():
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
        os.close(fd)
        try:
            report = _nvcc(src, tmp)
            lib.with_suffix(".ptxas.txt").write_text(report)
            os.replace(tmp, lib)       # atomic: concurrent builders agree
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
    handle = ctypes.CDLL(str(lib))
    _loaded[source] = handle
    return handle

"""The port runs without JAX: importing it, down to the serving path,
loads neither ``jax`` nor any module of ``bigdl_tpu`` (checked in a fresh
interpreter, since this test process has both loaded)."""
import os
import subprocess
import sys

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_port_imports_neither_jax_nor_bigdl_tpu():
    code = ("import sys\n"
            "import bigdl_tpu_torch\n"
            "import bigdl_tpu_torch.models.transformer.serving\n"
            "import bigdl_tpu_torch.interop\n"
            "bad = sorted(m for m in sys.modules if m == 'jax'\n"
            "             or m.startswith(('jax.', 'jaxlib'))\n"
            "             or m == 'bigdl_tpu' or m.startswith('bigdl_tpu.'))\n"
            "print(bad)\n"
            "sys.exit(1 if bad else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=_REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr

"""The port runs without JAX: importing it, down to the serving and the
training paths, the throughput harness, Inception-v1 and the LRN and
max-pool kernels' wrappers, loads neither ``jax`` nor any
module of ``bigdl_tpu`` (checked in a fresh interpreter, since this test
process has both loaded)."""
import os
import subprocess
import sys

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_port_imports_neither_jax_nor_bigdl_tpu():
    code = ("import sys\n"
            "import bigdl_tpu_torch\n"
            "import bigdl_tpu_torch.models.transformer.serving\n"
            "import bigdl_tpu_torch.models.transformer.train\n"
            "import bigdl_tpu_torch.models.utils.text_lm\n"
            "import bigdl_tpu_torch.ops.flash_attention\n"
            "import bigdl_tpu_torch.ops.fused_ce\n"
            "import bigdl_tpu_torch.ops.lrn\n"
            "import bigdl_tpu_torch.ops.maxpool\n"
            "import bigdl_tpu_torch.nn.conv\n"
            "import bigdl_tpu_torch.nn.pooling\n"
            "import bigdl_tpu_torch.nn.dropout\n"
            "import bigdl_tpu_torch.nn.structural\n"
            "import bigdl_tpu_torch.models.inception\n"
            "import bigdl_tpu_torch.models.utils.perf\n"
            "import bigdl_tpu_torch.parallel.sequence\n"
            "import bigdl_tpu_torch.optim\n"
            "import bigdl_tpu_torch.optim.accumulation\n"
            "import bigdl_tpu_torch.optim.validation\n"
            "import bigdl_tpu_torch.dataset\n"
            "import bigdl_tpu_torch.dataset.text\n"
            "import bigdl_tpu_torch.utils.random\n"
            "import bigdl_tpu_torch.interop\n"
            "bad = sorted(m for m in sys.modules if m == 'jax'\n"
            "             or m.startswith(('jax.', 'jaxlib'))\n"
            "             or m == 'bigdl_tpu' or m.startswith('bigdl_tpu.'))\n"
            "print(bad)\n"
            "sys.exit(1 if bad else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=_REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr

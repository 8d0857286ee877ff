"""bigdl_tpu_torch — the PyTorch/CUDA port of ``bigdl_tpu``.

A second package beside the JAX one, for NVIDIA Hopper (H100). Module
paths mirror ``bigdl_tpu`` so each counterpart is easy to find; inside,
the code is plain PyTorch (``nn.Module``s, functions on tensors, an
explicit ``device=``, explicit ``torch.Generator``s). Every Pallas kernel
of the JAX package becomes a kernel written by hand for ``sm_90a``
(``csrc/``), built at first use from the package's own sources.

This package imports ``torch`` and numpy only: never ``jax`` and never
anything of ``bigdl_tpu``. Entry points run on ``device="cuda"`` unless
the caller passes another device.

Ported so far: the serving path of the transformer LM
(``models.transformer.serving.ContinuousBatcher``) with paged attention
as a CUDA kernel (``ops.paged_attention``); its training path
(``models.transformer.train`` through ``optim.Optimizer``) with flash
attention forward and backward as CUDA kernels (``ops.flash_attention``);
the throughput harness (``models.utils.perf``): the LM step with the
fused LM-head cross-entropy kernels (``ops.fused_ce``) and the
Inception-v1 step (``models.inception``) with the cross-map LRN kernels
(``ops.lrn``). ``ops.maxpool.maxpool3x3s1`` holds the 3x3 / stride-1
max-pool backward kernel, opt-in as in the JAX package. See ROADMAP.md
for the queue.
"""

__version__ = "0.1.0"

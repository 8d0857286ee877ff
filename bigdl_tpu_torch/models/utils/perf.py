"""Synthetic-data training throughput harness (counterpart of
``bigdl_tpu/models/utils/perf.py``): the same flags, defaults, models and
seeded data, plus ``--device`` (default ``cuda``; ``cpu`` runs the
kernels' plain versions).

    python -m bigdl_tpu_torch.models.utils.perf -m inception_v1 \\
        [-b 128] [--classNum 1000] [--dataType bf16|f32] [--device cuda]
    python -m bigdl_tpu_torch.models.utils.perf -m transformer \\
        [-b 8] [--seqLen 2048] [--dModel 512] [--numLayers 6] \\
        [--fusedHeadLoss auto|off] [--device cuda]
    python -m bigdl_tpu_torch.models.utils.perf -m attention [...]

``-m inception_v1`` times the train step of
``Inception_v1_NoAuxClassifier`` (ClassNLL, SGD(0.01, momentum 0.9),
weights from seed 0, (B, 3, 224, 224) standard-normal images and 1-based
labels from ``np.random.default_rng(0)``, the bf16 policy under
``--dataType bf16``, the default f32 one under ``f32``); its two LRN
layers run the hand-written LRN
kernels on the card, and its dropout draws from a generator seeded 0 on
the device. In place of XLA's cost analysis it reports the analytic step
FLOPs (counted by forward hooks on the first step) and the step's peak
device memory.
``-m transformer`` times the LM train step (SGD(0.01), learned positions
unless ``--posEncoding rope``, the bf16 policy under ``--dataType
bf16``, the default f32 one under ``f32``). With ``--fusedHeadLoss auto`` on the card it runs the body up to
the final LayerNorm and hands the hidden states and the LM head's weight
to ``ops.fused_ce.linear_cross_entropy``, so the (B·S, V) logits never
exist; on the CPU, or with ``off``, it runs ``CrossEntropyCriterion`` on
the model's logits. In place of XLA's cost analysis it reports the
analytic step FLOPs of ``bench.py`` and the step's peak device memory.
``-m attention`` times fwd+bwd of ``dot_product_attention`` with
``flash=True`` and ``flash=False``. Not ported yet, and refused:
``-m decode`` (ROADMAP.md queue A, Serving depth: ``generate``), and
the conv models but Inception-v1 (queue A, The conv zoo in the
harness).

``main`` returns what it measured (a dict) besides printing it.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

#: conv models not ported yet, and the ROADMAP.md queue A item that
#: brings them
MODELS = dict.fromkeys(
    ("inception_v2", "lenet5", "vgg16", "vgg19", "alexnet", "resnet50"),
    "The conv zoo in the harness")
#: ported conv models: constructor and image size
CONV_MODELS = {"inception_v1": ("Inception_v1_NoAuxClassifier", 224)}


def _attention_perf(args, device):
    """Long-context attention: the flash kernels vs the plain path,
    fwd+bwd per sequence."""
    from bigdl_tpu_torch.parallel.sequence import dot_product_attention

    b, s, h, d = args.batchSize, args.seqLen, args.heads, args.headDim
    dtype = torch.bfloat16 if args.dataType == "bf16" else torch.float32
    host = np.random.default_rng(0)
    q, k, v, ct = (torch.as_tensor(0.3 * host.standard_normal(
        (b, s, h, d)).astype(np.float32)).to(device, dtype)
        for _ in range(4))

    def grads(flash):
        qq, kk, vv = (x.detach().requires_grad_() for x in (q, k, v))
        o = dot_product_attention(qq, kk, vv, causal=True, flash=flash)
        return torch.autograd.grad((o.float() * ct.float()).sum(),
                                   (qq, kk, vv))

    def sync(g):
        return [float(x.float().sum()) for x in g]

    def bench(flash):
        try:
            g = grads(flash)
        except (ValueError, torch.OutOfMemoryError) as e:
            return None, type(e).__name__   # unsupported, or out of memory
        for _ in range(args.warmUp - 1):
            g = grads(flash)
        sync(g)
        t0 = time.perf_counter()
        for _ in range(args.iteration):
            g = grads(flash)
        sync(g)
        return (time.perf_counter() - t0) / args.iteration * 1e3, None

    # flash=True (not "auto") so an unsupported config prints FAILED
    # instead of timing the plain path under the flash label
    out = {}
    for name, flash in (("flash", True), ("plain", False)):
        ms, err = bench(flash)
        out[name] = ms
        if ms is None:
            print(f"attention[{name}] B{b} S{s} H{h} D{d}: FAILED ({err})")
        else:
            print(f"attention[{name}] B{b} S{s} H{h} D{d}: {ms:.2f} "
                  f"ms/iteration fwd+bwd ({b * s / ms:.0f} tokens/ms)")
    return out


def step_flops(model, vocab, d_model, layers, b, s):
    """Analytic FLOPs of one train step (``bench.py``'s count): 6 x the
    matmul parameters (2-D weights minus the token and position tables)
    x tokens, plus attention at the full S² matrices (``dense``) or the
    causal halves actually computed (``causal``)."""
    p2d = sum(p.numel() for p in model.parameters() if p.dim() == 2)
    p_matmul = p2d - vocab * d_model - s * d_model
    tokens = b * s
    dense_attn = 12 * layers * s * d_model * tokens
    return {"dense": 6 * p_matmul * tokens + dense_attn,
            "causal": 6 * p_matmul * tokens + dense_attn // 2}


def body_and_loss(model, fused: bool):
    """``(fwd, criterion)`` of the harness, ``loss = criterion(fwd(data),
    labels)``: with ``fused``, the body up to the final LayerNorm, then
    the fused LM head + CE on the (B·S, D) hidden states with the head's
    weight cast to their dtype (grads reach the f32 parameter through the
    cast); else the whole model and ``CrossEntropyCriterion`` on its
    logits."""
    from bigdl_tpu_torch import nn
    from bigdl_tpu_torch.ops.fused_ce import linear_cross_entropy

    if not fused:
        return model, nn.CrossEntropyCriterion()
    *body, head = model._modules.values()

    def body_fwd(x):
        for m in body:
            x = m(x)
        return x

    def head_and_loss(x, labels):
        return linear_cross_entropy(x.reshape(-1, x.shape[-1]),
                                    head.weight.to(x.dtype), head.bias,
                                    labels.reshape(-1))
    return body_fwd, head_and_loss


def make_step(model, sgd, fused: bool):
    """``step(opt_state, data, labels, epoch) -> (opt_state, loss)``: the
    harness loss (``body_and_loss``), autograd, ``sgd.update`` in
    place."""
    from bigdl_tpu_torch.optim.accumulation import make_train_step
    fwd, criterion = body_and_loss(model, fused)
    return make_train_step(fwd=fwd, criterion=criterion,
                           params=dict(model.named_parameters()),
                           update_fn=sgd.update)


def _transformer_perf(args, device):
    """LM train-step throughput (tokens/s)."""
    from bigdl_tpu_torch.models import TransformerLM
    from bigdl_tpu_torch.optim import SGD
    from bigdl_tpu_torch.tensor import DTypePolicy, set_policy

    # the policy the flag names, whatever an earlier run in this process
    # set (f32: the default policy)
    set_policy(DTypePolicy(param_dtype=torch.float32,
                           compute_dtype=torch.bfloat16,
                           activation_dtype=torch.bfloat16)
               if args.dataType == "bf16" else DTypePolicy())
    vocab, s, b = args.classNum, args.seqLen, args.batchSize
    model = TransformerLM(vocab, d_model=args.dModel,
                          num_heads=args.dModel // 128,
                          num_layers=args.numLayers, max_len=s,
                          with_log_softmax=False,
                          pos_encoding=args.posEncoding,
                          num_kv_heads=args.numKvHeads, device=device,
                          generator=torch.Generator().manual_seed(0))
    model.train()
    sgd = SGD(learning_rate=0.01)
    state = sgd.init_state(dict(model.named_parameters()))
    # fused on the card unless --fusedHeadLoss off; the CPU takes the
    # unfused path, as the JAX harness does off the TPU
    fused = args.fusedHeadLoss != "off" and device.type == "cuda"
    step = make_step(model, sgd, fused)

    host = np.random.default_rng(0)
    data = torch.as_tensor(host.integers(1, vocab + 1, size=(b, s)))
    labels = torch.as_tensor(host.integers(1, vocab + 1, size=(b, s)))
    data, labels = data.to(device), labels.to(device)
    state, loss = step(state, data, labels, 1)
    first = float(loss)
    for _ in range(args.warmUp - 1):
        state, loss = step(state, data, labels, 1)
    float(loss)
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    for _ in range(args.iteration):
        state, loss = step(state, data, labels, 1)
    final = float(loss)
    dt = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(device) if cuda else None
    if not np.isfinite(final):
        raise SystemExit(f"transformer perf run diverged: loss={final} "
                         f"(throughput would be meaningless)")
    flops = step_flops(model, vocab, args.dModel, args.numLayers, b, s)
    out = {"fused": fused, "first_loss": first, "final_loss": final,
           "tokens_per_s": b * s * args.iteration / dt,
           "ms_per_step": dt / args.iteration * 1e3,
           "tflops": flops["dense"] * args.iteration / dt / 1e12,
           "tflops_causal": flops["causal"] * args.iteration / dt / 1e12,
           "peak_bytes": peak, "model": model, "data": data,
           "labels": labels}
    print(f"transformer: {out['tokens_per_s']:,.0f} tokens/s "
          f"({out['ms_per_step']:.1f} ms/step, B{b} S{s} vocab {vocab}, "
          f"fused head+CE {fused}, final loss {final:.3f}) "
          f"[{out['tflops']:.1f} TFLOP/s analytic, "
          f"{out['tflops_causal']:.1f} at causal attention] peak memory "
          + (f"{peak} bytes" if cuda else "not measured (CPU)"))
    return out


def _flop_hooks(model):
    """Forward hooks that add each conv's and linear's training FLOPs to
    the returned list's one element: 2 per multiply-add of the forward,
    times 3 for the forward, dx and dW, or 2 where the layer computes no
    dx (``propagate_back=False``: ``conv1``). Returns (handles, total)."""
    from bigdl_tpu_torch import nn
    total = [0]

    def conv(m, inp, out):
        macs = out.numel() * m.weight[0].numel()
        total[0] += 2 * macs * (3 if m.propagate_back else 2)

    def linear(m, inp, out):
        total[0] += 2 * out.numel() * m.input_size * 3

    handles = []
    for m in model.modules():
        if isinstance(m, nn.SpatialConvolution):
            handles.append(m.register_forward_hook(conv))
        elif isinstance(m, nn.Linear):
            handles.append(m.register_forward_hook(linear))
    return handles, total


def make_conv_step(model, sgd):
    """``step(opt_state, data, labels, epoch) -> (opt_state, loss)``:
    ``ClassNLLCriterion`` on the model's log-probabilities, autograd,
    ``sgd.update`` in place."""
    from bigdl_tpu_torch import nn
    from bigdl_tpu_torch.optim.accumulation import make_train_step
    return make_train_step(fwd=model, criterion=nn.ClassNLLCriterion(),
                           params=dict(model.named_parameters()),
                           update_fn=sgd.update)


def _conv_perf(args, device):
    """Conv-model train-step throughput (records/s), as the JAX
    harness's ``main`` sets it up."""
    from bigdl_tpu_torch import models, nn
    from bigdl_tpu_torch.optim import SGD
    from bigdl_tpu_torch.tensor import DTypePolicy, set_policy

    # the policy the flag names, whatever an earlier run in this process
    # set (f32: the default policy)
    set_policy(DTypePolicy(param_dtype=torch.float32,
                           compute_dtype=torch.bfloat16,
                           activation_dtype=torch.bfloat16)
               if args.dataType == "bf16" else DTypePolicy())
    ctor, size = CONV_MODELS[args.module]
    b = args.batchSize
    model = getattr(models, ctor)(args.classNum, device=device,
                                  generator=torch.Generator().manual_seed(0))
    model.train()
    dropout_gen = torch.Generator(device=device).manual_seed(0)
    for m in model.modules():
        if isinstance(m, nn.Dropout):
            m.generator = dropout_gen
    sgd = SGD(learning_rate=0.01, momentum=0.9)
    state = sgd.init_state(dict(model.named_parameters()))
    step = make_conv_step(model, sgd)

    host = np.random.default_rng(0)
    data = torch.as_tensor(host.standard_normal(
        (b, 3, size, size), np.float32)).to(device)
    labels = torch.as_tensor(host.integers(
        1, args.classNum + 1, size=(b,))).to(device)
    handles, flops = _flop_hooks(model)      # the first step's FLOPs
    try:
        state, loss = step(state, data, labels, 1)
    finally:
        for h in handles:
            h.remove()
    flops = flops[0]
    first = float(loss)
    for _ in range(args.warmUp - 1):
        state, loss = step(state, data, labels, 1)
    float(loss)
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    for _ in range(args.iteration):
        state, loss = step(state, data, labels, 1)
    final = float(loss)
    dt = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(device) if cuda else None
    if not np.isfinite(final):
        raise SystemExit(f"{args.module} perf run diverged: loss={final} "
                         f"(throughput would be meaningless)")
    out = {"first_loss": first, "final_loss": final,
           "records_per_s": b * args.iteration / dt,
           "ms_per_step": dt / args.iteration * 1e3,
           "step_flops": flops,
           "tflops": flops * args.iteration / dt / 1e12,
           "peak_bytes": peak, "model": model, "data": data,
           "labels": labels, "sgd": sgd, "opt_state": state}
    print(f"{args.module}: {out['records_per_s']:.2f} records/second "
          f"({out['ms_per_step']:.2f} ms/iteration, B{b} {size}x{size}, "
          f"final loss {final:.4f}) [{out['tflops']:.1f} TFLOP/s analytic] "
          f"peak memory "
          + (f"{peak} bytes" if cuda else "not measured (CPU)"))
    return out


def main(argv=None):
    parser = argparse.ArgumentParser(description="training perf harness")
    parser.add_argument("-m", "--module", default="inception_v1",
                        choices=sorted([*MODELS, *CONV_MODELS])
                        + ["attention", "transformer", "decode"])
    parser.add_argument("-b", "--batchSize", type=int, default=None,
                        help="default: 128 (conv models), 4 (attention), "
                             "8 (transformer)")
    parser.add_argument("-i", "--iteration", type=int, default=30)
    parser.add_argument("--warmUp", type=int, default=5)
    parser.add_argument("--classNum", type=int, default=None,
                        help="default: 1000 (conv models), vocab 8192 "
                             "(transformer)")
    parser.add_argument("--dataType", default="bf16",
                        choices=["f32", "bf16"])
    parser.add_argument("--seqLen", type=int, default=None,
                        help="sequence length; default 4096 (attention), "
                             "2048 (transformer)")
    parser.add_argument("--heads", type=int, default=8,
                        help="attention mode: heads")
    parser.add_argument("--headDim", type=int, default=128,
                        help="attention mode: head dim")
    parser.add_argument("--fusedHeadLoss", default="auto",
                        choices=["auto", "off"],
                        help="transformer mode: fused LM head + CE "
                             "kernels (auto: on the card)")
    parser.add_argument("--dModel", type=int, default=512,
                        help="transformer mode: model width (heads = "
                             "dModel/128)")
    parser.add_argument("--posEncoding", default="learned",
                        choices=["learned", "rope"],
                        help="transformer position encoding")
    parser.add_argument("--numKvHeads", type=int, default=None,
                        help="< heads selects grouped-query attention")
    parser.add_argument("--numLayers", type=int, default=6,
                        help="transformer mode: layers")
    parser.add_argument("--device", default="cuda",
                        help="cuda (default) or cpu")
    args = parser.parse_args(argv)

    if args.module == "decode":
        raise NotImplementedError(
            "-m decode needs generate(), which is not ported yet "
            "(ROADMAP.md queue A, Serving depth)")
    if args.module in MODELS:
        raise NotImplementedError(
            f"-m {args.module}: the conv model zoo is not ported yet "
            f"(ROADMAP.md queue A, {MODELS[args.module]})")
    from bigdl_tpu_torch.tensor import resolve_device
    device = resolve_device(args.device)
    if args.batchSize is None:
        args.batchSize = {"attention": 4, "transformer": 8}.get(
            args.module, 128)
    if args.seqLen is None:
        args.seqLen = 2048 if args.module == "transformer" else 4096
    if args.classNum is None:
        args.classNum = 8192 if args.module == "transformer" else 1000
    if args.module in CONV_MODELS:
        return _conv_perf(args, device)
    if args.module == "attention":
        return _attention_perf(args, device)
    return _transformer_perf(args, device)


if __name__ == "__main__":
    main()

"""Transformer LM training main (counterpart of
``bigdl_tpu/models/transformer/train.py``).

    python -m bigdl_tpu_torch.models.transformer.train -f <dir_with_input.txt>
        [--seqLength 128] [--device cuda]

The same flags as the JAX main, plus ``--device`` (default ``cuda``;
``cpu`` runs the plain versions of the kernels). It trains on one device
through ``LocalOptimizer`` with ``CrossEntropyCriterion`` on raw logits,
SGD(0.02, decay 0.001) and a validation loss every epoch. Weights come
from torch's default generator (``torch.manual_seed`` seeds them), the
data order from ``utils.random.RandomGenerator``; ``--dropout`` > 0
draws its masks from a generator on the device seeded with
``torch.initial_seed()``. Not ported yet, and refused: ``--chips`` > 1
and ``--sequenceParallel`` (ROADMAP.md queue A, Multi-card),
``--model``/``--state``/``--checkpoint`` (snapshots; queue A,
Single-device training leftovers). The JAX main runs
``DistriOptimizer`` over a one-chip mesh; the step math is the same.

``main`` returns the optimizer, whose ``history`` holds every step's
loss and ``validation_results`` every validation pass.
"""
from __future__ import annotations

from bigdl_tpu_torch.models.utils.cli import base_train_parser, setup_logging

_MULTI_CARD = "is not ported yet (ROADMAP.md queue A, Multi-card)"
_SNAPSHOTS = ("is not ported yet (ROADMAP.md queue A, Single-device "
              "training leftovers)")


def main(argv=None):
    setup_logging()
    parser = base_train_parser("Train a Transformer LM")
    parser.add_argument("--vocabSize", type=int, default=4000)
    parser.add_argument("--dModel", type=int, default=128)
    parser.add_argument("--numHeads", type=int, default=4)
    parser.add_argument("--numLayers", type=int, default=2)
    parser.add_argument("--seqLength", type=int, default=128)
    parser.add_argument("--dropout", type=float, default=0.0)
    parser.add_argument("--posEncoding", default="learned",
                        choices=["learned", "rope"])
    parser.add_argument("--numKvHeads", type=int, default=None,
                        help="< numHeads selects grouped-query attention")
    parser.add_argument("--sequenceParallel", default=None,
                        choices=[None, "ring", "ulysses"])
    args = parser.parse_args(argv)
    if args.chips is not None and args.chips > 1:
        raise NotImplementedError(f"--chips {args.chips}: multi-card "
                                  f"training {_MULTI_CARD}")
    if args.sequenceParallel:
        raise NotImplementedError(f"--sequenceParallel {_MULTI_CARD}")
    for flag in ("model", "state", "checkpoint"):
        if getattr(args, flag):
            raise NotImplementedError(f"--{flag}: snapshots (utils/file.py) "
                                      f"{_SNAPSHOTS}")

    import torch

    from bigdl_tpu_torch import nn
    from bigdl_tpu_torch.models import TransformerLM
    from bigdl_tpu_torch.models.utils.text_lm import build_text_lm_datasets
    from bigdl_tpu_torch.optim import (SGD, Loss, Optimizer, every_epoch,
                                       max_epoch)
    from bigdl_tpu_torch.tensor import resolve_device

    device = resolve_device(args.device)
    batch = args.batchSize or 32
    train_set, val_set, vocab, _ = build_text_lm_datasets(
        args.folder, args.vocabSize, args.seqLength, batch, one_hot=False)
    # raw-logits head + the lse-form CrossEntropy: no (B, S, V) f32
    # log-prob tensor is kept for the backward
    model = TransformerLM(vocab, d_model=args.dModel,
                          num_heads=args.numHeads,
                          num_layers=args.numLayers,
                          max_len=args.seqLength, dropout=args.dropout,
                          with_log_softmax=False,
                          pos_encoding=args.posEncoding,
                          num_kv_heads=args.numKvHeads, device=device)
    dropout_gen = torch.Generator(device=device).manual_seed(
        torch.initial_seed())
    for m in model.modules():
        if isinstance(m, nn.Dropout):
            m.generator = dropout_gen
    criterion = nn.CrossEntropyCriterion()
    optimizer = Optimizer(model, train_set, criterion)
    optimizer.set_optim_method(SGD(
        learning_rate=args.learningRate or 0.02,
        learning_rate_decay=0.001))
    optimizer.set_validation(every_epoch(), val_set,
                             [Loss(criterion.clone_criterion())])
    optimizer.set_end_when(max_epoch(args.maxEpoch or 10))
    optimizer.optimize()
    return optimizer


if __name__ == "__main__":
    main()

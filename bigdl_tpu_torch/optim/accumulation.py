"""The train step (counterpart of ``make_train_step`` in
``bigdl_tpu/optim/accumulation.py``): one forward, one backward, one
optimizer update. Only ``num_microbatches == 1`` is ported; gradient
accumulation over k > 1 microbatches is queued (ROADMAP.md queue A,
Single-device training leftovers). PyTorch runs eagerly, so the step is a plain function where the
JAX package compiles one."""
from __future__ import annotations

import torch

__all__ = ["make_train_step"]


def make_train_step(*, fwd, criterion, params, update_fn,
                    num_microbatches: int = 1):
    """``step(opt_state, data, labels, epoch) -> (opt_state, loss)``:
    ``loss = criterion(fwd(data), labels)``, gradients of ``params`` (a
    dict name -> parameter) by autograd, then ``update_fn(grads, params,
    opt_state)`` with the state's epoch set to ``epoch``. The returned
    loss is a detached device scalar (read back by the caller's drain)."""
    if int(num_microbatches) != 1:
        raise NotImplementedError(
            f"num_microbatches={num_microbatches}: gradient accumulation "
            "over k > 1 microbatches is not ported yet (ROADMAP.md queue "
            "A, Single-device training leftovers)")
    names = list(params)
    tensors = [params[n] for n in names]

    def train_step(opt_state, data, labels, epoch):
        loss = criterion(fwd(data), labels)
        grads = torch.autograd.grad(loss, tensors)
        opt_state = dict(opt_state, epoch=epoch)
        new_state = update_fn(dict(zip(names, grads)), params, opt_state)
        return new_state, loss.detach()

    return train_step

"""Criteria (counterpart of ``bigdl_tpu/nn/criterion.py``): the
cross-entropy the transformer LM trains with and the ClassNLL of the conv
models. Targets are 1-based."""
from __future__ import annotations

import torch

from bigdl_tpu_torch.nn.module import Criterion

__all__ = ["ClassNLLCriterion", "CrossEntropyCriterion"]


def _nll_reduce(per, t, weights, size_average):
    """Per-sample loss ``per`` reduced with optional per-class weights
    (``t``: 0-based classes)."""
    if weights is not None:
        w = weights[t]
        total = torch.sum(w * per)
        return total / torch.sum(w) if size_average else total
    total = torch.sum(per)
    return total / t.shape[0] if size_average else total


class ClassNLLCriterion(Criterion):
    """Negative log-likelihood of the 1-based ``target`` class in rows of
    log-probabilities, reduced with optional per-class ``weights``."""

    def __init__(self, weights=None, size_average: bool = True):
        self.weights = None if weights is None else torch.as_tensor(weights)
        self.size_average = size_average

    def apply(self, x, target):
        t = target.to(device=x.device).long().reshape(-1) - 1
        logp = x.reshape(-1, x.shape[-1])
        picked = torch.gather(logp, 1, t[:, None])[:, 0]
        w = None if self.weights is None else self.weights.to(
            device=x.device, dtype=logp.dtype)
        return _nll_reduce(-picked, t, w, self.size_average)


class CrossEntropyCriterion(Criterion):
    """LogSoftMax + ClassNLL fused, in lse form: ``logsumexp(x) -
    x[target]`` per row, in (at least) f32. The composition would keep the
    (N, V) log-prob tensor for the backward; the lse form's gradient is
    ``softmax(x) - onehot`` alone. ``label_smoothing`` mixes in the mean
    CE over all classes, with class weights as torch weights them."""

    def __init__(self, weights=None, size_average: bool = True,
                 label_smoothing: float = 0.0):
        self.weights = None if weights is None else torch.as_tensor(weights)
        self.size_average = size_average
        if not 0.0 <= label_smoothing < 1.0:
            raise ValueError(f"label_smoothing must be in [0, 1), got "
                             f"{label_smoothing}")
        self.label_smoothing = label_smoothing

    def apply(self, x, target):
        t = target.to(device=x.device).long().reshape(-1) - 1
        logits = x.reshape(-1, x.shape[-1])
        logits = logits.to(torch.promote_types(logits.dtype, torch.float32))
        lse = torch.logsumexp(logits, dim=-1)
        picked = torch.gather(logits, 1, t[:, None])[:, 0]
        per = lse - picked
        eps = self.label_smoothing
        w = None if self.weights is None else self.weights.to(
            device=x.device, dtype=logits.dtype)
        if eps > 0.0 and w is not None:
            w_t = w[t]
            smooth = (lse * torch.sum(w) - logits @ w) / logits.shape[-1]
            total = torch.sum((1.0 - eps) * w_t * per + eps * smooth)
            return total / torch.sum(w_t) if self.size_average else total
        if eps > 0.0:
            per = (1.0 - eps) * per + eps * (lse - logits.mean(dim=-1))
        return _nll_reduce(per, t, w, self.size_average)

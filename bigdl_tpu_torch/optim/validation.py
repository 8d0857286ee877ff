"""Validation methods and addable results (counterpart of
``bigdl_tpu/optim/validation.py``): ``Loss`` and its result. The
cross-process gather of results comes with distributed training
(ROADMAP.md queue A, Multi-card)."""
from __future__ import annotations

import torch

__all__ = ["ValidationResult", "LossResult", "ValidationMethod", "Loss"]


class ValidationResult:
    def result(self) -> tuple[float, int]:
        raise NotImplementedError

    def __add__(self, other):
        raise NotImplementedError


class LossResult(ValidationResult):
    def __init__(self, loss: float, count: int):
        self.loss, self.count = float(loss), int(count)

    def result(self):
        return (self.loss / max(self.count, 1), self.count)

    def __add__(self, other):
        return LossResult(self.loss + other.loss, self.count + other.count)

    def __repr__(self):
        mean, cnt = self.result()
        return f"Loss(loss: {self.loss}, count: {cnt}, mean: {mean})"


class ValidationMethod:
    """output x target -> ValidationResult."""

    def __call__(self, output, target) -> ValidationResult:
        raise NotImplementedError


class Loss(ValidationMethod):
    """Mean criterion loss, weighted by the batch's row count."""

    def __init__(self, criterion):
        self.criterion = criterion

    def __call__(self, output, target):
        with torch.no_grad():
            loss = float(self.criterion(output, torch.as_tensor(target)))
        n = output.shape[0]
        return LossResult(loss * n, n)

    def __repr__(self):
        return "Loss"

"""Module base: ``torch.nn.Module`` plus the JAX package's tree view.

Counterpart of ``bigdl_tpu/nn/module.py``. A JAX module is a pure
init/apply pair over a nested params dict; here parameters live on the
module as usual, and ``Module.params`` gives the same nested-dict view
(children keyed by their names, leaves are the parameter tensors
themselves, not copies). The decode and serving functions read that view
exactly as the JAX ones read the params tree, and ``state_dict`` keys are
the JAX tree paths joined by ``.``.
"""
from __future__ import annotations

import copy

import torch

__all__ = ["Module", "Container", "Criterion"]


class Module(torch.nn.Module):

    def __init__(self):
        super().__init__()
        self.name = type(self).__name__

    @property
    def params(self) -> dict:
        """Nested dict of this module's parameters, keyed like the JAX
        params tree (parameterless children map to ``{}``)."""
        tree = {n: p for n, p in self._parameters.items() if p is not None}
        for n, child in self._modules.items():
            tree[n] = child.params if isinstance(child, Module) else {}
        return tree

    def set_name(self, name: str):
        self.name = name
        return self

    # The JAX package's ``training()`` is torch's ``train()`` here: torch
    # keeps the train-mode flag, a plain bool, in ``self.training``.
    def evaluate(self):
        """Inference mode (the JAX package's name for ``eval()``)."""
        return self.eval()


class Container(Module):
    """Children named ``"0"``, ``"1"``, ... in the order they were added,
    so their ``state_dict`` keys match the JAX container's tree paths."""

    def __init__(self, *modules: Module):
        super().__init__()
        for m in modules:
            self.add(m)

    def add(self, module: Module):
        self.add_module(str(len(self._modules)), module)
        return self

    def __getitem__(self, i: int) -> Module:
        return self._modules[str(i)]


class Criterion:
    """Loss base (counterpart of ``Criterion`` in ``bigdl_tpu/nn/module.py``):
    ``loss = criterion(input, target)``, a scalar tensor that autograd
    differentiates. Class targets are 1-based, as in the JAX package."""

    size_average: bool = True

    def apply(self, x, target):
        raise NotImplementedError

    def forward(self, x, target):
        return self.apply(x, target)

    __call__ = forward

    def clone_criterion(self):
        return copy.deepcopy(self)

    def __repr__(self):
        return f"{type(self).__name__}()"

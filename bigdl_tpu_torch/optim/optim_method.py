"""Optimization-method protocol (counterpart of ``OptimMethod`` in
``bigdl_tpu/optim/optim_method.py``).

``init_state(params)`` builds the method's state; ``update(grads, params,
state)`` applies one step and returns the new state. ``params`` is a dict
of name -> parameter (``model.named_parameters()``), ``grads`` the same
names -> gradients. Where the JAX method returns new parameter arrays,
the port updates the parameters in place (under ``torch.no_grad``): the
module keeps its tensors and no second copy of the weights is made.
State counters are host ints; per-parameter state is keyed by the
parameter names.
"""
from __future__ import annotations

__all__ = ["OptimMethod"]


class OptimMethod:
    """Base optimizer."""

    def init_state(self, params) -> dict:
        return {"neval": 0, "epoch": 1}

    def update(self, grads, params, state) -> dict:
        """Update ``params`` in place; return the new state."""
        raise NotImplementedError

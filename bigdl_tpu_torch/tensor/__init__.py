"""Tensor layer: the dtype policy and device resolution.

Counterpart of ``bigdl_tpu/tensor/__init__.py``. The policy names three
dtypes: parameters are stored in ``param_dtype``, matmul operands are cast
to ``compute_dtype``, and layer outputs are materialized in
``activation_dtype``. Modules cast explicitly at those points;
``torch.autocast`` is not used because it casts at other points (and
would change the numbers the port is held to).
"""
from __future__ import annotations

import contextlib
from dataclasses import dataclass

import torch

__all__ = ["DTypePolicy", "get_policy", "set_policy", "policy_scope",
           "default_dtype", "compute_dtype", "activation_dtype",
           "resolve_device"]


@dataclass(frozen=True)
class DTypePolicy:
    """Parameter dtype vs compute dtype vs materialized-activation dtype
    (None means ``param_dtype``)."""
    param_dtype: torch.dtype = torch.float32
    compute_dtype: torch.dtype = torch.float32
    activation_dtype: torch.dtype | None = None


_policy = DTypePolicy()


def get_policy() -> DTypePolicy:
    return _policy


def set_policy(policy: DTypePolicy) -> None:
    global _policy
    _policy = policy


@contextlib.contextmanager
def policy_scope(policy: DTypePolicy):
    prev = get_policy()
    set_policy(policy)
    try:
        yield
    finally:
        set_policy(prev)


def default_dtype() -> torch.dtype:
    return _policy.param_dtype


def compute_dtype() -> torch.dtype:
    return _policy.compute_dtype


def activation_dtype() -> torch.dtype:
    """Dtype layer outputs are cast to (what lives in memory between
    ops)."""
    return (_policy.activation_dtype if _policy.activation_dtype is not None
            else _policy.param_dtype)


def resolve_device(device="cuda") -> torch.device:
    """The device an entry point runs on. The default is the card; a CUDA
    device on a machine without one raises instead of carrying on on the
    CPU."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device} requested but CUDA is not available — pass "
            "device='cpu' explicitly to run on the CPU")
    return device

"""Moving parameters across from the JAX package.

JAX params are a nested dict (the module tree: containers key their
children ``"0"``, ``"1"``, ...). ``params_from_jax`` turns such a tree,
with numpy arrays (or anything ``np.asarray`` reads) as leaves, into a
``state_dict`` whose keys are the tree paths joined by ``.`` and whose
shapes are the leaves' — the layout this package's modules use. No JAX
import is needed: the caller hands over host arrays.
``sgd_state_from_jax`` does the same for an SGD state, so a run can start
both packages from one mid-run point.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["params_from_jax", "load_jax_params", "sgd_state_from_jax"]


def params_from_jax(tree, prefix: str = "") -> dict:
    """Nested dict of arrays -> flat ``{"a.b.c": tensor}`` (CPU tensors,
    dtype and shape kept; empty subtrees contribute nothing)."""
    out = {}
    for key, val in tree.items():
        path = f"{prefix}{key}"
        if isinstance(val, dict):
            out.update(params_from_jax(val, path + "."))
        else:
            out[path] = torch.from_numpy(np.array(val, copy=True))
    return out


def load_jax_params(model: torch.nn.Module, tree) -> torch.nn.Module:
    """Copy a JAX params tree into ``model`` in place (onto its devices
    and dtypes). Strict: every model parameter must be matched by exactly
    one leaf and every leaf must land, with equal shapes
    (``load_state_dict`` raises otherwise)."""
    model.load_state_dict(params_from_jax(tree), strict=True)
    return model


def sgd_state_from_jax(state, device="cpu") -> dict:
    """A JAX ``SGD`` state (``neval``, ``epoch`` and, with momentum, the
    ``velocity`` tree; numpy leaves) -> the port's SGD state: host-int
    counters and the velocity keyed by parameter name, on ``device``."""
    out = {"neval": int(np.asarray(state["neval"])),
           "epoch": int(np.asarray(state.get("epoch", 1)))}
    if "velocity" in state:
        out["velocity"] = {n: t.to(device) for n, t in
                           params_from_jax(state["velocity"]).items()}
    return out

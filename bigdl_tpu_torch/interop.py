"""Moving parameters across from the JAX package.

JAX params are a nested dict (the module tree: containers key their
children ``"0"``, ``"1"``, ...). ``params_from_jax`` turns such a tree,
with numpy arrays (or anything ``np.asarray`` reads) as leaves, into a
``state_dict`` whose keys are the tree paths joined by ``.`` and whose
shapes are the leaves' — the layout this package's modules use. No JAX
import is needed: the caller hands over host arrays.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["params_from_jax", "load_jax_params"]


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

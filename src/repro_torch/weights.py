"""Carry parameters across from the JAX package.

`params_from_jax` takes the reference's parameter tree as numpy arrays
(`jax.tree.map(np.asarray, params)`) and returns the port's: the same
nested dict of f32 tensors in the same layouts, on `device`.  Both packages
then compute the same function from the same weights.
"""
from __future__ import annotations

import numpy as np
import torch


def params_from_jax(np_tree, device="cpu"):
    if isinstance(np_tree, dict):
        return {k: params_from_jax(v, device) for k, v in np_tree.items()}
    return torch.as_tensor(np.array(np_tree, dtype=np.float32),
                           device=device)

"""Carry parameters across from the JAX package.

`params_from_jax` takes the reference's parameter tree as numpy arrays
(`jax.tree.map(np.asarray, params)`) and returns the port's: the same
nested dict (stacked (L, ...) leaves, (in, out) dense weights) of tensors
in the same layouts and dtypes, on `device`.  A bfloat16 leaf goes through
f32 to `torch.bfloat16`, which is exact.  Both packages then compute the
same function from the same weights.
"""
from __future__ import annotations

import numpy as np
import torch


def params_from_jax(np_tree, device="cpu"):
    if isinstance(np_tree, dict):
        return {k: params_from_jax(v, device) for k, v in np_tree.items()}
    arr = np.asarray(np_tree)
    if arr.dtype.name == "bfloat16":          # ml_dtypes' bfloat16
        return torch.as_tensor(arr.astype(np.float32),
                               device=device).to(torch.bfloat16)
    return torch.as_tensor(np.array(arr), device=device)

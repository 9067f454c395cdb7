"""Parameter-tree arithmetic and the flat-buffer substrate.

Parameter trees are (nested) dicts of tensors.  The flat substrate turns a
stacked tree — leaves (*lead, ...) — into one contiguous (*lead, N) f32
buffer so the fused RLOO / aggregation kernels see a single array.

Leaf order is the reference's: `jax.tree.flatten` visits dict keys in
*sorted* order, so `ravel` sorts keys at every level.  Python dicts keep
insertion order (LeNet inserts `conv1` first, but the flat buffer starts
with `b1`), so iterating a dict directly would give another layout.
"""
from __future__ import annotations

import math
import typing as tp

import torch


def tree_leaves(tree) -> list:
    """Leaves of a nested dict in sorted-key order (the flat layout)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    return [tree]


def tree_paths(tree, prefix=()) -> list:
    """Key paths of the leaves, in `tree_leaves` order."""
    if isinstance(tree, dict):
        return [p for k in sorted(tree) for p in tree_paths(tree[k],
                                                            prefix + (k,))]
    return [prefix]


def tree_map(fn, tree, *rest):
    """Apply `fn` leafwise over trees of identical structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def tree_sub(a, b):
    return tree_map(torch.subtract, a, b)


def tree_scale(a, s):
    return tree_map(lambda x: x * s, a)


def tree_axpy(s, x, y):
    """y + s * x (like BLAS axpy)."""
    return tree_map(lambda xi, yi: yi + s * xi, x, y)


def tree_zeros_like(a):
    return tree_map(torch.zeros_like, a)


def tree_dot(a, b):
    """Global inner product <a, b> over all leaves, accumulated in f32."""
    parts = [torch.sum(x.float() * y.float())
             for x, y in zip(tree_leaves(a), tree_leaves(b))]
    return torch.sum(torch.stack(parts)) if parts else torch.tensor(0.0)


def tree_norm_sq(a):
    return tree_dot(a, a)


def tree_mean(tree, axis=0):
    return tree_map(lambda x: torch.mean(x, dim=axis), tree)


def tree_bytes(tree) -> int:
    return sum(x.numel() * x.element_size() for x in tree_leaves(tree))


# ---------------------------------------------------------------------------
# Flat-buffer substrate: stacked tree <-> one contiguous (*lead, N) buffer
# ---------------------------------------------------------------------------

class FlatSpec(tp.NamedTuple):
    """Recipe to reassemble a tree from a flat vector.

    paths   : key path of every leaf, in flat order (sorted keys).
    shapes  : per-leaf trailing shapes (leading stack axes stripped).
    offsets : start offset of each leaf in the flat dimension.
    sizes   : per-leaf flat sizes.
    n       : total flat dimension N = sum(sizes).
    """
    paths: tuple
    shapes: tuple
    offsets: tuple
    sizes: tuple
    n: int


def flat_spec(tree, lead: int = 1) -> FlatSpec:
    """FlatSpec for `tree` whose leaves carry `lead` leading stack axes."""
    leaves = tree_leaves(tree)
    shapes = tuple(tuple(x.shape[lead:]) for x in leaves)
    sizes = tuple(int(math.prod(s)) for s in shapes)
    offsets, off = [], 0
    for s in sizes:
        offsets.append(off)
        off += s
    return FlatSpec(tuple(tree_paths(tree)), shapes, tuple(offsets), sizes,
                    off)


def ravel_stack(tree, lead: int = 1):
    """Stacked tree (leaves (*lead, ...)) -> ((*lead, N) f32, FlatSpec)."""
    spec = flat_spec(tree, lead)
    leaves = tree_leaves(tree)
    head = tuple(leaves[0].shape[:lead])
    flat = torch.cat([x.float().reshape(head + (-1,)) for x in leaves],
                     dim=-1)
    return flat, spec


def ravel(tree):
    """Unstacked tree -> ((N,) f32 vector, FlatSpec)."""
    return ravel_stack(tree, lead=0)


def unravel(vec, spec: FlatSpec):
    """(*lead, N) buffer -> tree with leaves (*lead, *shape), as views."""
    lead = tuple(vec.shape[:-1])
    out: dict = {}
    for path, off, sz, shp in zip(spec.paths, spec.offsets, spec.sizes,
                                  spec.shapes):
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = vec[..., off:off + sz].reshape(lead + shp)
    return out


def unravel_stack(flat, spec: FlatSpec):
    """(*lead, N) buffer -> stacked tree with leaves (*lead, ...)."""
    return unravel(flat, spec)

"""Pytree helpers over nested dicts of tensors.

Port of the parts of ``repro/utils/pytree.py`` the round uses.  A tree
is a nested dict whose leaves are tensors; a bare tensor is a tree of
one leaf, so the flat (N, D) layout runs through the same helpers as
the tree layout.  Leaves come in sorted-key order at every level — the
order ``jax.tree.leaves`` gives a dict, and the one
``utils/flatstate.py`` lays a flat row out in.

"Stacked" trees carry a leading client axis of size N on every leaf.
"""
from __future__ import annotations

import math

import torch


def tree_map(fn, tree, *rest):
    """``fn`` applied leaf by leaf over trees of one structure."""
    if isinstance(tree, dict):
        for other in rest:
            if not isinstance(other, dict) or other.keys() != tree.keys():
                raise ValueError("tree structures differ: "
                                 f"{sorted(tree)} vs {other!r:.80}")
        return {k: tree_map(fn, tree[k], *(o[k] for o in rest))
                for k in sorted(tree)}
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    """The leaves of ``tree`` in sorted-key order."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    return [tree]


def rows_mask(mask: torch.Tensor, leaf: torch.Tensor) -> torch.Tensor:
    """The (N,) mask reshaped to broadcast over an (N, ...) leaf."""
    return mask.reshape((-1,) + (1,) * (leaf.dim() - 1))


def tree_where(mask: torch.Tensor, a, b):
    """Leafwise select by the (N,) bool mask over the leading axis."""
    return tree_map(lambda x, y: torch.where(rows_mask(mask, x), x, y),
                    a, b)


def tree_broadcast_like(tree, n: int):
    """Views of every leaf tiled along a new leading axis of size n."""
    return tree_map(lambda x: x[None].expand((n,) + tuple(x.shape)), tree)


def tree_zeros_like(tree):
    return tree_map(torch.zeros_like, tree)


def stacked_sq_norms(stacked) -> torch.Tensor:
    """Per-client squared norms of a stacked tree: r_i = Σ_leaves
    ‖leaf[i]‖², each leaf summed in fp32, the leaves added in order."""
    total = None
    for x in tree_leaves(stacked):
        x = x.to(torch.float32)
        part = torch.sum((x * x).reshape(x.shape[0], -1), dim=1)
        total = part if total is None else total + part
    return total


def flatten(tree) -> torch.Tensor:
    """The leaves as one contiguous (D,) fp32 vector, in leaf order."""
    return torch.cat([torch.as_tensor(x).to(torch.float32).reshape(-1)
                      for x in tree_leaves(tree)])


def flatten_stacked(tree) -> torch.Tensor:
    """A stacked tree as one contiguous (N, D) fp32 matrix: each leaf
    reshaped to (N, -1), concatenated in leaf order."""
    leaves = tree_leaves(tree)
    n = leaves[0].shape[0]
    return torch.cat([x.to(torch.float32).reshape(n, -1) for x in leaves],
                     dim=1)


def tree_size(tree) -> int:
    """Total number of scalars in the tree."""
    return sum(math.prod(x.shape) for x in tree_leaves(tree))

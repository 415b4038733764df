"""Pytree helpers over nested dicts of tensors.

Port of ``repro/utils/pytree.py``.  A tree
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


def is_record(x) -> bool:
    """A ``NamedTuple`` (a state or metrics record): a node whose fields
    are subtrees, as ``jax.tree`` takes one.  A plain tuple (a spec) is a
    leaf."""
    return isinstance(x, tuple) and hasattr(x, "_fields")


def tree_map(fn, tree, *rest):
    """``fn`` applied leaf by leaf over trees of one structure."""
    if isinstance(tree, dict):
        for other in rest:
            if not isinstance(other, dict) or other.keys() != tree.keys():
                raise ValueError("tree structures differ: "
                                 f"{sorted(tree)} vs {other!r:.80}")
        return {k: tree_map(fn, tree[k], *(o[k] for o in rest))
                for k in sorted(tree)}
    if is_record(tree):
        for other in rest:
            if type(other) is not type(tree):
                raise ValueError("tree structures differ: "
                                 f"{type(tree).__name__} vs {other!r:.80}")
        return type(tree)(*(tree_map(fn, x, *(o[i] for o in rest))
                            for i, x in enumerate(tree)))
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    """The leaves of ``tree`` in sorted-key order (a record's in field
    order)."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    if is_record(tree):
        return [leaf for x in tree for leaf in tree_leaves(x)]
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


# --- the reference's tree algebra (``repro/utils/pytree.py``) -------------


def tree_add(a, b):
    return tree_map(torch.add, a, b)


def tree_sub(a, b):
    return tree_map(torch.sub, a, b)


def tree_scale(tree, c):
    return tree_map(lambda x: x * c, tree)


def tree_axpy(a, x, y):
    """a·x + y, leaf by leaf."""
    return tree_map(lambda xl, yl: a * xl + yl, x, y)


def tree_dot(a, b) -> torch.Tensor:
    """Global inner product over every leaf, each in fp32, added in leaf
    order."""
    total = torch.zeros((), dtype=torch.float32,
                        device=tree_leaves(a)[0].device)
    for x, y in zip(tree_leaves(a), tree_leaves(b), strict=True):
        total = total + torch.dot(x.to(torch.float32).reshape(-1),
                                  y.to(torch.float32).reshape(-1))
    return total


def tree_sq_norm(tree) -> torch.Tensor:
    total = torch.zeros((), dtype=torch.float32,
                        device=tree_leaves(tree)[0].device)
    for x in tree_leaves(tree):
        x = x.to(torch.float32)
        total = total + torch.sum(x * x)
    return total


def tree_norm(tree) -> torch.Tensor:
    return torch.sqrt(tree_sq_norm(tree))


def tree_stack(trees):
    """A list of trees stacked along a new leading axis."""
    return tree_map(lambda *xs: torch.stack(xs), *trees)


def tree_unstack(tree, n: int) -> list:
    return [tree_index(tree, i) for i in range(n)]


def tree_index(tree, i):
    return tree_map(lambda x: x[i], tree)


def tree_bytes(tree) -> int:
    return sum(math.prod(x.shape) * x.element_size()
               for x in tree_leaves(tree))


def tree_cast(tree, dtype):
    return tree_map(lambda x: x.to(dtype), tree)


def tree_ravel(tree) -> torch.Tensor:
    """Every leaf flattened into one (D,) fp32 vector, in leaf order."""
    leaves = tree_leaves(tree)
    return flatten(tree) if leaves else torch.zeros((0,))

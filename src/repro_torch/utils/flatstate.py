"""Flat client-state codec: nested-dict params ⇄ contiguous fp32 rows.

Port of ``repro/utils/flatstate.py``.  θ, λ and z_prev live as (N, D)
fp32 matrices and ω as a (D,) vector; the solver views one row (or a
block of rows) as the model's parameter dict.  The leaf order is the
one ``jax.tree.flatten`` gives a nested dict — keys sorted at every
level — so a flat row here and a flat row of the JAX package hold the
same parameter at the same offset.

``unflatten`` and ``unflatten_stacked`` return *views* into the flat
buffer (no copy) when the leaf dtype is fp32; writing to a leaf writes
the row.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable

import torch

from .pytree import flatten, flatten_stacked


def _leaf_paths(tree, prefix=()):
    """(path, leaf) pairs of a nested dict, keys sorted at every level."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaf_paths(tree[k], prefix + (k,))
    else:
        yield prefix, tree


def _build(paths, leaves):
    out: dict = {}
    for path, leaf in zip(paths, leaves, strict=True):
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = leaf
    return out


@dataclasses.dataclass(frozen=True)
class FlatSpec:
    """Static layout of a params dict flattened to (D,) fp32."""

    paths: tuple[tuple[str, ...], ...]
    shapes: tuple[tuple[int, ...], ...]
    dtypes: tuple[torch.dtype, ...]
    offsets: tuple[int, ...]
    dim: int  # total flat width D

    def leaves(self, tree):
        """Leaves of ``tree`` in layout order (checks the structure)."""
        pairs = list(_leaf_paths(tree))
        if tuple(p for p, _ in pairs) != self.paths:
            raise ValueError("params structure does not match the spec: "
                             f"{[p for p, _ in pairs]} vs {self.paths}")
        return [leaf for _, leaf in pairs]

    def flatten(self, tree) -> torch.Tensor:
        """Params dict → contiguous (D,) fp32."""
        self.leaves(tree)
        return flatten(tree)

    def unflatten(self, vec: torch.Tensor):
        """(D,) vector → params dict of views with the template shapes."""
        return _build(self.paths, [
            vec[o:o + math.prod(s)].view(s).to(dt)
            for o, s, dt in zip(self.offsets, self.shapes, self.dtypes,
                                strict=True)])

    def flatten_stacked(self, tree) -> torch.Tensor:
        """Dict of (N, ...) leaves → contiguous (N, D) fp32."""
        self.leaves(tree)
        return flatten_stacked(tree)

    def unflatten_stacked(self, mat: torch.Tensor):
        """(N, D) matrix → dict of (N, ...) views (rows stay in ``mat``)."""
        n = mat.shape[0]
        return _build(self.paths, [
            mat[:, o:o + math.prod(s)].view(n, *s).to(dt)
            for o, s, dt in zip(self.offsets, self.shapes, self.dtypes,
                                strict=True)])


def make_flat_spec(template) -> FlatSpec:
    """Capture the flat layout of ``template`` (a nested params dict)."""
    pairs = list(_leaf_paths(template))
    shapes = tuple(tuple(torch.as_tensor(x).shape) for _, x in pairs)
    sizes = [math.prod(s) for s in shapes]
    offsets = tuple(sum(sizes[:i]) for i in range(len(sizes)))
    return FlatSpec(paths=tuple(p for p, _ in pairs), shapes=shapes,
                    dtypes=tuple(torch.as_tensor(x).dtype for _, x in pairs),
                    offsets=offsets, dim=sum(sizes))


def flat_loss_fn(spec: FlatSpec, loss_fn: Callable) -> Callable:
    """``loss_fn(params_tree, x, y)`` adapted to flat (D,) parameters."""
    def flat_loss(vec, x, y):
        return loss_fn(spec.unflatten(vec), x, y)

    return flat_loss


def flatten_problem(params0, loss_fn: Callable):
    """One-call front end: (spec, flat params0, flat loss_fn)."""
    spec = make_flat_spec(params0)
    return spec, spec.flatten(params0), flat_loss_fn(spec, loss_fn)

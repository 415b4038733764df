"""K1c: the stacked-pytree front end of the server trigger.

Replaces ``src/repro/kernels/ops.py::trigger_sq_norms_pytree``.  The
reference turns a stacked client tree into the (N, D) operand of K1
outside its Pallas body (XLA reshapes, casts to fp32 and concatenates
the leaves).  The port reads the leaves in place instead:

* A tree of one rank-2 leaf — the flat layout — goes to K1
  (:func:`.trigger_norms.trigger_sq_norms`) as it is: no copy, and the
  call is K1's alone (this wrapper counts nothing).
* Any other tree on a CUDA device: one launch of K1's leaf-table form
  (:func:`.trigger_norms.table_kernel`), its leaves in sorted-key order
  as the columns of a virtual row, each read at its own dtype (fp32 or
  bf16) — never the concatenation, whose copy made the bytes cross HBM
  three times.  Every row's sum is bit-equal to K1's on
  ``flatten_stacked(z)`` and ``flatten(ω)``.  A leaf whose
  ``reshape(n, -1)`` has no unit inner stride is made contiguous first
  (:func:`.trigger_norms.leaf_view`); ``leaf_copies`` counts those
  copies (the round's state needs none).  This wrapper counts the
  launch; K1 does not.
* CPU tensors take the plain version: the concatenation, then K1's plain
  version.

With ``mesh=`` (the reference's ``mesh=`` path, ``shard_map`` of K1)
the arguments are per shard.  A flat tree goes to K1b
(:func:`.trigger_norms.trigger_sq_norms_sharded`), which counts; any
other tree makes one table launch per device over that device's shards
× leaves, counted here.
"""
from __future__ import annotations

import torch

from repro_torch.utils.pytree import flatten, flatten_stacked, tree_leaves
from repro_torch.utils.spans import kernel_wrapper

from ._checks import check_shards, is_cpu, refuse_grad
from .trigger_norms import (group_by_device, leaf_view, table_kernel,
                            trigger_sq_norms, trigger_sq_norms_ref,
                            trigger_sq_norms_sharded)


def _is_flat(z_leaves) -> bool:
    return len(z_leaves) == 1 and z_leaves[0].dim() == 2


def _leaves(z_prev, omega) -> tuple[list, list]:
    z_leaves, w_leaves = tree_leaves(z_prev), tree_leaves(omega)
    if len(z_leaves) != len(w_leaves):
        raise ValueError(f"z_prev has {len(z_leaves)} leaves, omega "
                         f"{len(w_leaves)}")
    return z_leaves, w_leaves


def pytree_operands(z_prev, omega) -> tuple[torch.Tensor, torch.Tensor]:
    """(N, D) fp32 z and (D,) fp32 ω of a stacked tree and its ω tree:
    the plain version's front end (the reference's)."""
    z_leaves, w_leaves = _leaves(z_prev, omega)
    if _is_flat(z_leaves):
        return (z_leaves[0].to(torch.float32),
                w_leaves[0].reshape(-1).to(torch.float32))
    return flatten_stacked(z_prev), flatten(omega)


def table_block(z_prev, omega) -> tuple[list, list, int]:
    """One row block of the leaf table: (the z leaves as (n, w_l)
    matrices, the ω leaves as (w_l,) vectors, how many of them had to be
    copied).  Raises ValueError where an ω leaf's size differs from its
    z leaf's row."""
    z_leaves, w_leaves = _leaves(z_prev, omega)
    n = z_leaves[0].shape[0]
    zs, ws, copies = [], [], 0
    for i, (z, w) in enumerate(zip(z_leaves, w_leaves, strict=True)):
        if z.shape[0] != n or z.numel() != n * w.numel():
            raise ValueError(f"leaf {i}: z_prev {tuple(z.shape)} is not "
                             f"{n} stacked copies of omega's "
                             f"{tuple(w.shape)}")
        w1, wc = leaf_view(w, -1)
        z2, zc = (leaf_view(z, n, -1) if n else
                  (z.new_empty((0, w1.shape[0])), False))
        zs.append(z2)
        ws.append(w1)
        copies += zc + wc
    return zs, ws, copies


def _table(blocks, device):
    """One table launch over the (z tree, ω tree) ``blocks`` on
    ``device``; counts the launch and any leaf copies."""
    built = [table_block(z, w) for z, w in blocks]
    parts, launched = table_kernel([(zs, ws) for zs, ws, _ in built], device)
    trigger_sq_norms_pytree.launches += launched
    trigger_sq_norms_pytree.leaf_copies += sum(c for _, _, c in built)
    return parts


def trigger_sq_norms_pytree_ref(z_prev, omega) -> torch.Tensor:
    """Plain version: the same front end, then K1's plain version."""
    return trigger_sq_norms_ref(*pytree_operands(z_prev, omega))


@kernel_wrapper("trigger_sq_norms_pytree")
def trigger_sq_norms_pytree(z_prev, omega, *, mesh=None):
    """Stacked tree (N, ...) and its unstacked ω → (N,) fp32 squared
    distances ‖z_i − ω‖², leaves fp32 or bf16 (their plain version on CPU
    tensors).  With ``mesh``: the P per-shard stacked trees and the P
    copies of ω → the P per-shard (N/P,) distances."""
    refuse_grad("trigger_sq_norms_pytree", z_prev, omega)
    if mesh is not None:
        firsts = [tree_leaves(z)[0] for z in z_prev]
        check_shards(mesh, z_prev=firsts,
                     omega=[tree_leaves(w)[0] for w in omega])
        if _is_flat(tree_leaves(z_prev[0])):
            operands = [(tree_leaves(z)[0], tree_leaves(w)[0].reshape(-1))
                        for z, w in zip(z_prev, omega, strict=True)]
            return trigger_sq_norms_sharded([z for z, _ in operands],
                                            [w for _, w in operands], mesh)
        out = [None] * mesh.size
        for dev, idx in group_by_device(firsts).items():
            if is_cpu(*(x for i in idx for x in tree_leaves(z_prev[i])
                        + tree_leaves(omega[i]))):
                for i in idx:
                    out[i] = trigger_sq_norms_pytree_ref(z_prev[i], omega[i])
                continue
            for i, part in zip(idx, _table([(z_prev[i], omega[i])
                                            for i in idx], dev),
                               strict=True):
                out[i] = part
        return out
    z_leaves, w_leaves = _leaves(z_prev, omega)
    if _is_flat(z_leaves):
        return trigger_sq_norms(z_leaves[0], w_leaves[0].reshape(-1))
    if is_cpu(*z_leaves, *w_leaves):
        return trigger_sq_norms_pytree_ref(z_prev, omega)
    return _table([(z_prev, omega)], z_leaves[0].device)[0]


trigger_sq_norms_pytree.launches = 0
trigger_sq_norms_pytree.leaf_copies = 0


def trigger_sq_norms_pytree_hbm_bytes(z_prev, omega) -> int:
    """Bytes the function must move: every z and ω leaf read once at its
    own dtype, the (N,) fp32 distances written once."""
    z_leaves = tree_leaves(z_prev)
    read = sum(x.numel() * x.element_size()
               for x in z_leaves + tree_leaves(omega))
    return read + 4 * z_leaves[0].shape[0]

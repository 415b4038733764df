"""K1c: the stacked-pytree front end of the server trigger.

Replaces ``src/repro/kernels/ops.py::trigger_sq_norms_pytree``.  The
reference turns a stacked client tree into the (N, D) operand of K1
outside its Pallas body (XLA reshapes and concatenates the leaves); the
port does the same in PyTorch and hands the matrix to K1
(:mod:`.trigger_norms`), so the only kernel of this path is K1's.

* A tree of one rank-2 leaf — the flat layout — is read in place: no
  copy, and the call is K1's alone (this wrapper counts nothing).
* Any other tree: each leaf becomes ``leaf.reshape(n, -1)`` in fp32
  (bf16 leaves are cast here, before K1's fp32 check), the leaves are
  concatenated in sorted-key order, ω the same way, and K1 runs on the
  copy.  On CUDA tensors the wrapper counts that launch as its own.

With ``mesh=`` (the reference's ``mesh=`` path, ``shard_map`` of K1)
the arguments are per shard: each shard's tree goes through the same
front end on its own device, then K1b (:func:`.trigger_sq_norms_sharded`)
launches K1's kernel once per shard; a concatenating call counts one
launch per CUDA shard here too.
"""
from __future__ import annotations

import torch

from repro_torch.utils.pytree import flatten, flatten_stacked, tree_leaves

from ._checks import is_cpu
from .trigger_norms import trigger_sq_norms, trigger_sq_norms_ref, \
    trigger_sq_norms_sharded


def _is_flat(z_leaves) -> bool:
    return len(z_leaves) == 1 and z_leaves[0].dim() == 2


def pytree_operands(z_prev, omega) -> tuple[torch.Tensor, torch.Tensor]:
    """(N, D) fp32 z and (D,) fp32 ω of a stacked tree and its ω tree."""
    z_leaves, w_leaves = tree_leaves(z_prev), tree_leaves(omega)
    if len(z_leaves) != len(w_leaves):
        raise ValueError(f"z_prev has {len(z_leaves)} leaves, omega "
                         f"{len(w_leaves)}")
    if _is_flat(z_leaves):
        return (z_leaves[0].to(torch.float32),
                w_leaves[0].reshape(-1).to(torch.float32))
    return flatten_stacked(z_prev), flatten(omega)


def trigger_sq_norms_pytree_ref(z_prev, omega) -> torch.Tensor:
    """Plain version: the same front end, then K1's plain version."""
    return trigger_sq_norms_ref(*pytree_operands(z_prev, omega))


def trigger_sq_norms_pytree(z_prev, omega, *, mesh=None):
    """Stacked tree (N, ...) and its unstacked ω → (N,) fp32 squared
    distances ‖z_i − ω‖² through K1 (its plain version on CPU tensors).
    With ``mesh``: the P per-shard stacked trees and the P copies of ω
    → the P per-shard (N/P,) distances, through K1b."""
    if mesh is not None:
        operands = [pytree_operands(z, w)
                    for z, w in zip(z_prev, omega, strict=True)]
        out = trigger_sq_norms_sharded([z for z, _ in operands],
                                       [w for _, w in operands], mesh)
        if not _is_flat(tree_leaves(z_prev[0])):
            trigger_sq_norms_pytree.launches += sum(
                not is_cpu(*op) for op in operands)
        return out
    z2d, w1d = pytree_operands(z_prev, omega)
    out = trigger_sq_norms(z2d, w1d)
    if not _is_flat(tree_leaves(z_prev)) and not is_cpu(z2d, w1d):
        trigger_sq_norms_pytree.launches += 1
    return out


trigger_sq_norms_pytree.launches = 0


def trigger_sq_norms_pytree_hbm_bytes(z_prev, omega) -> int:
    """Bytes the function must move: every z and ω leaf read once at its
    own dtype, the (N,) fp32 distances written once (what K1 alone moves
    on the flat layout; the concatenated copy is not counted)."""
    z_leaves = tree_leaves(z_prev)
    read = sum(x.numel() * x.element_size()
               for x in z_leaves + tree_leaves(omega))
    return read + 4 * z_leaves[0].shape[0]

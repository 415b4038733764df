"""The client mesh: the leading client axis cut over devices.

Port of ``repro/sharding/clients.py``.  The reference lays the stacked
client axis out over a 1-D ``clients`` device mesh and lets one
controller (one process) drive every local device; its tests fake 8
devices on the CPU.  The port keeps that shape with explicit placement
instead of shardings:

* a :class:`ClientMesh` is an ordered tuple of ``torch.device``\\ s, one
  per shard; devices may repeat (P shards on one card, or P × ``cpu`` in
  the tests);
* a sharded tree is a tuple of P trees, shard i holding the contiguous
  block of clients [i·N/P, (i+1)·N/P) on ``mesh.devices[i]``
  (:func:`shard_rows`); with more than one shard each block owns its
  storage, so code that holds on one card holds on separate cards too;
* replicated values (ω, the PRNG key, the round counters) are one copy
  per shard (:func:`replicate_data`); on one device that is the same
  tensor, handed to every shard.

No process group is involved: the round's collectives are plain sums of
per-shard partials in shard order on shard 0's device
(``core/engine.py``), and copies between cards go device to device.
Each copy between shards is reported to :data:`collectives`' listeners,
which count the bytes it moves off a shard's device: the logical count,
the same on a mesh of CPU shards as on shards of one card or of several.
``constrain_clients`` has no counterpart: the placement is explicit.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.device import default_device
from repro_torch.utils.pytree import tree_leaves, tree_map

CLIENT_AXIS = "clients"

class CollectiveCounter:
    """Copies between shards: each of ``listeners`` is called with
    (kind, tensor) per copy, ``kind`` named after the reference's
    collectives — ``"all-reduce"`` (sums of partials,
    ``engine.all_sum``), ``"broadcast"`` (shard 0's value copied to the
    others), ``"all-gather"`` (blocks brought to shard 0),
    ``"scatter"`` (blocks cut from shard 0's value).  The op log of
    :mod:`repro_torch.analysis` listens."""

    def __init__(self):
        self.listeners: list = []

    def add(self, kind: str, trees) -> None:
        """Tell the listeners of one copy of each tensor in ``trees``
        (trees of them)."""
        if not self.listeners:
            return
        for tree in trees:
            for t in tree_leaves(tree):
                for fn in self.listeners:
                    fn(kind, t)


#: The process's reporter of copies between shards.
collectives = CollectiveCounter()


@dataclasses.dataclass(frozen=True)
class ClientMesh:
    """A 1-D client mesh (the reference's ``clients`` axis): shard i
    lives on ``devices[i]``."""

    devices: tuple[torch.device, ...]

    @property
    def size(self) -> int:
        return len(self.devices)


def make_client_mesh(n_shards: int, devices=None) -> ClientMesh:
    """A mesh of ``n_shards`` shards, shard i on device i mod the number
    of ``devices``.  ``devices=None`` takes the visible CUDA devices and
    raises without one (it never picks the CPU on its own): P shards on
    one card, or one shard per card on a node with P of them.  Pass
    ``devices=["cpu"]`` for P shards on the CPU."""
    if n_shards < 1:
        raise ValueError(f"n_shards must be >= 1, got {n_shards}")
    if devices is None:
        default_device()  # raises without a CUDA device
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    if not devices:
        raise ValueError("a client mesh needs at least one device")
    return ClientMesh(tuple(devices[i % len(devices)]
                            for i in range(n_shards)))


def check_divisible(n_clients: int, mesh: ClientMesh) -> None:
    """Fail early (with the fix in the message) on uneven client shards."""
    size = mesh.size
    if n_clients % size:
        raise ValueError(
            f"n_clients={n_clients} must be divisible by the "
            f"'{CLIENT_AXIS}' mesh axis size {size}; pick a dividing shard "
            "count (e.g. "
            f"{max(d for d in range(1, size + 1) if n_clients % d == 0)})")


def shard_rows(tree, mesh: ClientMesh) -> tuple:
    """Cut the leading client axis of every leaf into ``mesh.size``
    contiguous blocks, block i on ``mesh.devices[i]``: a tuple of P
    trees.  With more than one shard each block is a copy that owns its
    storage, never a view into the whole; one shard gets the tree
    itself, moved to its device."""
    n = tree_leaves(tree)[0].shape[0]
    check_divisible(n, mesh)
    if mesh.size == 1:
        return (tree_map(lambda x: x.to(mesh.devices[0], non_blocking=True),
                         tree),)
    n_local = n // mesh.size

    def block(i):
        return tree_map(lambda x: x[i * n_local:(i + 1) * n_local].to(
            mesh.devices[i], non_blocking=True, copy=True), tree)

    blocks = tuple(block(i) for i in range(mesh.size))
    collectives.add("scatter", blocks[1:])
    return blocks


def unshard_rows(shards):
    """The inverse of :func:`shard_rows`: the per-shard trees
    concatenated in shard order on shard 0's device (one shard: its tree
    itself)."""
    shards = tuple(shards)
    if len(shards) == 1:
        return shards[0]
    dev = tree_leaves(shards[0])[0].device
    collectives.add("all-gather", shards[1:])
    return tree_map(lambda *xs: torch.cat(
        [x.to(dev, non_blocking=True) for x in xs]), *shards)


def shard_client_data(mesh: ClientMesh, data) -> tuple:
    """Client-stacked data (a dict of arrays or tensors with a leading
    client axis) as one dict per shard on its device."""
    return shard_rows(tree_map(torch.as_tensor, data), mesh)


def replicate_data(mesh: ClientMesh, data) -> tuple:
    """One copy of ``data`` (a tensor or a tree) per shard, on the
    shard's device; where it already lies there, the tensor itself."""
    copies = tuple(tree_map(lambda x: torch.as_tensor(x).to(
        dev, non_blocking=True), data) for dev in mesh.devices)
    collectives.add("broadcast", copies[1:])
    return copies


def shard_targets(target_rate, mesh) -> tuple:
    """The controller's L̄ for each shard of ``mesh``: an (N,) per-client
    target cut into the shards' rows, as the reference's controller
    reads the rows of its sharded state; a 0-d one copied to each
    shard's device; a Python scalar as it is."""
    if not isinstance(target_rate, torch.Tensor):
        return (target_rate,) * mesh.size
    if target_rate.dim():
        return shard_rows(target_rate, mesh)
    return replicate_data(mesh, target_rate)


def balanced_permutation(sizes, n_shards: int) -> np.ndarray:
    """Client order that balances total data *rows* across mesh shards.

    The mesh splits the stacked state into ``n_shards`` equal-count
    contiguous blocks; with ragged clients the count is a bad proxy for
    solver rows.  This returns a permutation (apply it to the client
    order before pooling) such that each contiguous block of
    N/n_shards clients carries a near-equal Σnᵢ: clients are dealt
    largest-first onto the currently lightest block (LPT greedy, ≤ 4/3
    OPT makespan), deterministically.

    Returns an (N,) intp array ``perm`` — new position j holds old
    client ``perm[j]``.
    """
    sizes = np.asarray(sizes)
    n = len(sizes)
    if n % n_shards:
        raise ValueError(f"{n} clients do not divide into {n_shards} "
                         "equal-count mesh blocks")
    per_block = n // n_shards
    # Largest-first deal onto the lightest non-full block; ties broken
    # by block index so the permutation is deterministic.
    order = np.argsort(-sizes, kind="stable")
    blocks: list[list[int]] = [[] for _ in range(n_shards)]
    loads = np.zeros(n_shards, np.int64)
    for client in order:
        open_blocks = [b for b in range(n_shards)
                       if len(blocks[b]) < per_block]
        b = min(open_blocks, key=lambda i: (loads[i], i))
        blocks[b].append(int(client))
        loads[b] += int(sizes[client])
    # Ascending client index inside each block keeps the layout stable.
    return np.concatenate([np.sort(b) for b in blocks]).astype(np.intp)

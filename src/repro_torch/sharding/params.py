"""Placement of trees on the model mesh: the port's counterpart of
``jax.device_put`` with a ``NamedSharding`` over ``launch/mesh.py``'s
mesh, in the client mesh's design (``sharding/clients.py``).

A :class:`ShardedTree` holds one tree per coordinate of a
:class:`~repro_torch.launch.mesh.DeviceMesh` (row-major), each leaf the
block its spec (``sharding/specs.py``) gives that coordinate, on the
coordinate's device.  With more than one coordinate every block owns
its storage (a copy, never a view into the whole), so code that holds
on shards of one card holds on separate cards too; a leaf replicated
over an axis is one copy per coordinate.  Non-tensor leaves (a cache's
``pos``) are the same value on every coordinate.

No process group is involved.  Every copy between coordinates goes
device to device and is reported to ``clients.collectives`` under the
reference's collective names — ``"scatter"`` (:func:`shard_tree`),
``"all-gather"`` (blocks brought together), ``"all-reduce"`` (partial
sums, added in shard order) — with the logical count: a block that
moves between two coordinates counts whether or not they share a card.
"""
from __future__ import annotations

import dataclasses
import itertools
import math
from collections.abc import Sequence
from typing import Any

import torch

from repro_torch.utils.pytree import tree_leaves, tree_map

from .clients import collectives


@dataclasses.dataclass(frozen=True)
class ShardedTree:
    """``blocks[i]`` is the tree of the mesh's i-th coordinate
    (row-major); ``specs`` the spec tree they were cut by."""

    blocks: tuple
    specs: Any
    mesh: Any

    def at(self, coord):
        """The tree that ``coord`` holds."""
        return self.blocks[self.mesh.index(coord)]


def report_copies(kind: str, tensors) -> None:
    """Tell ``collectives``' listeners of one copy of each tensor."""
    collectives.add(kind, [t for t in tensors
                           if isinstance(t, torch.Tensor)])


def _axes(entry) -> tuple:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def _entries(spec, ndim) -> list:
    spec = tuple(spec)
    if len(spec) > ndim:
        raise ValueError(f"spec {spec} has more entries than {ndim} dims")
    return list(spec) + [None] * (ndim - len(spec))


def _split_axes(entry, keep) -> tuple:
    """The axes of one spec entry that cut the dim here: all of them but
    those in ``keep`` (along which the tensor at hand is already a
    block); an entry mixing both is not taken."""
    axes = _axes(entry)
    cut = tuple(a for a in axes if a not in keep)
    if cut and len(cut) != len(axes):
        raise ValueError(f"spec entry {entry} mixes kept axes {keep} with "
                         "others")
    return cut


def _position(axes, mesh, coord) -> tuple[int, int]:
    """(index, count) of ``coord``'s block along a dim cut over ``axes``
    (row-major over them)."""
    names = list(mesh.axis_names)
    i, n = 0, 1
    for a in axes:
        size = mesh.shape[a]
        i = i * size + coord[names.index(a)]
        n *= size
    return i, n


def block_slices(shape, spec, mesh, coord, keep=()) -> tuple:
    """The slices of a tensor of ``shape`` — whole along every mesh axis
    but those in ``keep`` — that ``coord`` holds under ``spec``."""
    out = []
    for d, entry in enumerate(_entries(spec, len(shape))):
        axes = _split_axes(entry, keep)
        if not axes:
            out.append(slice(None))
            continue
        i, n = _position(axes, mesh, coord)
        if shape[d] % n:
            raise ValueError(f"dim {d} of {tuple(shape)} does not split "
                             f"into {n} blocks over {axes}")
        b = shape[d] // n
        out.append(slice(i * b, (i + 1) * b))
    return tuple(out)


def cut_leaf(x, spec, mesh, coord, keep=()):
    """``coord``'s block of ``x`` (whole but along ``keep``), a copy on
    the coordinate's device; a non-tensor leaf as it is."""
    if not isinstance(x, torch.Tensor):
        return x
    block = x[block_slices(x.shape, spec, mesh, coord, keep)]
    return block.to(mesh.device(coord), copy=mesh.size > 1)


def shard_tree(tree, specs, mesh) -> ShardedTree:
    """Cut every leaf of ``tree`` by its spec: one tree per coordinate,
    each block a copy on its coordinate's device (with one coordinate,
    the tree itself moved there)."""
    coords = mesh.coords()
    blocks = tuple(tree_map(lambda x, s, c=c: cut_leaf(x, s, mesh, c),
                            tree, specs) for c in coords)
    report_copies("scatter", [x for b in blocks[1:] for x in tree_leaves(b)])
    return ShardedTree(blocks, specs, mesh)


def gather_leaf(blocks, spec, mesh, at, keep=(), device=None):
    """The leaf whose blocks (one per coordinate, row-major) are
    ``blocks``, put together on ``device`` (default: ``at``'s) — whole
    along every axis but those in ``keep``, along which it stays the
    block of ``at``.  Each block is taken from ``at``'s own replica: the
    coordinate equal to ``at`` but on the axes that cut the leaf."""
    here = blocks[mesh.index(at)]
    device = torch.device(device) if device is not None else mesh.device(at)
    if not isinstance(here, torch.Tensor):
        return here
    entries = _entries(spec, here.dim())
    cut = [_split_axes(e, keep) for e in entries]
    axes = list(dict.fromkeys(a for c in cut for a in c))
    if not axes:
        return here.to(device)
    names = list(mesh.axis_names)
    full = [n * _position(c, mesh, at)[1] if c else n
            for n, c in zip(here.shape, cut, strict=True)]
    out = torch.empty(full, dtype=here.dtype, device=device)
    moved = []
    for combo in itertools.product(*(range(mesh.shape[a]) for a in axes)):
        src = list(at)
        for a, i in zip(axes, combo, strict=True):
            src[names.index(a)] = i
        src = tuple(src)
        block = blocks[mesh.index(src)]
        dst = []
        for n, c in zip(here.shape, cut, strict=True):
            i = _position(c, mesh, src)[0] if c else 0
            dst.append(slice(i * n, (i + 1) * n) if c else slice(None))
        out[tuple(dst)].copy_(block, non_blocking=True)
        if src != tuple(at):
            moved.append(block)
    report_copies("all-gather", moved)
    return out


def gather_tree(sharded: ShardedTree, device=None, at=None, keep=()):
    """The whole tree, put together on ``device`` (default: the device
    of ``at``, the first coordinate unless given); with ``keep``, whole
    along every axis but those, along which it is ``at``'s block (a data
    shard's cache, say)."""
    mesh = sharded.mesh
    at = tuple(at) if at is not None else mesh.coords()[0]
    leaves = [tree_leaves(b) for b in sharded.blocks]
    specs = tree_leaves(sharded.specs)
    whole = [gather_leaf([ls[k] for ls in leaves], s, mesh, at, keep=keep,
                         device=device) for k, s in enumerate(specs)]
    it = iter(whole)
    return tree_map(lambda _: next(it), sharded.blocks[0])


def put_blocks(sharded: ShardedTree, local, coords, at, keep=()) -> None:
    """The inverse of :func:`gather_tree` with ``keep``: each of
    ``coords``' blocks overwritten in place with its slices of
    ``local`` (whole along every axis but ``keep``, held at ``at``);
    non-tensor leaves replaced."""
    mesh = sharded.mesh
    specs = tree_leaves(sharded.specs)
    for c in coords:
        i = mesh.index(c)
        moved = []

        def put(block, x, s, c=c):
            if not isinstance(x, torch.Tensor):
                return x
            part = x[block_slices(x.shape, s, mesh, c, keep)]
            block.copy_(part, non_blocking=True)
            moved.append(part)
            return block

        it = iter(specs)
        sharded.blocks[i].update(tree_map(
            lambda b, x: put(b, x, next(it)), sharded.blocks[i], local))
        if tuple(c) != tuple(at):
            report_copies("scatter", moved)


def _spec_parts(spec, mesh) -> int:
    return math.prod(mesh.shape[a] for e in spec for a in _axes(e))


def per_device_bytes(shapes, specs, mesh) -> int:
    """The bytes one coordinate of ``mesh`` holds of a tree of these
    ``shapes`` (meta tensors will do) cut by ``specs``, computed from
    shapes alone: every coordinate holds as many (the blocks split
    evenly).  Only ``mesh.shape`` is read."""
    total = 0
    for x, s in zip(tree_leaves(shapes), tree_leaves(specs), strict=True):
        if isinstance(x, torch.Tensor):
            total += x.numel() * x.element_size() // _spec_parts(s, mesh)
    return total


def tree_bytes_at(sharded: ShardedTree, coord) -> int:
    """The bytes of the tensors ``coord`` holds."""
    return sum(x.numel() * x.element_size()
               for x in tree_leaves(sharded.at(coord))
               if isinstance(x, torch.Tensor))


# ----------------------------------------------------------------------
# collectives over one group of coordinates
# ----------------------------------------------------------------------


def _sum_in_order(parts, device, dtype):
    """Σ of ``parts`` added in order on ``device`` (bf16 parts in fp32),
    rounded once to ``dtype``."""
    total = parts[0].to(device, non_blocking=True)
    total = total.to(torch.promote_types(total.dtype, torch.float32))
    for p in parts[1:]:
        total = total + p.to(device, non_blocking=True)
    return total.to(dtype)


def _wants_grad(parts) -> bool:
    return torch.is_grad_enabled() and any(p.requires_grad for p in parts)


def _all_reduce(parts, devices, dtype):
    total = _sum_in_order(parts, parts[0].device, dtype)
    out = [total.to(d, non_blocking=True) for d in devices]
    report_copies("all-reduce", list(parts[1:]) + out[1:])
    return out


class _AllReduce(torch.autograd.Function):
    """Backward: the replicas' gradients added in shard order, the sum
    sent to each partial's device in the partial's dtype
    (``"all-reduce"``)."""

    @staticmethod
    def forward(ctx, devices, dtype, *parts):
        # the mesh's devices, which the parts lie on
        ctx.like = [(d, p.dtype) for d, p in zip(devices, parts,
                                                  strict=True)]
        out = _all_reduce(parts, devices, dtype)
        # a shared device's copies are one tensor: give each its own
        return tuple(x if i == 0 else x.view_as(x)
                     for i, x in enumerate(out))

    @staticmethod
    def backward(ctx, *grads):
        dev0, dt0 = ctx.like[0]
        total = _sum_in_order([g for g in grads if g is not None], dev0,
                              torch.float32)
        out = [total.to(d, dt, non_blocking=True) for d, dt in ctx.like]
        report_copies("all-reduce", [g for g in grads[1:] if g is not None]
                      + out[1:])
        return (None, None, *out)


def all_reduce(parts, devices, dtype=None) -> list:
    """Σ of per-shard partials of one shape, added in shard order on the
    first shard's device (as ``core.engine.all_sum``; bf16 partials in
    fp32), rounded once to ``dtype`` (default: the partials'), then one
    copy on each shard's device (on a shared device, the same tensor).
    Under autograd a function (:class:`_AllReduce`) whose backward is
    an all-reduce too."""
    dtype = dtype or parts[0].dtype
    if _wants_grad(parts):
        return list(_AllReduce.apply(tuple(devices), dtype, *parts))
    return _all_reduce(parts, devices, dtype)


def _all_gather(parts, dim, devices):
    made = {}
    out = []
    for j, d in enumerate(devices):
        if d not in made:
            made[d] = torch.cat([p.to(d, non_blocking=True)
                                 for p in parts], dim)
        out.append(made[d])
        report_copies("all-gather", [p for k, p in enumerate(parts) if k != j])
    return out


class _AllGather(torch.autograd.Function):
    """Backward: each shard's block of the replicas' gradients, added
    in shard order in fp32 on the shard's device and rounded once to
    the block's dtype (``"reduce-scatter"``)."""

    @staticmethod
    def forward(ctx, dim, devices, homes, *parts):
        ctx.dim = dim
        ctx.like = [(d, p.dtype, p.shape[dim])
                    for d, p in zip(homes, parts, strict=True)]
        out = _all_gather(parts, dim, devices)
        seen = set()
        res = []
        for x in out:
            res.append(x.view_as(x) if id(x) in seen else x)
            seen.add(id(x))
        return tuple(res)

    @staticmethod
    def backward(ctx, *grads):
        grads = [g for g in grads if g is not None]
        out, moved, start = [], [], 0
        for j, (dev, dt, n) in enumerate(ctx.like):
            blocks = [g.narrow(ctx.dim, start, n) for g in grads]
            start += n
            out.append(_sum_in_order(blocks, dev, dt))
            moved += [b for k, b in enumerate(blocks) if k != j]
        report_copies("reduce-scatter", moved)
        return (None, None, None, *out)


def all_gather(parts, dim, devices, homes=None) -> list:
    """The per-shard blocks concatenated along ``dim`` in shard order,
    one result on each of ``devices`` (computed once per distinct
    device).  Under autograd a function (:class:`_AllGather`) whose
    backward is a reduce-scatter onto ``homes``, the devices the parts
    lie on (default: ``devices``)."""
    if _wants_grad(parts):
        return list(_AllGather.apply(dim, tuple(devices),
                                     tuple(homes or devices), *parts))
    return _all_gather(parts, dim, devices)


# ----------------------------------------------------------------------
# the ZeRO-3 view
# ----------------------------------------------------------------------


class GatheredParams:
    """A sharded parameter tree read from one coordinate, ZeRO-3 style:
    ``params[key]`` gathers that leaf or subtree onto the coordinate's
    device when it is read, and :meth:`layers` gives the stack's
    per-layer trees, each gathered when it is indexed (the layer axis is
    never cut, so layer i is row i of every block).  With ``keep`` (the
    model axis, say) a leaf stays the coordinate's block along those
    axes and is gathered over the others only: a leaf cut over none of
    the others is the coordinate's own block, no copy made."""

    def __init__(self, sharded: ShardedTree, coord, keep=()):
        self.sharded = sharded
        self.coord = tuple(coord)
        self.device = sharded.mesh.device(coord)
        self.keep = tuple(keep)

    def _gather(self, pick):
        sh = self.sharded
        leaves = [tree_leaves(pick(b)) for b in sh.blocks]
        specs = tree_leaves(pick(sh.specs))
        whole = [gather_leaf([ls[k] for ls in leaves], s, sh.mesh,
                             self.coord, keep=self.keep)
                 for k, s in enumerate(specs)]
        it = iter(whole)
        return tree_map(lambda _: next(it), pick(sh.blocks[0]))

    def __contains__(self, key) -> bool:
        return key in self.sharded.blocks[0]

    def __getitem__(self, key):
        return self._gather(lambda t: t[key])

    def layer(self, i: int):
        """Layer ``i``'s tree, gathered."""
        sh = self.sharded
        leaves = [tree_leaves(b["layers"]) for b in sh.blocks]
        specs = tree_leaves(sh.specs["layers"])
        whole = []
        for k, s in enumerate(specs):
            if s and s[0] is not None:
                raise ValueError(f"the layer axis is cut ({s}); it never "
                                 "is under the sharding rules")
            whole.append(gather_leaf([ls[k][i] for ls in leaves],
                                     tuple(s)[1:], sh.mesh, self.coord,
                                     keep=self.keep))
        it = iter(whole)
        return tree_map(lambda _: next(it), sh.blocks[0]["layers"])

    def layers(self, n: int) -> "_Layers":
        return _Layers(self, n)


class _Layers(Sequence):
    """The stack's layers, each gathered when it is indexed."""

    def __init__(self, params: GatheredParams, n: int):
        self.params, self.n = params, n

    def __len__(self) -> int:
        return self.n

    def __getitem__(self, i):
        if not -self.n <= i < self.n:
            raise IndexError(i)
        return self.params.layer(i % self.n)

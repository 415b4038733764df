"""Sharding rules: parameter-tree path → spec (port of
``repro/sharding/specs.py``).

A spec is a tuple with one entry per dimension of a leaf: ``None``
(that dimension is whole on every coordinate), a mesh axis name, or a
tuple of axis names (the dimension cut over their product, row-major).
Element by element it is the reference's ``PartitionSpec``; ``()`` is
its ``P()``.  Every function is pure: it reads the leaves' shapes (meta
tensors from ``models.api.abstract_params`` do) and ``mesh.shape``, so
a :class:`~repro_torch.launch.mesh.DeviceMesh` or anything with that
mapping will do.  Placement on the mesh is ``sharding/params.py``'s.

Four modes:

* ``fsdp`` (the reference's default) — every ≥2-D parameter is sharded
  over the ``model`` axis on its largest divisible dim and over
  ``data`` on the next largest divisible dim (ZeRO-3 style; the port
  gathers each layer's blocks right before the layer runs).  Robust for
  any architecture, memory-optimal, collective-heavy at decode.
* ``tp`` — Megatron-style named rules: attention heads / FFN hidden /
  MoE experts over ``model``; params *replicated* over ``data``.
  Weight-collective-free at decode.
* ``fsdp_tp`` — the named ``model`` rules plus ``data`` sharding on the
  largest remaining divisible dim.
* ``ep`` — as ``fsdp_tp``, with the MoE experts' own axis over
  ``model`` where it divides.

The leading layer axis of the stacks is never sharded (a sharded layer
axis would reshard every layer).

GQA caveat: when a k/v projection's output dim does not divide
|model|, wk/wv fall back to their input dim — row-parallel (phi3 kv=10,
paligemma kv=1 on a mesh whose model axis does not divide kv·head_dim).
"""
from __future__ import annotations

import math

from repro_torch.utils.pytree import tree_map

MODES = ("fsdp", "tp", "fsdp_tp", "ep")

# parameter leaves that live under these names form the stacks
_STACKED_CONTAINERS = ("layers",)

# TP named rules: leaf name → model-sharded dim within the logical
# param shape (after any layer axis)
_TP_RULES = {
    # attention: shard head (output) dim of qkv, input dim of wo
    "wq": 1, "wk": 1, "wv": 1, "wo": 0,
    # dense mlp: hidden dim
    "w_gate": 1, "w_up": 1, "w_down": 0,
    # embeddings: vocab dim
    "embed": 0, "lm_head": 1,
    # ssm: inner dim
    "in_proj": 1, "out_proj": 0,
}
# under "moe", experts are stacked: (E, d, f) — shard E (expert parallel)
_TP_MOE_DIM = 0


def _divisible(shape, dim, size):
    return dim < len(shape) and shape[dim] % size == 0 and shape[dim] >= size


def _fsdp_spec(shape, skip, data, model, data_size, model_size):
    """Largest-divisible-dims rule; `skip` dims stay unsharded."""
    spec = [None] * len(shape)
    order = sorted((d for d in range(len(shape)) if d not in skip),
                   key=lambda d: -shape[d])
    for d in order:
        if model and spec[d] is None and shape[d] % model_size == 0 \
                and shape[d] >= model_size:
            spec[d] = model
            model = None
        elif data and spec[d] is None and shape[d] % data_size == 0 \
                and shape[d] >= data_size:
            spec[d] = data
            data = None
    return spec


def _map_with_path(fn, tree, path=()):
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, tree[k], path + (k,))
                for k in sorted(tree)}
    return fn(path, tree)


def param_specs(params_shape, mesh, *, mode="fsdp", data_axis="data",
                model_axis="model", pod_axis=None):
    """The spec tree of ``params_shape`` (a tree of tensors or anything
    with ``.shape``).  ``pod_axis`` is accepted and unused, as in the
    reference."""
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}; the modes are "
                         f"{', '.join(MODES)}")
    data_size = mesh.shape[data_axis]
    model_size = mesh.shape[model_axis]

    def leaf_spec(names, leaf):
        shape = tuple(leaf.shape)
        if not shape or all(s == 1 for s in shape):
            return ()
        stacked = any(c in names for c in _STACKED_CONTAINERS)
        off = 1 if stacked else 0
        skip = set(range(off))
        is_moe = "moe" in names
        name = names[-1] if names else ""
        if len(shape) - off < 2 and name not in ("embed", "lm_head"):
            return ()  # norms / small vectors: replicate

        if name in ("embed", "lm_head"):
            # Output-dim rule: shard the embedding on d (the token
            # lookup stays local) and the head on vocab (vocab-parallel
            # logits).  The contraction/lookup dims stay unsharded in
            # every mode.
            spec = [None] * len(shape)
            if _divisible(shape, len(shape) - 1, model_size):
                spec[-1] = model_axis
            return tuple(spec)

        if mode == "fsdp":
            return tuple(_fsdp_spec(shape, skip, data_axis, model_axis,
                                    data_size, model_size))

        # named model rules (tp / fsdp_tp / ep)
        spec = [None] * len(shape)
        mdim = None
        if is_moe and name in ("w_gate", "w_up", "w_down"):
            # Output-dim-only sharding: gate/up (E, d, f) shard f, down
            # (E, f, d) shard d — the LAST dim in both cases, never a
            # contraction dim, so no partial-sum all-reduces of capacity
            # buffers.  The data axis ZeRO-shards the expert dim E when
            # divisible; mode "ep" shards E over model instead.
            if mode == "ep" and _divisible(shape, off + _TP_MOE_DIM,
                                           model_size):
                mdim = off + _TP_MOE_DIM
            else:
                mdim = len(shape) - 1
            if _divisible(shape, mdim, model_size):
                spec[mdim] = model_axis
            if mode in ("fsdp_tp", "ep") and spec[off] is None and \
                    _divisible(shape, off, data_size):
                spec[off] = data_axis
            return tuple(spec)
        if name in _TP_RULES:
            mdim = off + _TP_RULES[name]
        if mdim is not None and _divisible(shape, mdim, model_size):
            spec[mdim] = model_axis
        elif mdim is not None:
            # fall back: try the other matmul dim (e.g. kv heads < |model|)
            alt = off + (1 - _TP_RULES.get(name, 0)) if not is_moe else None
            if alt is not None and _divisible(shape, alt, model_size):
                spec[alt] = model_axis
        if mode == "fsdp_tp":
            taken = {d for d, s in enumerate(spec) if s} | skip
            order = sorted((d for d in range(len(shape)) if d not in taken),
                           key=lambda d: -shape[d])
            for d in order:
                if shape[d] % data_size == 0 and shape[d] >= data_size:
                    spec[d] = data_axis
                    break
        return tuple(spec)

    return _map_with_path(leaf_spec, params_shape)


def pod_stacked_specs(specs, pod_axis="pod"):
    """Prefix every spec with the pod axis (pod-stacked state)."""
    return tree_map(lambda s: (pod_axis,) + tuple(s), specs)


def batch_specs(batch_shape, *, batch_axes):
    """Shard the leading (batch) dim of every input leaf over
    ``batch_axes`` (an axis name or a tuple of them, e.g. ("pod",
    "data")); the rest whole; a 0-d leaf replicated."""
    def leaf_spec(leaf):
        shape = tuple(leaf.shape)
        return (batch_axes,) + (None,) * (len(shape) - 1) if shape else ()

    return tree_map(leaf_spec, batch_shape)


def cache_specs(cache_shape, mesh, *, batch_axes, model_axis="model"):
    """KV/SSM cache sharding: the batch dim over ``batch_axes``, the
    first later dim that divides |model| over ``model``.  Cache layout:
    leading layer axis, then batch.  Scalars (``pos``, a host int in the
    port) replicated."""
    axes = batch_axes if isinstance(batch_axes, tuple) else (batch_axes,)
    sizes = math.prod(mesh.shape[a] for a in axes)
    model_size = mesh.shape[model_axis]

    def leaf_spec(leaf):
        shape = tuple(getattr(leaf, "shape", ()))
        if len(shape) <= 1:
            return ()
        # (L, B, ...) — shard B if divisible, plus a heads-like dim
        spec = [None] * len(shape)
        if shape[1] % sizes == 0 and shape[1] >= sizes:
            spec[1] = batch_axes
        for d in range(2, len(shape)):
            if shape[d] % model_size == 0 and shape[d] >= model_size:
                spec[d] = model_axis
                break
        return tuple(spec)

    return tree_map(leaf_spec, cache_shape)

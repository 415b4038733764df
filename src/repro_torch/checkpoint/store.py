"""Pytree checkpoints in the JAX package's npz format
(port of ``repro/checkpoint/store.py``).

A file holds one npz entry per leaf, keyed by the leaf's path — ``a:``
for a NamedTuple field, ``d:`` for a dict key, ``s:`` for a sequence
index, joined by ``/`` (``a:theta``, ``a:ctrl/a:delta``,
``a:inflight/a:hist``, ``a:comm``, ``a:theta/d:w`` on the tree layout) —
in the reference's flatten order (NamedTuple fields in order, dict keys
sorted, None holding no leaf), and two JSON sidecars: ``__treedef__``,
the string ``str(jax.tree_util.tree_structure(tree))`` prints for the
same tree (built here by :func:`treedef_str`), and ``__dtypes__``, each
leaf's dtype name.  So a checkpoint of the port resumes in the JAX
package and one of the JAX package resumes here.

The port's state is written in the reference's form: the threefry key,
which the port holds as two int64 words (``repro_torch.prng``), as
two ``uint32`` words; counters are ``int32`` and the staleness ring
``bool`` in both packages.  A bf16 leaf, which numpy cannot hold
without ``ml_dtypes``, is written as its ``int16`` bytes with
``bfloat16`` in the sidecar (the reference re-views such bytes by the
sidecar); on reading, ``V2`` or ``int16`` bytes whose sidecar says
``bfloat16`` come back as ``torch.bfloat16``.  A client mesh's shard
list is written unsharded (``convert.state_to_numpy``) and, given a
sharded template, read back into its shards
(``convert.state_from_numpy(mesh=)``).  A host-offloaded state
(``core.state.HostState``) is written as its
``to_checkpoint_tree()``, the matrices straight from host memory, so it
resumes on the device backend and the reverse; given a ``HostState``
template, the file comes back as a ``HostState``.

:func:`load_checkpoint` refuses what the reference refuses: another
treedef (naming both strings), a missing leaf (``KeyError``), another
shape; it casts only within a kind — float to float (bf16 ↔ fp32
included), signed to signed, unsigned to unsigned.  Leaves come back in
the template's dtypes, on its devices.  Writes are atomic (a temporary
file, then a rename) to ``<prefix>_<step:08d>.npz``.
"""
from __future__ import annotations

import json
import os
import re
import tempfile

import numpy as np
import torch

_SEP = "/"
_META_KEYS = ("__treedef__", "__dtypes__")


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _is_shard_list(tree) -> bool:
    from repro_torch.core.state import FLState

    return (isinstance(tree, (tuple, list)) and not _is_namedtuple(tree)
            and len(tree) > 0 and all(isinstance(s, FLState) for s in tree))


def _children(node):
    """(path part, child) pairs of a container node in flatten order."""
    if _is_namedtuple(node):
        return [(f"a:{f}", getattr(node, f)) for f in node._fields]
    if isinstance(node, dict):
        return [(f"d:{k}", node[k]) for k in sorted(node)]
    return [(f"s:{i}", c) for i, c in enumerate(node)]


def _is_container(node) -> bool:
    return isinstance(node, (tuple, list, dict))


def _leaves_with_paths(tree, prefix=()):
    """(path, leaf) in the reference's flatten order; None has none."""
    if tree is None:
        return
    if not _is_container(tree):
        yield prefix, tree
        return
    for part, child in _children(tree):
        yield from _leaves_with_paths(child, prefix + (part,))


def treedef_str(tree) -> str:
    """``str(jax.tree_util.tree_structure(tree))`` for a tree of
    NamedTuples, dicts, lists, tuples, None and leaves."""
    def node(x):
        if x is None:
            return "None"
        if _is_namedtuple(x):
            inner = ", ".join(node(getattr(x, f)) for f in x._fields)
            return f"CustomNode(namedtuple[{type(x).__name__}], [{inner}])"
        if isinstance(x, dict):
            return "{" + ", ".join(f"{k!r}: {node(x[k])}"
                                   for k in sorted(x)) + "}"
        if isinstance(x, list):
            return "[" + ", ".join(node(c) for c in x) + "]"
        if isinstance(x, tuple):
            inner = ", ".join(node(c) for c in x)
            return f"({inner},)" if len(x) == 1 else f"({inner})"
        return "*"
    return f"PyTreeDef({node(tree)})"


def _is_key(path) -> bool:
    """The threefry key of an FLState or ScaffoldState (the ``rng``
    field), held by the port as int64 words."""
    return path[-1:] == ("a:rng",)


def _to_array(path, leaf) -> tuple[np.ndarray, str]:
    """(the array written, the dtype name in the sidecar)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy(), "bfloat16"
        arr = t.numpy()
    else:
        arr = np.asarray(leaf)
    if _is_key(path) and arr.dtype == np.int64:
        arr = arr.astype(np.uint32)
    return arr, str(arr.dtype)


def _host_form(tree):
    """A client mesh's shard list → the unsharded state (numpy leaves);
    a ``HostState`` → its checkpoint tree; anything else as it is."""
    if hasattr(tree, "to_checkpoint_tree"):
        return tree.to_checkpoint_tree()
    if _is_shard_list(tree):
        from repro_torch.convert import state_to_numpy

        return state_to_numpy(tree)
    return tree


def _json_blob(obj) -> np.ndarray:
    return np.frombuffer(json.dumps(obj).encode(), dtype=np.uint8)


def _read_blob(arr) -> object:
    return json.loads(np.asarray(arr).tobytes().decode())


def save_checkpoint(directory: str, step: int, tree, *,
                    prefix: str = "ckpt") -> str:
    """Write ``tree`` to ``<directory>/<prefix>_<step:08d>.npz``
    atomically; returns the path."""
    os.makedirs(directory, exist_ok=True)
    tree = _host_form(tree)
    flat, dtypes = {}, {}
    for path, leaf in _leaves_with_paths(tree):
        key = _SEP.join(path)
        flat[key], dtypes[key] = _to_array(path, leaf)
    path = os.path.join(directory, f"{prefix}_{step:08d}.npz")
    fd, tmp = tempfile.mkstemp(dir=directory, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, __treedef__=_json_blob(treedef_str(tree)),
                     __dtypes__=_json_blob(dtypes), **flat)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return path


_KINDS = (("float", ("float16", "float32", "float64", "bfloat16")),
          ("signed", ("int8", "int16", "int32", "int64")),
          ("unsigned", ("uint8", "uint16", "uint32", "uint64")))


def _kind(name: str) -> str | None:
    for kind, names in _KINDS:
        if name in names:
            return kind
    return None


def _dtype_name(x) -> str:
    if isinstance(x, torch.Tensor):
        return str(x.dtype).removeprefix("torch.")
    return str(np.asarray(x).dtype)


def _as_tensor(arr: np.ndarray, stored: str) -> torch.Tensor:
    """The stored bytes as a CPU tensor of the stored dtype."""
    if stored == "bfloat16":
        return torch.from_numpy(np.array(arr).view(
            np.int16)).view(torch.bfloat16)
    if stored in ("uint16", "uint32", "uint64"):  # widened exactly
        return torch.from_numpy(arr.astype(np.int64))
    return torch.from_numpy(np.array(arr))


def _restore(key, path, arr, stored, leaf):
    """One leaf of the checkpoint in the template ``leaf``'s dtype, on
    its device (or as numpy for a numpy template)."""
    want = _dtype_name(leaf)
    want_ref = "uint32" if _is_key(path) and want == "int64" else want
    if stored != want_ref and (_kind(stored) is None
                               or _kind(stored) != _kind(want_ref)):
        raise ValueError(
            f"incompatible dtype for {key}: checkpoint {stored} cannot "
            f"restore into a {want_ref} leaf (only floating→floating and "
            "matching-signedness integer casts are allowed)")
    t = _as_tensor(arr, stored)
    if isinstance(leaf, torch.Tensor):
        return t.to(dtype=leaf.dtype).to(leaf.device)
    if want == "bfloat16":
        raise ValueError(f"{key}: a bf16 leaf needs a tensor template")
    return t.numpy().astype(want)


def _rebuild(template, leaves, prefix=()):
    """``template``'s structure with its leaves taken from ``leaves``
    (a dict keyed by path)."""
    if template is None:
        return None
    if not _is_container(template):
        return leaves[prefix]
    kids = {part: _rebuild(c, leaves, prefix + (part,))
            for part, c in _children(template)}
    if _is_namedtuple(template):
        return type(template)(*(kids[f"a:{f}"] for f in template._fields))
    if isinstance(template, dict):
        return {k: kids[f"d:{k}"] for k in template}
    return type(template)(kids[f"s:{i}"] for i in range(len(template)))


def load_checkpoint(path: str, like):
    """Read the checkpoint at ``path`` into the structure of ``like`` (a
    template: an ``FLState``, a client mesh's shard list, a
    ``HostState``, a ``ScaffoldState`` or a dict of tensors or arrays),
    each leaf cast to the template leaf's dtype within its kind and
    placed on its device (a ``HostState``'s matrices in host memory)."""
    with np.load(path) as zf:
        stored_treedef = (_read_blob(zf["__treedef__"])
                          if "__treedef__" in zf.files else None)
        stored_dtypes = (_read_blob(zf["__dtypes__"])
                         if "__dtypes__" in zf.files else {})
        flat = {k: zf[k] for k in zf.files if k not in _META_KEYS}
    sharded = _is_shard_list(like)
    template = _host_form(like)
    like_treedef = treedef_str(template)
    if stored_treedef is not None and stored_treedef != like_treedef:
        raise ValueError(
            f"checkpoint structure mismatch:\n  stored   {stored_treedef}"
            f"\n  template {like_treedef}")
    out = {}
    for leaf_path, leaf in _leaves_with_paths(template):
        key = _SEP.join(leaf_path)
        if key not in flat:
            raise KeyError(f"checkpoint missing leaf {key}")
        arr = flat[key]
        stored = stored_dtypes.get(key, str(arr.dtype))
        shape = tuple(leaf.shape) if hasattr(leaf, "shape") \
            else np.shape(leaf)
        if tuple(arr.shape) != shape:
            raise ValueError(f"shape mismatch for {key}: ckpt "
                             f"{arr.shape} vs {shape}")
        out[leaf_path] = _restore(key, leaf_path, arr, stored, leaf)
    restored = _rebuild(template, out)
    if hasattr(like, "to_checkpoint_tree"):
        from repro_torch.core.hoststate import _host_state_of

        return _host_state_of(restored, like.omega.device)
    if sharded:
        from repro_torch.convert import state_from_numpy
        from repro_torch.sharding import ClientMesh

        return state_from_numpy(restored, mesh=ClientMesh(tuple(
            s.rng.device for s in like)))
    return restored


def latest_checkpoint(directory: str, *, prefix: str = "ckpt") -> str | None:
    """The path of the highest-step ``<prefix>_<step>.npz`` in
    ``directory``, or None."""
    if not os.path.isdir(directory):
        return None
    pat = re.compile(rf"{re.escape(prefix)}_(\d+)\.npz$")
    best, best_step = None, -1
    for name in os.listdir(directory):
        m = pat.match(name)
        if m and int(m.group(1)) > best_step:
            best, best_step = os.path.join(directory, name), int(m.group(1))
    return best

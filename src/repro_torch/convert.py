"""Carry weights and round state across from the JAX package.

The JAX package hands its values over as numpy arrays (``np.asarray`` /
``jax.device_get`` of its pytrees); nothing here imports JAX.  Tensors
go to ``device``: CUDA unless the caller passes another.

* :func:`params_from_numpy` — a params pytree (nested dict of arrays)
  → the port's state dict (dotted keys, e.g. ``fc1.w``), which
  ``models.MLP.load_state_dict`` takes;
* :func:`state_from_numpy` — a fetched JAX ``FLState`` → the port's
  ``FLState`` (θ/λ/z_prev/ω, controller, deferral queue, the delay
  pipeline where the state has one, the rng key's two uint32 words, the
  round, the compressed consensus's residual where the state has one),
  in either layout: (N, D) matrices or nested dicts of stacked leaves;
  with ``mesh=`` the shard list of a client mesh; with ``runs=True`` a
  sweep's state stacked over runs (``launch/sweep.py``: a leading
  (R, ...) axis on every leaf, the client axis second);
* :func:`state_to_numpy` — the other way, as the port's ``FLState``
  with numpy leaves, for comparisons (a shard list is put together, a
  ``HostState`` read through its checkpoint tree);
* :func:`host_state_from_numpy` — the JAX package's ``HostState`` (or
  its checkpoint tree) → the port's ``HostState``, the matrices in host
  memory;
* :func:`flat_state` — a tree-layout state → the flat one, through a
  ``FlatSpec`` (the same numbers, for holding one layout against the
  other);
* :func:`scaffold_state_from_numpy` / :func:`scaffold_state_to_numpy` —
  a fetched JAX ``ScaffoldState`` (pytrees of the params' shape) ⇄ the
  port's, flat through a ``FlatSpec`` or kept as trees without one;
* :func:`lm_params_from_numpy` — the model zoo's parameter tree, of any
  family, → the port's (the same layout: stacked (L, ...) layers, JAX's
  (n_in, n_out) weights); with ``mesh=`` and ``specs=`` straight into a
  tree sharded on a model mesh;
* :func:`lm_cache_from_numpy` — a serving cache (K/V and/or SSM states)
  → the port's;
* :func:`cross_pod_state_from_numpy` / :func:`cross_pod_state_to_numpy`
  — a fetched JAX ``CrossPodState`` ⇄ the port's (pod-stacked trees in
  the reference's layout; with ``mesh=`` a shard list).

bf16 arrays (JAX hands them over as ``ml_dtypes`` arrays, which this
module reads through their bits without importing that package) become
bf16 tensors; going back, bf16 leaves come out as fp32 arrays, which
hold every bf16 value exactly.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.baselines import ScaffoldState
from repro_torch.core.controller import ControllerState
from repro_torch.core.state import CLIENT_STACKED_FIELDS, \
    CTRL_STACKED_FIELDS, DeferQueue, FLState, InFlight
from repro_torch.device import resolve_device
from repro_torch.sharding.clients import check_divisible
from repro_torch.utils.pytree import tree_leaves, tree_map


def params_from_numpy(tree, device=None) -> dict:
    """Nested dict of arrays → {dotted key: tensor of the array's dtype}
    on ``device``."""
    device = resolve_device(device)
    out = {}

    def walk(node, prefix):
        for k in sorted(node):
            v = node[k]
            if isinstance(v, dict):
                walk(v, f"{prefix}{k}.")
            else:
                out[f"{prefix}{k}"] = torch.from_numpy(np.array(v)).to(device)

    walk(tree, "")
    return out


def lm_params_from_numpy(tree, cfg, device=None, *, mesh=None,
                         specs=None):
    """The JAX package's params of any family (numpy leaves) → the port's:
    the same nested dict, every leaf a tensor of its shape and dtype,
    ``layers`` stacked along L.  With ``mesh=`` (a
    ``launch.mesh.DeviceMesh``) and ``specs=`` (``sharding.specs``'
    ``param_specs`` of the tree): a ``sharding.params.ShardedTree``,
    each coordinate's blocks on its device."""
    from repro_torch.models.transformer import check_family
    from repro_torch.sharding.params import shard_tree

    check_family(cfg)
    n = np.asarray(tree_leaves(tree["layers"])[0]).shape[0]
    if n != cfg.num_layers:
        raise ValueError(f"the tree has {n} layers, the config "
                         f"{cfg.num_layers}")
    if mesh is None:
        if specs is not None:
            raise ValueError("specs= needs mesh=")
        return _tree_t(tree, resolve_device(device))
    if specs is None or device is not None:
        raise ValueError("mesh= takes specs= and no device=")
    return shard_tree(_tree_t(tree, torch.device("cpu")), specs, mesh)


def lm_cache_from_numpy(cache, device=None) -> dict:
    """A serving cache with numpy leaves → the port's cache (same stacked
    layout; ``pos`` as a host int).  An ssm cache has no ``k``/``v``, a
    dense, moe or vlm one no ``layers``."""
    device = resolve_device(device)
    out = {k: _t(cache[k], device) for k in ("k", "v") if k in cache}
    out["pos"] = int(np.asarray(cache["pos"]))
    if "layers" in cache:
        out["layers"] = {k: _t(v, device)
                         for k, v in cache["layers"].items()}
    return out


def cross_pod_state_from_numpy(s, device=None, mesh=None):
    """A JAX ``CrossPodState`` with numpy-convertible leaves → the
    port's ``CrossPodState`` on ``device``: θ, λ, z_prev as pod-stacked
    (P, ...) trees of the leaves' dtypes, the controller, the rng key's
    two words and the round.  With ``mesh`` (a ``ClientMesh`` over the
    pods) the shard list: shard i holds pods [i·P/S, (i+1)·P/S) on
    ``mesh.devices[i]`` and its own copy of the key and the round."""
    from repro_torch.core.crosspod import CrossPodState
    from repro_torch.sharding.clients import shard_rows

    def on(dev):
        return CrossPodState(
            theta=_tree_t(s.theta, dev), lam=_tree_t(s.lam, dev),
            z_prev=_tree_t(s.z_prev, dev),
            ctrl=ControllerState(*(_t(getattr(s.ctrl, f), dev)
                                   for f in ControllerState._fields)),
            rng=_rng_words(s.rng, dev), round=_t(s.round, dev))

    if mesh is None:
        return on(resolve_device(device))
    if device is not None:
        raise ValueError("pass device= or mesh=, not both")
    whole = on(torch.device("cpu"))
    rows = shard_rows({"theta": whole.theta, "lam": whole.lam,
                       "z_prev": whole.z_prev,
                       "ctrl": {f: getattr(whole.ctrl, f)
                                for f in CTRL_STACKED_FIELDS}}, mesh)
    return tuple(
        CrossPodState(theta=r["theta"], lam=r["lam"], z_prev=r["z_prev"],
                      ctrl=whole.ctrl._replace(**{
                          f: r["ctrl"][f] if f in CTRL_STACKED_FIELDS
                          else getattr(whole.ctrl, f).to(dev)
                          for f in ControllerState._fields}),
                      rng=whole.rng.to(dev), round=whole.round.to(dev))
        for r, dev in zip(rows, mesh.devices, strict=True))


def cross_pod_state_to_numpy(s):
    """The port's ``CrossPodState`` (or a shard list of them, put back
    together in shard order) with numpy leaves; bf16 leaves as fp32."""
    from repro_torch.core.crosspod import CrossPodState
    from repro_torch.sharding.clients import unshard_rows

    if isinstance(s, (list, tuple)) and not isinstance(s, CrossPodState):
        shards = tuple(s)
        s = shards[0]._replace(
            theta=unshard_rows([x.theta for x in shards]),
            lam=unshard_rows([x.lam for x in shards]),
            z_prev=unshard_rows([x.z_prev for x in shards]),
            ctrl=shards[0].ctrl._replace(**{
                f: unshard_rows([getattr(x.ctrl, f) for x in shards])
                for f in CTRL_STACKED_FIELDS}))
    return CrossPodState(
        theta=_tree_numpy(s.theta), lam=_tree_numpy(s.lam),
        z_prev=_tree_numpy(s.z_prev),
        ctrl=ControllerState(*(_tree_numpy(getattr(s.ctrl, f))
                               for f in ControllerState._fields)),
        rng=s.rng.cpu().numpy().astype(np.uint32),
        round=s.round.cpu().numpy())


def nest_params(state_dict: dict) -> dict:
    """Dotted-key state dict → the nested params dict of the engine."""
    out: dict = {}
    for key, v in state_dict.items():
        node = out
        *path, leaf = key.split(".")
        for k in path:
            node = node.setdefault(k, {})
        node[leaf] = v
    return out


def _t(a, device, dtype=None):
    a = np.array(a)
    if a.dtype.name == "bfloat16":  # ml_dtypes' bf16, read by its bits
        t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(device=device, dtype=dtype or t.dtype)


def _tree_t(node, device, dtype=None):
    """A nested dict of arrays (or one array) → the same of tensors."""
    return tree_map(lambda a: _t(a, device, dtype), node)


def _tree_numpy(node):
    def arr(t):
        t = t.detach().cpu()
        return (t.to(torch.float32) if t.dtype == torch.bfloat16
                else t).numpy()
    return tree_map(arr, node)


def state_from_numpy(s, device=None, mesh=None, *, runs: bool = False):
    """A JAX ``FLState`` with numpy-convertible leaves → the port's state
    on ``device``, fp32: the flat layout's (N, D) / (D,) arrays, or the
    tree layout's nested dicts of them.

    With ``mesh`` (a :class:`~repro_torch.sharding.ClientMesh`; no
    ``device`` then) the shard list of ``init_state(..., mesh=mesh)``:
    the leading client axis of θ, λ, z_prev, the deferral queue, the
    delay pipeline, the EF residual and the controller's δ, load and
    event count (``CLIENT_STACKED_FIELDS``,
    ``CTRL_STACKED_FIELDS``) is cut into P contiguous blocks, shard i's
    on ``mesh.devices[i]``; ω, the key and the round counters are
    copied to every shard.

    With ``runs`` the state is a sweep's, stacked over runs: the client
    axis is the second of each stacked field, and shard i holds (R, N/P,
    ...) blocks.
    """
    if mesh is None:
        return _state_on(s, resolve_device(device))
    if device is not None:
        raise ValueError("pass device= or mesh=, not both")
    axis = int(runs)
    n = np.shape(s.ctrl.delta)[axis]
    check_divisible(n, mesh)
    n_local = n // mesh.size

    def rows(i):
        def cut(x):
            return np.take(np.asarray(x), np.arange(
                i * n_local, (i + 1) * n_local), axis=axis)
        ctrl = s.ctrl._replace(**{f: cut(getattr(s.ctrl, f))
                                  for f in CTRL_STACKED_FIELDS})
        return s._replace(ctrl=ctrl, **{f: _fields_map(cut, getattr(s, f))
                                        for f in CLIENT_STACKED_FIELDS})

    return tuple(_state_on(rows(i), dev)
                 for i, dev in enumerate(mesh.devices))


def _state_on(s, device) -> FLState:
    return FLState(
        theta=_tree_t(s.theta, device, torch.float32),
        lam=_tree_t(s.lam, device, torch.float32),
        z_prev=_tree_t(s.z_prev, device, torch.float32),
        omega=_tree_t(s.omega, device, torch.float32),
        ctrl=ControllerState(
            delta=_t(s.ctrl.delta, device, torch.float32),
            load=_t(s.ctrl.load, device, torch.float32),
            round=_t(s.ctrl.round, device, torch.int32),
            event_count=_t(s.ctrl.event_count, device, torch.int32)),
        rng=_rng_words(s.rng, device),
        round=_t(s.round, device, torch.int32),
        queue=DeferQueue(age=_t(s.queue.age, device, torch.int32),
                         load=_t(s.queue.load, device, torch.float32)),
        inflight=_inflight_on(getattr(s, "inflight", None), device),
        comm=_fields_map(lambda a: _t(a, device, torch.float32),
                         getattr(s, "comm", None)),
    )


def _inflight_on(fl, device):
    if fl is None:
        return None
    return InFlight(delay=_t(fl.delay, device, torch.int32),
                    ttl=_t(fl.ttl, device, torch.int32),
                    theta=_tree_t(fl.theta, device, torch.float32),
                    lam=_tree_t(fl.lam, device, torch.float32),
                    z=_tree_t(fl.z, device, torch.float32),
                    hist=_t(fl.hist, device, torch.bool))


def state_to_numpy(s, *, runs: bool = False) -> FLState:
    """The port's state with numpy leaves (the rng as two uint32 words).
    A client mesh's shard list comes back as one state: the stacked
    fields concatenated in shard order (on the second axis of a sweep's
    state, ``runs=True``), the replicated ones taken from shard 0 after
    checking that every shard holds the same bits.  A ``HostState``
    comes back as its checkpoint tree's leaves."""
    if hasattr(s, "to_checkpoint_tree"):
        s = s.to_checkpoint_tree()
    if isinstance(s, FLState):
        return _to_numpy(s)
    shards = [_to_numpy(x) for x in s]
    first = shards[0]
    ctrl_rep = [f for f in ControllerState._fields
                if f not in CTRL_STACKED_FIELDS]
    for i, other in enumerate(shards[1:], 1):
        for name, a, b in [("omega", first.omega, other.omega),
                           ("rng", first.rng, other.rng),
                           ("round", first.round, other.round)] + [
                (f"ctrl.{f}", getattr(first.ctrl, f), getattr(other.ctrl, f))
                for f in ctrl_rep]:
            if any(x.tobytes() != y.tobytes() for x, y in zip(
                    tree_leaves(a), tree_leaves(b), strict=True)):
                raise ValueError(f"the shards' replicated {name} differ: "
                                 f"shard {i} against shard 0")

    def cat(*xs):
        return np.concatenate(xs, axis=int(runs))

    ctrl = first.ctrl._replace(**{f: cat(*(getattr(x.ctrl, f)
                                           for x in shards))
                                  for f in CTRL_STACKED_FIELDS})
    return first._replace(ctrl=ctrl, **{
        f: _fields_map(cat, *(getattr(x, f) for x in shards))
        for f in CLIENT_STACKED_FIELDS})


def _fields_map(fn, x, *rest):
    """``tree_map`` that also maps over a NamedTuple's fields (the
    deferral queue, the delay pipeline); None stays None."""
    if x is None:
        return None
    if isinstance(x, tuple):
        return type(x)(*(_fields_map(fn, *f) for f in zip(x, *rest,
                                                          strict=True)))
    return tree_map(fn, x, *rest)


def _to_numpy(s: FLState) -> FLState:
    def cpu(t):
        return t.detach().cpu().numpy()

    return FLState(
        theta=_tree_numpy(s.theta), lam=_tree_numpy(s.lam),
        z_prev=_tree_numpy(s.z_prev), omega=_tree_numpy(s.omega),
        ctrl=ControllerState(*(cpu(t) for t in s.ctrl)),
        rng=cpu(s.rng).astype(np.uint32), round=cpu(s.round),
        queue=DeferQueue(*(cpu(t) for t in s.queue)),
        inflight=_fields_map(cpu, s.inflight),
        comm=_fields_map(cpu, s.comm))


def host_state_from_numpy(s, device=None):
    """The JAX package's ``HostState`` (numpy matrices, device vectors),
    or an ``FLState``-shaped tree of its leaves, → the port's
    ``HostState``: the matrices in host memory (pinned for a CUDA
    ``device``), the vectors on ``device`` (CUDA unless another is
    passed), ``distances`` None (the next round computes it)."""
    from repro_torch.core.hoststate import _host_state_of

    tree = s.to_checkpoint_tree() if hasattr(s, "to_checkpoint_tree") else s
    return _host_state_of(tree, resolve_device(device))


def flat_state(s: FLState, spec) -> FLState:
    """A tree-layout state → the flat layout's, new (N, D) / (D,) fp32
    tensors on the same device (controller, queue, rng and round are
    shared, not copied)."""
    fl = s.inflight
    if fl is not None:
        fl = fl._replace(theta=spec.flatten_stacked(fl.theta),
                         lam=spec.flatten_stacked(fl.lam),
                         z=spec.flatten_stacked(fl.z))
    return s._replace(theta=spec.flatten_stacked(s.theta),
                      lam=spec.flatten_stacked(s.lam),
                      z_prev=spec.flatten_stacked(s.z_prev),
                      omega=spec.flatten(s.omega), inflight=fl)


def _rng_words(rng, device):
    return _t(np.asarray(rng).astype(np.uint32).astype(np.int64), device)


def scaffold_state_from_numpy(s, spec=None,
                              device=None) -> ScaffoldState:
    """A JAX ``ScaffoldState`` with numpy-convertible leaves → the port's
    on ``device``: with ``spec`` flat (ω and c through ``spec.flatten``,
    the stacked client variates through ``spec.flatten_stacked``),
    without it the same trees."""
    device = resolve_device(device)
    c, ci, w = (_tree_t(t, device) for t in (s.c_server, s.c_clients,
                                             s.omega))
    if spec is not None:
        c, ci, w = spec.flatten(c), spec.flatten_stacked(ci), spec.flatten(w)
    return ScaffoldState(c_server=c, c_clients=ci, omega=w,
                         rng=_rng_words(s.rng, device),
                         round=_t(s.round, device, torch.int32))


def scaffold_state_to_numpy(s: ScaffoldState) -> ScaffoldState:
    """The port's SCAFFOLD state with numpy leaves (in its layout, the
    rng as two uint32 words)."""
    return ScaffoldState(c_server=_tree_numpy(s.c_server),
                         c_clients=_tree_numpy(s.c_clients),
                         omega=_tree_numpy(s.omega),
                         rng=s.rng.detach().cpu().numpy().astype(np.uint32),
                         round=s.round.detach().cpu().numpy())

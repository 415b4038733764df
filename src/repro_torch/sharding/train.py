"""Training on the model mesh (fsdp): the gradient of a sharded block,
the training step's body, and the cross-pod round on a
``("pod", "data", "model")`` mesh — what the reference gets from
``jax.jit`` of its ``make_train_step`` and ``make_cross_pod_round``
with ``param_specs(mode="fsdp")`` shardings (``launch/steps.py``,
``launch/train.py``).

The parameters are a ``sharding.params.ShardedTree`` over a ``("data",
"model")`` mesh (a pod's sub-mesh across pods).  A data shard is the
batch block of one ``data`` position, run on its first coordinate (data
d, model 0), as in the serving steps (``sharding/serve.py``).

* **Forward.**  The data shard reads the parameters ZeRO-3 style
  through a :class:`GradView`: each leaf is put together from its
  blocks when the model reads it (:class:`_Gather`, reported as
  ``"all-gather"``), each layer inside its group of
  ``models.transformer._run_groups``, so that under ``cfg.remat``
  backward gathers the group again and no gathered layer is kept from
  forward to backward.
* **Backward.**  The gathered leaf's gradient is cut into every
  coordinate's share and copied there (``"reduce-scatter"``; a leaf
  replicated over an axis sends each replica its share), and each block
  adds its shares of the data shards' gradients in data-shard order
  (``.grad`` accumulation).
* **The loss is the whole batch's.**  Each data shard's term is its
  Σ −log p over the count of labelled positions of the whole batch
  (the counts are added first, in data-shard order), so the shards'
  gradients add up to the whole batch's and the loss is Σ over the
  shards of their sums over that count (``models.transformer
  .loss_terms``).  The MoE load-balance loss is a product of two
  means over the whole batch's routing, which no data shard sees: on a
  data axis larger than 1 the MoE family is refused (ROADMAP M22b-2).
  With one data shard every family is the unsharded loss bit for bit.

The cross-pod round keeps ``core/crosspod.py``'s algorithm and its
steps (``pod_mean``, ``sq_distances``, ``trigger``, ``dual_and_center``,
``solve``, ``commit``, ``round_metrics``); the state is a ShardedTree
of a ``CrossPodState`` (θ, λ, z_prev cut by ``pod_stacked_specs``, the
controller, key and round replicated on every coordinate):

* ω at each (data, model) position is :func:`pod_mean` of the pods'
  blocks there, on pod 0's coordinate, then one copy on each pod's
  (``"all-reduce"``; on a shared card the same tensor);
* each pod's ‖z − ω‖² is the sum over its coordinates (in order) of
  the sum over the leaves each *owns* — a leaf replicated over an axis
  is counted on the coordinates at position 0 of that axis only (the
  norms on one, the embedding and the head on data 0);
* the controller steps once, on the first coordinate, and its state,
  the key and the round are copied to the others (``"broadcast"``);
* pods are solved one at a time, a pod that did not fire is not solved,
  and a fired pod's blocks are committed in place.
"""
from __future__ import annotations

import functools

import torch

from repro_torch import prng
from repro_torch.core.controller import ControllerState, init_controller
from repro_torch.core.crosspod import CrossPodConfig, CrossPodState, \
    commit, dual_and_center, pod_mean, round_metrics, solve, \
    sq_distances, trigger
from repro_torch.core.engine import all_sum
from repro_torch.launch.mesh import DeviceMesh
from repro_torch.models.api import abstract_params
from repro_torch.models.transformer import IGNORE_LABEL, loss_terms
from repro_torch.optim.adam import AdamState, adam_step
from repro_torch.sharding.clients import ClientMesh, shard_targets
from repro_torch.utils.pytree import tree_broadcast_like, tree_leaves, \
    tree_map
from repro_torch.utils.spans import span

from .params import ShardedTree, block_slices, gather_leaf, gather_tree, \
    report_copies
from .serve import data_shards
from .specs import param_specs, pod_stacked_specs

TRAIN_MODES = ("fsdp",)
POD_AXES = ("pod", "data", "model")


def check_train_mode(mode: str) -> None:
    if mode not in TRAIN_MODES:
        raise ValueError(f"the mesh's training steps run mode 'fsdp'; got "
                         f"{mode!r} (tp, fsdp_tp and ep training: ROADMAP "
                         "M22b-2)")


def check_data_axis(cfg, n_data: int) -> None:
    """The MoE load-balance loss is a statistic of the whole batch's
    routing: refused on more than one data shard."""
    if cfg.family == "moe" and n_data > 1:
        raise ValueError(
            f"{cfg.name} (moe) trains on a data axis of 1 only: its "
            "load-balance loss is a product of means over the whole "
            f"batch's routing, which none of {n_data} data shards sees "
            "(ROADMAP M22b-2)")


def _build(template, leaves):
    it = iter(leaves)
    return tree_map(lambda _: next(it), template)


# ----------------------------------------------------------------------
# the gradient of a sharded block
# ----------------------------------------------------------------------


class _Gather(torch.autograd.Function):
    """Forward: a leaf put together on ``at``'s device from its blocks
    (one per coordinate, row-major; ``gather_leaf``).  Backward: each
    coordinate's share of the whole leaf's gradient, copied to its
    device (``"reduce-scatter"``)."""

    @staticmethod
    def forward(ctx, spec, mesh, at, *blocks):
        ctx.spec, ctx.mesh, ctx.at = spec, mesh, at
        whole = gather_leaf(list(blocks), spec, mesh, at)
        # a leaf whole on every coordinate comes back as at's own block
        return whole.clone() if any(whole is b for b in blocks) else whole

    @staticmethod
    def backward(ctx, grad):
        mesh, at = ctx.mesh, ctx.at
        parts, moved = [], []
        for c in mesh.coords():
            part = grad[block_slices(grad.shape, ctx.spec, mesh, c)].to(
                mesh.device(c), copy=True)
            parts.append(part)
            if c != at:
                moved.append(part)
        report_copies("reduce-scatter", moved)
        return (None, None, None, *parts)


class GradView:
    """A sharded parameter tree read by one data shard (from ``at``)
    through autograd: ``view[key]`` gathers that leaf or subtree when it
    is read, and :meth:`layers` gives one callable per layer that
    gathers the layer's rows (the layer axis is never cut)."""

    def __init__(self, sharded: ShardedTree, at):
        self.sharded, self.at = sharded, tuple(at)

    def _gather(self, blocks, spec):
        return _Gather.apply(tuple(spec), self.sharded.mesh, self.at,
                             *blocks)

    def __contains__(self, key) -> bool:
        return key in self.sharded.blocks[0]

    def __getitem__(self, key):
        sh = self.sharded
        leaves = [tree_leaves(b[key]) for b in sh.blocks]
        return _build(sh.blocks[0][key], [
            self._gather([ls[k] for ls in leaves], s)
            for k, s in enumerate(tree_leaves(sh.specs[key]))])

    def layers(self, n: int) -> list:
        sh = self.sharded
        specs = tree_leaves(sh.specs["layers"])
        for s in specs:
            if s and s[0] is not None:
                raise ValueError(f"the layer axis is cut ({s}); it never "
                                 "is under the sharding rules")
        # one unbind per block leaf: its backward stacks the layers'
        # gradients once, as the unsharded path's does
        rows = [[x.unbind(0) for x in tree_leaves(b["layers"])]
                for b in sh.blocks]

        def layer(i):
            return _build(sh.blocks[0]["layers"], [
                self._gather([r[k][i] for r in rows], tuple(s)[1:])
                for k, s in enumerate(specs)])

        return [functools.partial(layer, i) for i in range(n)]


def value_and_grad(cfg, params: ShardedTree, micro, groups):
    """(the whole batch's loss, each coordinate's gradient leaves) of
    the model ``cfg`` at ``params`` (ShardedTree blocks that require
    grad), data shard d (``groups[d]``, its coordinates) taking
    ``micro[d]`` on its first coordinate's device (the module note)."""
    check_data_axis(cfg, len(groups))
    counts = all_sum([torch.sum(m["labels"] != IGNORE_LABEL) for m in micro])
    nlls, loss = [], None
    for grp, m in zip(groups, micro, strict=True):
        with torch.enable_grad():
            nll, _, aux = loss_terms(cfg, GradView(params, grp[0]), m)
            n = torch.clamp(counts.to(nll.device, non_blocking=True), min=1)
            term = nll / n + cfg.aux_coef * aux
            term.backward()
        nlls.append(nll.detach())
        loss = term.detach()
    if len(nlls) > 1:  # aux is 0 here (the MoE family is refused)
        loss = all_sum(nlls) / torch.clamp(counts, min=1) \
            + cfg.aux_coef * aux.detach()
    grads = []
    for b in params.blocks:
        gs = []
        for p in tree_leaves(b):
            gs.append(p.grad)
            p.grad = None
        grads.append(gs)
    return loss, grads


# ----------------------------------------------------------------------
# the training step (launch.steps.make_train_step with a mesh)
# ----------------------------------------------------------------------


def _microbatches(batch: ShardedTree, groups, grad_accum: int) -> list:
    """Per microbatch, each data shard's rows on its first coordinate's
    device: microbatch i is rows [i·B/g, (i+1)·B/g) of the whole batch,
    then split over the data shards (the reference's order)."""
    if grad_accum == 1:
        return [[batch.at(g[0]) for g in groups]]
    n = len(groups)
    wholes = [gather_tree(batch, at=g[0]) for g in groups]
    out = []
    for i in range(grad_accum):
        def rows(x, d, i=i):
            b = x.shape[0] // grad_accum
            return x[i * b:(i + 1) * b][d * (b // n):(d + 1) * (b // n)]

        out.append([tree_map(lambda x, d=d: rows(x, d), w)
                    for d, w in enumerate(wholes)])
    return out


def make_train_step_on_mesh(cfg, mesh, specs, *, rho, lr, grad_accum,
                            batch_axes):
    """``train_step(params, opt, center, batch) -> (params, opt, loss)``
    over ShardedTrees cut by ``specs`` = (param specs, AdamState specs,
    param specs, batch specs): the gradient of the whole batch's loss
    (microbatches averaged as the unsharded step averages them), the
    prox pull and AdamW on each block; the loss on the mesh's first
    device."""
    groups = data_shards(mesh, batch_axes)
    check_data_axis(cfg, len(groups))

    def train_step(params, opt, center, batch):
        for x, s in zip((params, opt, center, batch), specs, strict=True):
            if not isinstance(x, ShardedTree) or x.specs != s:
                raise ValueError("the step's inputs are ShardedTrees cut "
                                 "by its in_specs")
        live = ShardedTree(tuple(
            tree_map(lambda p: p.detach().requires_grad_(True), b)
            for b in params.blocks), params.specs, mesh)
        micro = _microbatches(batch, groups, grad_accum)
        if grad_accum > 1:
            loss = torch.zeros((), dtype=torch.float32,
                               device=mesh.devices[0])
            g = [[torch.zeros_like(p) for p in tree_leaves(b)]
                 for b in params.blocks]
            for m in micro:
                li, gi = value_and_grad(cfg, live, m, groups)
                loss = loss + li / grad_accum
                g = [[a + b / grad_accum for a, b in zip(x, y, strict=True)]
                     for x, y in zip(g, gi, strict=True)]
        else:
            loss, g = value_and_grad(cfg, live, micro[0], groups)
        new_p, new_opt = [], []
        for gc, pc, cc, oc in zip(g, params.blocks, center.blocks,
                                  opt.blocks, strict=True):
            gc = tree_map(lambda gl, p, c: gl + rho * (
                p.to(torch.float32) - c.to(torch.float32)).to(gl.dtype),
                _build(pc, gc), pc, cc)
            p, o = adam_step(pc, gc, oc, lr)
            new_p.append(p)
            new_opt.append(o)
        return (ShardedTree(tuple(new_p), params.specs, mesh),
                ShardedTree(tuple(new_opt), opt.specs, mesh), loss)

    return train_step


def adam_specs(pspec) -> AdamState:
    """The AdamW state's specs: μ and ν cut as the parameters, the step
    replicated (the reference's ``opt_spec``)."""
    return AdamState(mu=pspec, nu=pspec, step=())


# ----------------------------------------------------------------------
# the cross-pod round on a pod × data × model mesh
# ----------------------------------------------------------------------


def cross_pod_specs(pspec) -> CrossPodState:
    """The state's specs: θ, λ, z_prev cut by ``pod_stacked_specs``, the
    controller, key and round replicated (the reference's
    ``state_spec``)."""
    pod = pod_stacked_specs(pspec)
    return CrossPodState(theta=pod, lam=pod, z_prev=pod,
                         ctrl=ControllerState(*((),) * 4), rng=(),
                         round=())


def cross_pod_batch_specs(batch_abs):
    """(pods, local_steps, rows, ...) leaves: pods over ``pod``, rows
    over ``data`` (the reference's ``P("pod", None, "data", ...)``)."""
    return tree_map(lambda x: ("pod", None, "data")
                    + (None,) * (x.dim() - 3), batch_abs)


def pod_submesh(mesh: DeviceMesh, p: int) -> DeviceMesh:
    """Pod ``p``'s ("data", "model") mesh: its coordinates, in order."""
    return DeviceMesh(mesh.axis_names[1:], mesh.sizes[1:], tuple(
        mesh.device(c) for c in mesh.coords() if c[0] == p))


def _check_pod_mesh(mesh, n_pods: int) -> None:
    if tuple(mesh.axis_names) != POD_AXES:
        raise ValueError(f"the cross-pod mesh's axes are {POD_AXES}; got "
                         f"{tuple(mesh.axis_names)}")
    if mesh.shape["pod"] != n_pods:
        raise ValueError(f"{n_pods} pods on a pod axis of "
                         f"{mesh.shape['pod']}")


def init_cross_pod_state_on_mesh(cfg: CrossPodConfig, params0,
                                 mesh) -> ShardedTree:
    """``init_cross_pod_state``'s state (θ_i = z_i = params0, λ_i = 0,
    the controller at δ⁰, the key ``PRNGKey(0)``, round 0) cut by
    :func:`cross_pod_specs` of fsdp's over ``mesh``, made block by block
    on each coordinate's device without the whole state."""
    _check_pod_mesh(mesh, cfg.n_pods)
    specs = cross_pod_specs(param_specs(params0, mesh, mode="fsdp"))
    dev = mesh.devices[0]
    theta = tree_broadcast_like(params0, cfg.n_pods)
    whole = CrossPodState(
        theta=theta, z_prev=theta,
        lam=tree_map(lambda x: x.new_zeros(()).expand(x.shape), theta),
        ctrl=init_controller(cfg.n_pods, cfg.controller, device=dev),
        rng=prng.PRNGKey(0, device=dev),
        round=torch.zeros((), dtype=torch.int32, device=dev))
    blocks = tuple(tree_map(
        lambda x, s, c=c: x[block_slices(x.shape, s, mesh, c)].to(
            mesh.device(c), copy=True), whole, specs) for c in mesh.coords())
    report_copies("scatter", [x for b in blocks[1:] for x in tree_leaves(b)])
    return ShardedTree(blocks, specs, mesh)


def _owns(spec, names, coord) -> bool:
    """Whether the coordinate ``coord`` (of a mesh with axes ``names``)
    counts its block of a leaf cut by ``spec`` once in a sum over the
    mesh: it lies at position 0 of every axis the leaf is replicated
    over."""
    cut = {a for e in spec for a in ((e,) if isinstance(e, str)
                                     else (e or ()))}
    return all(i == 0 for a, i in zip(names, coord, strict=True)
               if a not in cut)


def make_cross_pod_round_on_mesh(cfg: CrossPodConfig, model, mesh, *,
                                 every_pod_fires: bool = False):
    """``round_fn(state, batch) -> (state, metrics)`` over ``mesh``
    (axes ``("pod", "data", "model")``, the pod axis of ``cfg.n_pods``):
    ``state`` the ShardedTree of :func:`init_cross_pod_state_on_mesh`
    (its θ, λ and z_prev blocks updated in place), ``batch`` a
    ShardedTree of (pods, local_steps, rows, ...) leaves cut by
    :func:`cross_pod_batch_specs`; the metrics on the mesh's first
    device.  ``every_pod_fires`` as in ``make_cross_pod_round``."""
    _check_pod_mesh(mesh, cfg.n_pods)
    mcfg = model.config
    n_pods = cfg.n_pods
    pspec = param_specs(abstract_params(model), mesh, mode="fsdp")
    specs = cross_pod_specs(pspec)
    subs = [pod_submesh(mesh, p) for p in range(n_pods)]
    groups = data_shards(subs[0], ("data",))
    check_data_axis(mcfg, len(groups))
    sub = subs[0].coords()
    leaf_specs = tree_leaves(pspec)
    owned = [[k for k, s in enumerate(leaf_specs)
              if _owns(s, subs[0].axis_names, c)] for c in sub]
    dev0 = mesh.devices[0]
    ctrl_cfg = cfg.controller._replace(target_rate=shard_targets(
        cfg.controller.target_rate, ClientMesh((dev0,)))[0])

    def leaves(state, field, p):
        """Pod p's blocks of one field: per sub-coordinate, its leaves
        ((1, ...) blocks)."""
        return [tree_leaves(getattr(state.at((p,) + c), field))
                for c in sub]

    def flat(lists):
        return [x for ls in lists for x in ls]

    def consensus(zs):
        """ω per sub-coordinate and leaf, one copy on each pod's."""
        omega = []
        for ci, c in enumerate(sub):
            dev = mesh.device((0,) + c)
            report_copies("all-reduce", flat(zs[p][ci]
                                             for p in range(1, n_pods)))
            omega.append([pod_mean([zs[p][ci][k][0].to(dev, non_blocking=True)
                                    for p in range(n_pods)], n_pods)
                          for k in range(len(leaf_specs))])
        out = []
        for p in range(n_pods):
            mine = [[w.to(mesh.device((p,) + c), non_blocking=True)
                     for w in ws] for c, ws in zip(sub, omega, strict=True)]
            if p:
                report_copies("all-reduce", flat(mine))
            out.append(mine)
        return out

    def distances(zs, omegas):
        """‖z_p − ω‖ of every pod (P,) on the first device."""
        per_pod = []
        for p in range(n_pods):
            parts = [sq_distances([zs[p][ci][k] for k in ks],
                                  [omegas[p][ci][k] for k in ks])
                     for ci, ks in enumerate(owned) if ks]
            per_pod.append(all_sum(parts))
        report_copies("all-gather", per_pod[1:])
        return torch.sqrt(torch.cat([d.to(dev0, non_blocking=True)
                                     for d in per_pod]))

    def local_solve(p, omega, center, batch):
        """:func:`solve` from ω on pod p's sub-mesh → (θ_out leaves, the
        mean loss)."""
        params = [w.clone() for w in omega]
        n = len(leaf_specs)
        live = ShardedTree(tuple(
            _build(pspec, params[i * n:(i + 1) * n])
            for i in range(len(sub))), pspec, subs[p])

        def vg(step):
            micro = [tree_map(lambda x: x[0, step], batch.at((p,) + g[0]))
                     for g in groups]
            loss, grads = value_and_grad(mcfg, live, micro, groups)
            return loss, flat(grads)

        return params, solve(cfg, params, center, vg)

    @torch.no_grad()
    def round_fn(state, batch):
        if not isinstance(state, ShardedTree) or state.specs != specs:
            raise ValueError("the state is a ShardedTree cut by the "
                             "cross-pod step's in_specs[0]")
        if not isinstance(batch, ShardedTree) or any(
                tuple(s)[:3] != ("pod", None, "data")
                for s in tree_leaves(batch.specs)):
            raise ValueError("the batch is a ShardedTree cut by "
                             "cross_pod_batch_specs")
        with span("crosspod/trigger"):
            zs = [leaves(state, "z_prev", p) for p in range(n_pods)]
            omegas = consensus(zs)
            dist = distances(zs, omegas)
            events, ctrl = trigger(dist, state.blocks[0].ctrl, ctrl_cfg)
        fired = ([True] * n_pods if every_pod_fires
                 else events.tolist())  # the one host read
        losses = torch.zeros((n_pods,), dtype=torch.float32, device=dev0)
        for p in range(n_pods):
            if not fired[p]:
                continue
            theta = flat(leaves(state, "theta", p))
            lam = flat(leaves(state, "lam", p))
            with span("crosspod/solve"):
                lam_new, center = dual_and_center(
                    [x[0] for x in lam], [x[0] for x in theta],
                    flat(omegas[p]))
                theta_out, losses[p] = local_solve(p, flat(omegas[p]),
                                                   center, batch)
                del center
            with span("crosspod/commit"):
                commit(theta, lam, flat(leaves(state, "z_prev", p)), 0,
                       theta_out, lam_new)
                del theta_out, lam_new
        metrics = round_metrics([events], [dist], [ctrl], [losses])
        rng, _ = prng.split(state.blocks[0].rng)
        rnd = state.blocks[0].round + 1
        blocks, moved = [], []
        for i, b in enumerate(state.blocks):
            new = b._replace(ctrl=ctrl, rng=rng, round=rnd)
            if i:
                new = new._replace(**{f: tree_map(
                    lambda x, i=i: x.to(mesh.devices[i], copy=True),
                    getattr(new, f)) for f in ("ctrl", "rng", "round")})
                moved += [*new.ctrl, new.rng, new.round]
            blocks.append(new)
        report_copies("broadcast", moved)
        return ShardedTree(tuple(blocks), specs, mesh), metrics

    return round_fn

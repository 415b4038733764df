"""Cross-pod FedBack: the paper's cross-silo setting at LM scale (port
of ``repro/core/crosspod.py``).

Each *pod* is one silo: it trains its own replica of a zoo model, ω is
the mean of the pods' last committed z = θ + λ, and the integral
controller gates which pods commit.  One round, the reference's step
for step:

1. ω = (1/P) Σ_i z_i^prev, per leaf summed in fp32 in pod order and
   rounded to the leaf's dtype (``jnp.mean``'s arithmetic);
2. distances ‖z_i^prev − ω‖, the difference rounded to the parameter
   dtype before it is squared in fp32 (``stacked_sq_norms`` of the
   difference tree), leaf by leaf; events = distances ≥ δ_i;
3. ``controller_step`` on the events;
4. per pod: λ⁺ = λ + θ − ω (``dual_ascent``), c = ω − λ⁺
   (``prox_center``), then ``local_steps`` SGD+momentum steps from ω on
   loss + ρ(θ − c), one microbatch each;
5. ``gated_commit`` of θ, λ and z = θ_out + λ⁺; ``train_loss`` the
   participants' mean loss (``participant_mean_loss``); the key split
   once; the round counter advanced.

Where it differs from the reference, and why:

* **One pod at a time, committed in place.**  The reference ``vmap``\\ s
  the pods' solves and holds every pod's ω copy, λ⁺, centre, θ₀, θ_out,
  z and momentum at once: ~100 GB for two granite-3-2b replicas in
  bf16, more than an 80 GB card.  Once ω is fixed the pods are
  independent, so each pod's λ⁺, centre, solve and commit run before
  the next pod's, and a pod that fired writes its θ, λ and z_prev rows
  of the state in place (the round consumes its input state: clone one
  to compare against).  Live beyond the state: ω, the pod's λ⁺ and
  centre, its parameters, momentum and gradient — 6 replicas (~63 GB
  for P = 2 at granite-3-2b in bf16) plus activations.  The distances
  are taken leaf by leaf, never as a whole difference tree.
* **A pod that did not fire is not solved.**  The reference solves it
  and discards the result (``gated_commit`` keeps its rows, and
  ``train_loss`` weighs its loss 0), so skipping it leaves the state
  and the metrics as they were (tests/test_torch_crosspod.py holds
  this against the reference, and counts the loss calls).  The round
  reads its (P,) events back to the host once for that: the one host
  sync of a round, next to seconds of device work at LM scale.
* **The distances stay plain**: K1c (``trigger_sq_norms_pytree``)
  squares an fp32 difference, where the reference rounds z − ω to the
  parameter dtype first; in bf16 the two differ, so no kernel runs on
  this path.  The loss runs the model's plain differentiable path
  (``blockwise_attention``); K4 has no backward.

``loss_fn(params, batch) -> () fp32`` takes one pod's parameter tree
(the reference's layout, as ``Model.init`` gives it) and one
microbatch; its gradient comes from ``torch.autograd.grad``.  The
batch is a tree of (P, local_steps, ...) tensors; each pod reads its
row, step by step.

**Placement.**  Without ``mesh`` all pods sit on one device, the
state's.  With ``mesh`` (a :class:`~repro_torch.sharding.ClientMesh`
over the pods, one controller, as the client mesh of
``core/fedback.py``) the state is a shard list: shard i holds pods
[i·P/S, (i+1)·P/S) on ``mesh.devices[i]`` with its own copy of the key
and the round; ω is summed over every shard's pods in pod order on
shard 0's device and copied to each shard; the controller steps each
shard's rows.  One device is the one-shard case of the same code, and
any mesh gives its bits.  Both keep a whole replica of each pod on one
device.  A pod split over cards — the reference's pod × data × model
mesh, each pod's replica fsdp over its (data, model) coordinates — is
``sharding/train.py``'s ``make_cross_pod_round_on_mesh``, which runs
this module's steps (:func:`pod_mean`, :func:`sq_distances`,
:func:`trigger`, :func:`dual_and_center`, :func:`solve`,
:func:`commit`, :func:`round_metrics`) on the blocks.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import torch

from repro_torch import prng
from repro_torch.device import resolve_device
from repro_torch.sharding.clients import ClientMesh, check_divisible, \
    collectives, replicate_data, shard_rows, shard_targets, unshard_rows
from repro_torch.utils.pytree import tree_leaves, tree_map, tree_zeros_like
from repro_torch.utils.spans import span

from .controller import ControllerConfig, ControllerState, \
    controller_step, init_controller
from .engine import all_sum, participant_mean_loss


@dataclasses.dataclass(frozen=True)
class CrossPodConfig:
    """The reference's fields but its ``param_dtype``, which its round
    never reads: the round takes the dtypes of the state it is given."""

    n_pods: int = 2
    rho: float = 1e-4  # prox weight at LM scale (grad norms are O(1))
    lr: float = 3e-4
    momentum: float = 0.9
    local_steps: int = 4  # microbatch SGD steps per round (inexact prox)
    controller: ControllerConfig = ControllerConfig(K=0.5, alpha=0.9,
                                                    target_rate=0.5)


class CrossPodState(NamedTuple):
    theta: object  # pod-stacked (P, ...) tree — per-pod primal replicas
    lam: object  # pod-stacked (P, ...) tree — per-pod duals
    z_prev: object  # pod-stacked (P, ...) tree — last committed θ + λ
    ctrl: ControllerState  # (P,) controller state
    rng: torch.Tensor  # the key's two words
    round: torch.Tensor  # () int32


class CrossPodMetrics(NamedTuple):
    events: torch.Tensor  # (P,) bool
    num_events: torch.Tensor  # () int32
    distances: torch.Tensor  # (P,) fp32
    delta: torch.Tensor  # (P,) fp32 — δ after the controller step
    train_loss: torch.Tensor  # () fp32


def init_cross_pod_state(cfg: CrossPodConfig, params0, *, device=None,
                         mesh: ClientMesh | None = None):
    """θ_i = z_i = params0 for every pod (distinct buffers), λ_i = 0, the
    controller at δ⁰, the key ``PRNGKey(0)`` (the reference's), round 0;
    on ``device`` (CUDA by default) or, with ``mesh``, the shard list
    (shard i: its pods' rows on ``mesh.devices[i]``).  ``params0`` is a
    tree of tensors in the reference's layout; its dtypes are kept."""
    single = mesh is None
    if single:
        mesh = ClientMesh((resolve_device(device),))
    elif device is not None:
        raise ValueError("pass device= or mesh=, not both")
    check_divisible(cfg.n_pods, mesh)
    n = cfg.n_pods // mesh.size
    shards = []
    for dev in mesh.devices:
        theta = tree_map(lambda x: torch.stack([x.to(dev)] * n), params0)
        shards.append(CrossPodState(
            theta=theta, lam=tree_zeros_like(theta),
            z_prev=tree_map(torch.clone, theta),
            ctrl=init_controller(n, cfg.controller, device=dev),
            rng=prng.PRNGKey(0, device=dev),
            round=torch.zeros((), dtype=torch.int32, device=dev)))
    return shards[0] if single else tuple(shards)


def pod_mean(rows, n_pods: int) -> torch.Tensor:
    """ω of one leaf (or of one block of it) from the pods' rows, in pod
    order on the first row's device: summed in fp32, over P, rounded to
    the rows' dtype — ``jnp.mean(z, axis=0)``'s arithmetic."""
    total = None
    for row in rows:
        total = (row.to(torch.float32, copy=True) if total is None
                 else total.add_(row))
    return (total / n_pods).to(rows[0].dtype)


def _consensus(shards, n_pods: int):
    """ω per leaf: :func:`pod_mean` of every shard's rows (the shards in
    order, on shard 0's device)."""
    dev0 = shards[0].rng.device

    def mean(*zs):
        return pod_mean([row for z in zs for row in z.to(
            dev0, non_blocking=True).unbind(0)], n_pods)

    collectives.add("all-reduce", [s.z_prev for s in shards[1:]])
    return tree_map(mean, *(s.z_prev for s in shards))


def sq_distances(z_leaves, w_leaves) -> torch.Tensor:
    """Σ over the leaves of ‖z − ω‖² per pod row: each pod-stacked leaf
    (or block) minus ω's, the difference in the leaf's dtype, squared
    and summed in fp32, the leaves added in order."""
    total = None
    for z, w in zip(z_leaves, w_leaves, strict=True):
        d = (z - w[None]).to(torch.float32)
        part = torch.sum((d * d).reshape(d.shape[0], -1), dim=1)
        total = part if total is None else total + part
    return total


def _distances(z_prev, omega) -> torch.Tensor:
    """‖z_i − ω‖ of the shard's pods."""
    return torch.sqrt(sq_distances(tree_leaves(z_prev), tree_leaves(omega)))


def trigger(distances, ctrl: ControllerState, ctrl_cfg: ControllerConfig):
    """The pods' events (distance ≥ δ) and the controller stepped on
    them."""
    events = distances >= ctrl.delta
    return events, controller_step(ctrl, events, ctrl_cfg)


def dual_and_center(lam, theta, omega):
    """One pod's λ⁺ = λ + θ − ω (``dual_ascent``) and c = ω − λ⁺
    (``prox_center``), leaf lists of one layout."""
    lam_new = [lm + t - w for lm, t, w in zip(lam, theta, omega, strict=True)]
    return lam_new, [w - lm for w, lm in zip(omega, lam_new, strict=True)]


def solve(cfg: CrossPodConfig, leaves, center, value_and_grad):
    """``cfg.local_steps`` SGD+momentum steps on loss + ρ(θ − c), in
    place on ``leaves`` (the parameters, ω at the start); returns the
    mean of the steps' losses.  ``value_and_grad(step) -> (loss, the
    gradients of the leaves)`` takes step ``step``'s microbatch.  Each
    step updates the parameters and the momentum leaf by leaf, with
    ``sgd_step``'s roundings: g = ∇ + ρ·(θ − c), buf ← momentum·buf + g,
    θ ← θ − lr·buf."""
    buf = [torch.zeros_like(p) for p in leaves]
    for p in leaves:
        p.requires_grad_(True)
    losses = []
    for step in range(cfg.local_steps):
        loss, grads = value_and_grad(step)
        grads = list(grads)
        for i, (p, c, b) in enumerate(zip(leaves, center, buf, strict=True)):
            g = grads[i] + cfg.rho * (p - c)
            grads[i] = None
            b.mul_(cfg.momentum).add_(g)
            p.sub_(cfg.lr * b)
            del g
        losses.append(loss.detach())
    for p in leaves:
        p.requires_grad_(False)
    return torch.mean(torch.stack(losses))


def commit(theta, lam, z_prev, j: int, theta_out, lam_new) -> None:
    """A fired pod's rows written in place: θ[j] = θ_out, λ[j] = λ⁺,
    z_prev[j] = θ_out + λ⁺ (leaf lists of one layout)."""
    for t, l, z, th, lm in zip(theta, lam, z_prev, theta_out, lam_new,
                               strict=True):
        t[j] = th
        l[j] = lm
        torch.add(th, lm, out=z[j])


def round_metrics(events, distances, ctrls, losses) -> "CrossPodMetrics":
    """The round's metrics from per-shard lists (one shard: lists of
    one)."""
    return CrossPodMetrics(
        events=unshard_rows(events),
        num_events=all_sum([torch.sum(e.to(torch.int32))
                            for e in events]).to(torch.int32),
        distances=unshard_rows(distances),
        delta=unshard_rows([c.delta for c in ctrls]),
        train_loss=participant_mean_loss(losses, events))


def make_cross_pod_round(cfg: CrossPodConfig, loss_fn: Callable, *,
                         mesh: ClientMesh | None = None,
                         every_pod_fires: bool = False):
    """Build ``round_fn(state, batch) -> (state, metrics)``.

    ``loss_fn(params, batch) -> scalar`` over one pod's tree; ``batch``
    is a tree of tensors with leading axes (P, local_steps, ...), moved
    to each pod's device.  With ``mesh`` the round takes and returns the
    shard list of ``init_cross_pod_state(..., mesh=mesh)``.  The state's
    θ, λ and z_prev are updated in place (see the module note).

    ``every_pod_fires`` solves and commits every pod without reading the
    events back: the one-card dry-run (``launch/dryrun.py``) counts a
    round on the meta device, where nothing can be read, and so counts
    its most work.  The metrics still carry the events the trigger
    computed."""
    sharded = mesh is not None
    if sharded:
        check_divisible(cfg.n_pods, mesh)
    ctrl_cfgs = None

    def local_solve(omega, center, batch_i):
        """:func:`solve` from ω → (θ_out leaves, the mean loss)."""
        params = tree_map(torch.clone, omega)
        leaves = tree_leaves(params)

        def value_and_grad(step):
            micro = tree_map(lambda x: x[step], batch_i)
            with torch.enable_grad():
                loss = loss_fn(params, micro)
                return loss, torch.autograd.grad(loss, leaves)

        return leaves, solve(cfg, leaves, center, value_and_grad)

    @torch.no_grad()
    def round_body(shards, batch):
        nonlocal ctrl_cfgs
        pod_mesh = mesh or ClientMesh((shards[0].rng.device,))
        if ctrl_cfgs is None:  # each shard's rows of a per-pod L̄
            ctrl_cfgs = [cfg.controller._replace(target_rate=t) for t in
                         shard_targets(cfg.controller.target_rate, pod_mesh)]
        with span("crosspod/trigger"):
            omega = _consensus(shards, cfg.n_pods)
            omegas = replicate_data(pod_mesh, omega)
            distances = [_distances(s.z_prev, w)
                         for s, w in zip(shards, omegas, strict=True)]
            events, ctrls = zip(*(trigger(d, s.ctrl, c) for d, s, c in
                                  zip(distances, shards, ctrl_cfgs,
                                      strict=True)))
        batches = shard_rows(batch, pod_mesh)
        fired = ([True] * cfg.n_pods if every_pod_fires
                 else unshard_rows(events).tolist())  # the one host read
        losses, pod = [], 0
        for s, w, e, b in zip(shards, omegas, events, batches, strict=True):
            ls = torch.zeros(e.shape, dtype=torch.float32, device=e.device)
            for j in range(e.shape[0]):
                if fired[pod]:
                    with span("crosspod/solve"):
                        lam_new, center = dual_and_center(
                            [x[j] for x in tree_leaves(s.lam)],
                            [x[j] for x in tree_leaves(s.theta)],
                            tree_leaves(w))
                        theta_out, ls[j] = local_solve(
                            w, center, tree_map(lambda x: x[j], b))
                        del center
                    with span("crosspod/commit"):
                        commit(tree_leaves(s.theta), tree_leaves(s.lam),
                               tree_leaves(s.z_prev), j, theta_out, lam_new)
                        del theta_out, lam_new
                pod += 1
            losses.append(ls)
        metrics = round_metrics(events, distances, ctrls, losses)
        rng, _ = prng.split(shards[0].rng)
        replicas = zip(replicate_data(pod_mesh, rng),
                       replicate_data(pod_mesh, shards[0].round + 1),
                       strict=True)
        new = tuple(s._replace(ctrl=c, rng=key, round=rnd)
                    for s, c, (key, rnd) in zip(shards, ctrls, replicas,
                                                strict=True))
        return new, metrics

    def round_fn(state, batch):
        if sharded:
            return round_body(tuple(state), batch)
        (new,), metrics = round_body((state,), batch)
        return new, metrics

    return round_fn

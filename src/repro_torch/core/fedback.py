"""The FedBack round engine (paper Alg. 2), ported to PyTorch.

Port of ``repro/core/fedback.py``: the synchronous round and the
stale-tolerant one, on both client-state layouts of the reference: the
**flat** layout (``spec=`` a ``FlatSpec``: θ, λ, z_prev as (N, D) fp32
matrices, ω a (D,) vector)
and the **tree** layout (``spec=None``: nested dicts of stacked (N,
...) tensors with the model's keys, ω the unstacked dict).  Both run
the same code: the algebra is written over trees
(:mod:`repro_torch.utils.pytree`), and a flat matrix is a tree of one
leaf.  One program covers the algorithm family of the reference's
table:

  ================  =========  ==========  ===============  ============
  algorithm         selection  dual λ      local prox ρ     aggregation
  ================  =========  ==========  ===============  ============
  fedback           fedback    ADMM        ρ (Eq. 2.3)      mean z_i^prev
  fedadmm           random     ADMM        ρ                mean z_i^prev
  admm (vanilla)    full       ADMM        ρ                mean z_i^prev
  fedavg            random     0           0                mean over I_s
  fedprox           random     0           μ (center ω)     mean over I_s
  ================  =========  ==========  ===============  ============

(``selection=`` overrides the column: ``bernoulli`` and ``round_robin``
too.)  One round, in order:

1. trigger distances ‖ω − z_i^prev‖ (for the l2 metric K1
   ``trigger_sq_norms``, through its stacked-tree front end K1c
   ``trigger_sq_norms_pytree``, which reads the flat matrix, or a tree's
   leaves, in place), taken for every algorithm as the
   reference does;
2. the selection (its key is the round key's second split) and the
   controller step;
3. the client update, in one of two forms:

   * **compact** (``compact=True``): the capacity-bounded plan and its
     deferral queue, the pre-solve λ⁺/center over the C planned rows,
     the SGD prox solve over C slots, and the commit — with
     ``fused_gss`` (flat only) one in-place K3 pass, otherwise K2
     ``admm_update`` on the gathered rows (flat) or the plain dual
     algebra (tree) and three scatters;
   * **dense** (``compact=False``): λ⁺ and the centers over all N rows
     (K2 ``admm_update(with_z=False)`` on the flat layout, the plain
     algebra on the tree layout, as the reference gates its kernel on
     ``flat``), the solve over all N clients, and the event-gated
     commit;

   the AVG family (FedAvg, FedProx) skips the dual algebra and its
   kernels: λ stays zero, the center is ω and z = θ;
4. the consensus mean ω = (1/N) Σ z_i^prev for the ADMM family, the
   mean over the committed clients for the AVG family; with
   ``consensus_compress`` ("bf16" or "int8", flat layout only) the
   error-feedback compressed form of either (``core/compress.py``),
   whose residual is ``FLState.comm``.  ``"none"`` is the exact fp32
   program, with ``comm`` None.

**Stale-tolerant rounds** (``max_staleness=S``): a serviced solve lands
in θ/λ/z_prev δ_i ≤ S rounds later (``FLState.inflight``, the delays of
``state.delay_schedule``), while the consensus runs every round over
the freshest rows.  A client with a solve in flight may not fire or be
planned; the controller measures events when they land, through the
issued-event ring, with its target clamped to 1/(1+δ_i).  The commit
routes the proposals through the pipeline as the reference does — six
full-width selects (``engine.staleness_commit``) — except after the
fused commit, which has written the planned rows in place: there the
rows that park get their old rows back, slot by slot
(``engine.staleness_commit_slots``).  ``max_staleness=0`` is the
synchronous round bit for bit.

**Serving** (``arrivals_arg=True``): ``round_fn(state, arrivals)``
takes the tick's (N,) bool arrival mask on the card; fresh events come
only from arrived clients (the k-subset draws among them), queued
demand is served whatever arrives (``core/schedule.py`` drives it).

The kernels are reached through :mod:`repro_torch.kernels.ops`, whose
wrappers launch the hand-written kernel for a CUDA tensor and run the
plain version for a CPU one; the round has no other switch between
them.  It runs eagerly on the device of its state and never waits for
it: no value is read back to the host and no host tensor is copied in
(``chip_smoke.py`` runs the rounds under CUDA's sync debug mode).
Minibatch orders come from the
``jax.random`` twin (:mod:`repro_torch.prng`), so a round started from
the JAX package's state draws the same indices.  The solve's matrix
products and convolutions run in full fp32: TF32 is switched off for
cuBLAS and cuDNN where a round is built (``device.fp32_products``), as
the reference's products run at fp32 on the CPU.

**Client mesh** (``mesh=``, a :class:`~repro_torch.sharding.ClientMesh`
of P devices, which may repeat): the reference's client-sharded round
with one controller.  The state is a shard list, one ``FLState`` per
shard (:func:`init_state`); every step above runs per shard on the
shard's clients and device, K1b and K2b (``kernels.ops``' ``mesh=``
paths) launching K1's and K2's kernels once per shard, and the compact
form planning, deferring and committing per shard with ⌈C/P⌉ slots.
The draws over all clients and the minibatch keys come from the
replicated key over the global N, cut by shard; the reductions over
clients add per-shard partials in shard order on shard 0's device
(``core/engine.py``).  One device is the one-shard case of the same
code.  The mesh needs no process group: one process drives every shard.
A per-client (N,) target L̄ reaches each shard's controller as its rows
(:func:`_shard_selections`), clamped under ``max_staleness`` by the
shard's own delays.

**Ragged clients** (``ragged=``, a
:class:`~repro_torch.utils.ragged.RaggedSpec`): the data is one pooled
(Σnᵢ, ...) buffer and each client reads its CSR slice of it.  The dense
round runs one batched solve per size bucket at the bucket's capacity
(the padded buckets through :func:`_masked_local_solve`), and the
compact round solves its slots at the static max(nᵢ) epoch length,
masked unless every size is equal.  A uniform spec takes the plain
solve and gives the rectangular round's bits.  Under ``mesh=`` the pool
is copied to each shard's device and each shard solves its own
clients' rows.

**Sweeps** (``ctrl_arg=True``): ``round_fn(state, ctrl_overrides)``
takes runtime controller overrides, ``{"K": k, "target_rate": r}`` as
0-d fp32 tensors on the state's device, which reach the controller's
step alone (``FedBackSelection.measure``); the plan's capacity and rate
floor stay on ``cfg.participation``.  :mod:`repro_torch.launch.sweep`
steps one such round over a grid of seeds, gains and target rates.

**Host-offloaded state** (``state_backend="host"``): :func:`init_state`
and :func:`make_round_fn` hand over to :mod:`repro_torch.core.hoststate`,
whose round keeps the (N, D) client matrices in host memory and streams
the C planned rows through the card.

The cross-pod program over a zoo model is :mod:`repro_torch.core.crosspod`.
SCAFFOLD has its own round (:mod:`repro_torch.core.baselines`), without
a mesh, as in the reference.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch import prng
from repro_torch.device import fp32_products, resolve_device
from repro_torch.kernels import ops
from repro_torch.optim.sgd import sgd_step
from repro_torch.sharding.clients import ClientMesh, check_divisible, \
    collectives, replicate_data, shard_client_data, shard_rows, \
    shard_targets, unshard_rows
from repro_torch.utils.flatstate import FlatSpec
from repro_torch.utils.pytree import tree_broadcast_like, tree_map, \
    tree_where, tree_zeros_like
from repro_torch.utils.ragged import RaggedSpec
from repro_torch.utils.spans import span

from .compact import capacity_bounds, gather_blocks, gather_rows, \
    init_queue, make_compact_block
from .compress import check_mode, ef_consensus, ef_participant_mean, \
    init_residual
from .controller import ControllerConfig, init_controller
from .engine import all_sum, consensus_mean, dual_ascent, gated_commit, \
    masked_batch_loss, measured_commits, participant_mean, \
    participant_mean_loss, prox_center, record_issue, staleness_commit, \
    staleness_commit_slots, staleness_masks
from .selection import make_selection
from .state import FLState, InFlight, RoundMetrics, delay_schedule, \
    init_inflight
from .trigger import trigger_distances

ADMM_FAMILY = ("fedback", "fedadmm", "admm")
AVG_FAMILY = ("fedavg", "fedprox")


@dataclasses.dataclass(frozen=True)
class FLConfig:
    """Hyper-parameters of the run; the JAX package's field names.

    ``use_trigger_kernel`` and ``use_admm_kernel`` are kept for the
    field names and not read: the round always goes through the kernel
    ops, which pick the kernel or the plain version by the tensors'
    device.  ``fused_gss`` picks the compact round's commit form.
    Fields of features not ported yet keep their defaults; other values
    are refused by :func:`make_round_fn`.
    """

    algorithm: str = "fedback"
    n_clients: int = 100
    participation: float = 0.1
    rho: float = 0.01
    mu: float = 0.0
    lr: float = 0.01
    momentum: float = 0.9
    epochs: int = 2
    batch_size: int = 42
    controller: ControllerConfig = ControllerConfig()
    trigger_metric: str = "l2"
    warm_start: bool = True
    selection: str | None = None
    use_trigger_kernel: bool = False
    use_admm_kernel: bool = False
    fused_gss: bool = False
    compact: bool = False
    capacity_slack: float = 1.5
    capacity: int | None = None
    adaptive_capacity: bool = True
    max_staleness: int | None = None
    staleness_schedule: str = "roundrobin"
    consensus_compress: str = "none"
    compress_block: int = 256
    state_backend: str = "device"
    stream_tiles: int = 2
    seed: int = 0

    def selection_name(self) -> str:
        if self.selection is not None:
            return self.selection
        if self.algorithm == "fedback":
            return "fedback"
        if self.algorithm == "admm":
            return "full"
        return "random"

    def local_rho(self) -> float:
        if self.algorithm in ADMM_FAMILY:
            return self.rho
        if self.algorithm == "fedprox":
            return self.mu
        return 0.0


def _ctrl_cfg(cfg: FLConfig) -> ControllerConfig:
    """Controller config with L̄ defaulted from cfg.participation."""
    c = cfg.controller
    if isinstance(c.target_rate, (bool, int, float)):
        c = c._replace(target_rate=float(cfg.participation))
    return c


def _shard_selections(cfg: FLConfig, mesh: ClientMesh) -> list:
    """One selection per shard of ``mesh``, each with its shard's L̄
    (``sharding.clients.shard_targets``); under ``max_staleness`` each
    shard's ``measure`` clamps its rows by its own delays."""
    ctrl = _ctrl_cfg(cfg)
    return [make_selection(cfg.selection_name(), rate=cfg.participation,
                           controller=ctrl._replace(target_rate=t),
                           metric=cfg.trigger_metric)
            for t in shard_targets(ctrl.target_rate, mesh)]


def _check_supported(cfg: FLConfig) -> None:
    if cfg.algorithm not in ADMM_FAMILY + AVG_FAMILY:
        raise NotImplementedError(
            f"not ported yet: algorithm={cfg.algorithm!r}")


def _backend(cfg: FLConfig) -> str:
    if cfg.state_backend not in ("device", "host"):
        raise ValueError(f"unknown state_backend: {cfg.state_backend!r} "
                         "(expected 'device' or 'host')")
    return cfg.state_backend


def _check_compress(cfg: FLConfig, flat: bool) -> str:
    """The compression mode; compression needs the flat layout, whose
    (N, D) matrix the residual shadows."""
    mode = check_mode(cfg.consensus_compress)
    if mode != "none" and not flat:
        raise ValueError(
            f"consensus_compress={mode!r} needs the flat (spec=) layout — "
            "the EF residual is an (N, D) matrix over the flat state")
    return mode


def _init_shard(cfg: FLConfig, w0, n: int, device,
                delay=None) -> FLState:
    """The Alg. 2 state of ``n`` clients from ω⁰ = ``w0`` on ``device``;
    with ``delay`` (their rows of the delay schedule) an empty delay
    pipeline; under compression a zero residual."""
    w0 = tree_map(lambda x: x.to(device), w0)

    def stacked(x):
        return x[None].repeat((n,) + (1,) * x.dim())

    theta = tree_map(stacked, w0)
    inflight = None
    if delay is not None:
        inflight = init_inflight(theta, delay.to(device), cfg.max_staleness)
    return FLState(
        theta=theta,
        lam=tree_zeros_like(theta),
        z_prev=tree_map(stacked, w0),
        omega=tree_map(torch.clone, w0),
        ctrl=init_controller(n, _ctrl_cfg(cfg), device=device),
        rng=prng.PRNGKey(cfg.seed, device=device),
        round=torch.zeros((), dtype=torch.int32, device=device),
        queue=init_queue(n, device=device),
        inflight=inflight,
        comm=(init_residual(n, w0.shape[-1], device=device)
              if cfg.consensus_compress != "none" else None),
    )


def init_state(cfg: FLConfig, params0, *, spec: FlatSpec | None = None,
               device=None, mesh: ClientMesh | None = None):
    """Alg. 2 initialization: θ_i = z⁰, λ_i = 0, z_i^prev = θ_i, ω = z⁰,
    on ``device`` (CUDA by default).  With ``spec`` the flat layout:
    (N, D) / (D,) fp32 tensors; without, the tree layout: the params
    dict's leaves stacked N times.  θ, z_prev and ω are distinct
    buffers.

    With ``mesh`` (a :class:`~repro_torch.sharding.ClientMesh`; no
    ``device`` then) the shard list: a tuple of one ``FLState`` per
    shard, shard i holding clients [i·N/P, (i+1)·N/P) on
    ``mesh.devices[i]`` and its own copy of ω, the key and the round.

    With ``cfg.max_staleness`` set, ``inflight`` is the empty delay
    pipeline (``core/state.py``): the delays of ``delay_schedule(N, S,
    kind=cfg.staleness_schedule, seed=cfg.seed)``, each shard its rows.
    With ``cfg.consensus_compress`` set, ``comm`` is the zero (N, D)
    residual (each shard its rows); the tree layout is refused.

    With ``cfg.state_backend="host"`` the host-offloaded state of
    :func:`repro_torch.core.hoststate.init_host_state` (no ``mesh``).
    """
    if _backend(cfg) == "host":
        from .hoststate import init_host_state
        if mesh is not None:
            raise ValueError("state_backend='host' is a single-host "
                             "backend (mesh must be None)")
        return init_host_state(cfg, params0, spec=spec, device=device)
    _check_supported(cfg)
    _check_compress(cfg, spec is not None)
    if spec is not None:
        w0 = spec.flatten(params0)
    else:
        w0 = tree_map(torch.as_tensor, params0)
    single = mesh is None
    if single:
        mesh = ClientMesh((resolve_device(device),))
    elif device is not None:
        raise ValueError("pass device= or mesh=, not both")
    check_divisible(cfg.n_clients, mesh)
    delays = (None,) * mesh.size
    if cfg.max_staleness is not None:
        delays = shard_rows(delay_schedule(
            cfg.n_clients, cfg.max_staleness, kind=cfg.staleness_schedule,
            seed=cfg.seed, device=mesh.devices[0]), mesh)
    shards = tuple(_init_shard(cfg, w0, cfg.n_clients // mesh.size, dev, d)
                   for dev, d in zip(mesh.devices, delays, strict=True))
    return shards[0] if single else shards


def _epoch_indices(keys: torch.Tensor, n_points: int, batch_size: int,
                   epochs: int) -> torch.Tensor:
    """(..., steps, batch) minibatch indices for keys (..., 2): per key,
    ``epochs`` shuffled passes, each the first ⌊n/b⌋·b of a permutation.

    The batch size is clamped to the shard size, as in the reference.
    """
    batch_size = min(batch_size, n_points)
    per_epoch = n_points // batch_size
    perms = prng.permutation(prng.split(keys, epochs), n_points)
    perms = perms[..., : per_epoch * batch_size]
    return perms.reshape(*keys.shape[:-1], epochs * per_epoch, batch_size)


def _local_solve(loss_fn: Callable, spec: FlatSpec | None, theta0, center,
                 x, y, idx, *, rho: float, lr: float, momentum: float,
                 control=None):
    """Inexact prox update (Eq. 2.3) for a batch of clients at once.

    SGD with momentum on f_i(θ) + ρ/2‖θ − c‖².  theta0/center: stacked
    (C, ...) trees — (C, D) rows with ``spec``, the stacked params dict
    without; x: (C, n, ...); y: (C, n); idx: (C, steps, batch).  The
    per-client gradient is ``torch.func.vmap`` of ``grad_and_value`` of
    ``loss_fn`` on the stacked params dict (the row views unflatten to
    it on the flat layout); the update runs leaf by leaf.  ``control``
    = (c, c_i), the unstacked server and stacked client control
    variates, makes each gradient g + c − c_i (SCAFFOLD's drift
    correction).  Returns (the stacked solution, (C,) mean loss over
    the steps).
    """
    vg = torch.func.vmap(torch.func.grad_and_value(loss_fn))
    theta = tree_map(lambda t: t.contiguous().clone(), theta0)
    buf = tree_zeros_like(theta)
    rows = torch.arange(idx.shape[0], device=idx.device)[:, None]
    losses = []
    for step in range(idx.shape[1]):
        ib = idx[:, step]
        params = theta if spec is None else spec.unflatten_stacked(theta)
        grads, loss = vg(params, x[rows, ib], y[rows, ib])
        g = grads if spec is None else spec.flatten_stacked(grads)
        if control is not None:
            g = tree_map(lambda gl, c, ci: gl + c - ci, g, *control)
        if rho:
            g = tree_map(lambda gl, p, c: gl + rho * (p - c), g, theta,
                         center)
        theta, buf = sgd_step(theta, g, buf, lr, momentum)
        losses.append(loss)
    return theta, torch.stack(losses, dim=1).mean(dim=1)


def _masked_local_solve(loss_fn: Callable, spec: FlatSpec | None, theta0,
                        center, x, y, offset, size, idx, *, rho: float,
                        lr: float, momentum: float):
    """:func:`_local_solve` over ragged clients' CSR slices of one pool.

    x: (R, ...) and y: (R,) the pooled rows, shared by the C clients;
    offset, size: (C,) each client's CSR slice; idx: (C, steps, batch)
    virtual indices in [0, bucket capacity).  A virtual row at or past
    the client's size is padding: it reads the client's last row (the
    global row ``offset + min(idx, size − 1)`` stays inside its slice)
    with weight 0 in :func:`engine.masked_batch_loss`, so neither the
    loss nor the gradient sees it.  A step whose batch is all padding
    leaves the client's θ, momentum buffer and reported loss as they
    were (``torch.where`` per client row), and the mean loss is over the
    live steps only.  With ``size`` equal to the capacity every weight
    is 1 and no step is skipped.  Returns (the stacked solution, (C,)
    mean loss).
    """
    vg = torch.func.vmap(torch.func.grad_and_value(
        lambda p, xb, yb, w: masked_batch_loss(loss_fn, p, xb, yb, w)))
    theta = tree_map(lambda t: t.contiguous().clone(), theta0)
    buf = tree_zeros_like(theta)
    offset = offset.long()[:, None]
    size = size.long()[:, None]
    losses, lives = [], []
    for step in range(idx.shape[1]):
        ib = idx[:, step]
        weights = (ib < size).to(torch.float32)
        live = torch.sum(weights, dim=1) > 0
        rows = offset + torch.minimum(ib, size - 1)
        params = theta if spec is None else spec.unflatten_stacked(theta)
        grads, loss = vg(params, x[rows], y[rows], weights)
        g = grads if spec is None else spec.flatten_stacked(grads)
        if rho:
            g = tree_map(lambda gl, p, c: gl + rho * (p - c), g, theta,
                         center)
        new_theta, new_buf = sgd_step(theta, g, buf, lr, momentum)
        theta = tree_where(live, new_theta, theta)
        buf = tree_where(live, new_buf, buf)
        losses.append(loss)
        lives.append(live.to(torch.float32))
    losses, lives = torch.stack(losses, dim=1), torch.stack(lives, dim=1)
    return theta, (torch.sum(losses * lives, dim=1)
                   / torch.clamp(torch.sum(lives, dim=1), min=1.0))


def _solvers(cfg: FLConfig, loss_fn: Callable, spec: FlatSpec | None,
             n_points: int):
    """(solver, masked_solver, epoch_fn) of the round's local solves:
    :func:`_local_solve` and :func:`_masked_local_solve` with the
    config's ρ, learning rate and momentum, and the minibatch indices of
    ``epochs`` passes over ``n_points``."""
    def solver(theta0, center, xs, ys, idx):
        with span("fedback/solve"):
            return _local_solve(loss_fn, spec, theta0, center, xs, ys, idx,
                                rho=cfg.local_rho(), lr=cfg.lr,
                                momentum=cfg.momentum)

    def masked_solver(theta0, center, xs, ys, offsets, sizes, idx):
        with span("fedback/solve"):
            return _masked_local_solve(
                loss_fn, spec, theta0, center, xs, ys, offsets, sizes, idx,
                rho=cfg.local_rho(), lr=cfg.lr, momentum=cfg.momentum)

    def epoch_fn(keys):
        return _epoch_indices(keys, n_points, cfg.batch_size, cfg.epochs)

    return solver, masked_solver, epoch_fn


def _compact_block(cfg: FLConfig, solvers, n_shards: int, flat: bool,
                   ragged: RaggedSpec | None, *, keep_old_rows: bool):
    """The compact round's plan → solve → commit block
    (``compact.make_compact_block``) of one shard of ``n_shards``, with
    ``solvers`` those of :func:`_solvers`; its C is ``block.capacity``."""
    solver, masked_solver, epoch_fn = solvers
    is_admm = cfg.algorithm in ADMM_FAMILY
    c_min, cap = capacity_bounds(cfg.n_clients, cfg.participation,
                                 cfg.capacity_slack, cfg.capacity,
                                 n_shards=n_shards)
    block = make_compact_block(
        solver, epoch_fn, cap, warm_start=cfg.warm_start, is_admm=is_admm,
        c_min=c_min, adaptive=cfg.adaptive_capacity and cfg.capacity is None,
        alpha=_ctrl_cfg(cfg).alpha, fused=cfg.fused_gss,
        use_admm_kernel=is_admm and flat, keep_old_rows=keep_old_rows,
        ragged=ragged, masked_solver=masked_solver)
    block.capacity, block.c_min = cap, c_min
    return block


def make_round_fn(cfg: FLConfig, loss_fn: Callable, data: dict, *,
                  spec: FlatSpec | None = None, device=None,
                  mesh: ClientMesh | None = None,
                  ctrl_arg: bool = False, arrivals_arg: bool = False,
                  ragged: RaggedSpec | None = None,
                  body_transform: Callable | None = None) -> Callable:
    """Build ``round_fn(state) -> (state, RoundMetrics)``.

    loss_fn(params, x_batch, y_batch) -> scalar mean loss, on the params
    dict of one client (``torch.func`` batches it over clients).
    data: {"x": (N, n_i, ...), "y": (N, n_i)} tensors or arrays, moved to
    ``device`` (CUDA by default).  ``spec``: the flat layout's codec, as
    given to :func:`init_state` (None: the tree layout).  With
    ``compact`` and ``fused_gss`` the round updates the state's
    θ/λ/z_prev in place.

    With ``mesh`` (no ``device`` then) the round takes and returns the
    shard list of ``init_state(..., mesh=mesh)`` and cuts the data the
    same way.  Each shard runs its clients' part of the round on its own
    device — K1b on its rows, its own plan, deferral queue and ⌈C/P⌉
    slots with K3 on its rows in the compact form, K2b in the dense
    form — from the replicated key, whose per-client minibatch keys
    ``split(data_rng, N)`` are cut by shard.  The collectives add
    per-shard partials in shard order on shard 0's device: ω (the one
    result copied to every shard), the participants' mean, the event,
    deferral and loss counts, and the realized capacity (the sum of the
    shards' commit limits).  The metrics' (N,) vectors are gathered on
    shard 0's device in shard order.

    ``cfg.max_staleness`` makes the round stale-tolerant (the module
    docstring); its pipeline rows stay on their shard's device, and each
    shard clamps its controller with its own delays.  ``arrivals_arg``
    builds ``round_fn(state, arrivals)`` (with ``mesh``, ``round_fn(
    shards, arrivals)``, the (N,) mask cut by shard): the serve step;
    with all-ones arrivals it is the plain round bit for bit.
    ``ctrl_arg`` builds ``round_fn(state, ctrl_overrides)`` (with
    ``arrivals_arg`` too, ``round_fn(state, ctrl_overrides, arrivals)``):
    ``ctrl_overrides`` is a dict of 0-d fp32 tensors (``"K"``,
    ``"target_rate"``) that replace the controller's gain and target in
    its step, where the round's shards take a copy on their device;
    ``{"K": k}`` gives the bits of a round built with
    ``ControllerConfig(K=k)``.

    ``ragged`` (a :class:`~repro_torch.utils.ragged.RaggedSpec`): data
    is the pooled {"x": (Σnᵢ + pad, ...), "y": (Σnᵢ + pad,)} buffer the
    spec describes (``utils.ragged.pool_data``,
    ``data.federated_pooled``); the module docstring says how it is
    solved.  With ``mesh`` each shard's device gets a copy of the pool
    and the offsets and sizes of its clients.

    With ``cfg.state_backend="host"`` the round of
    :func:`repro_torch.core.hoststate.make_host_round_fn`, which takes
    the :class:`~repro_torch.core.state.HostState` of :func:`init_state`.

    ``body_transform`` (the reference's mutation hook, which
    :mod:`repro_torch.analysis` seeds its self-tests through) is for the
    host backend, where it wraps the round's solve leg; a device round
    is wrapped by its caller, so there it raises ``ValueError``.
    """
    if _backend(cfg) == "host":
        from .hoststate import make_host_round_fn
        return make_host_round_fn(cfg, loss_fn, data, spec=spec,
                                  device=device, mesh=mesh,
                                  ctrl_arg=ctrl_arg,
                                  arrivals_arg=arrivals_arg, ragged=ragged,
                                  body_transform=body_transform)
    if body_transform is not None:
        raise ValueError("body_transform wraps the host backend's solve "
                         "leg; wrap a device round where it is called")
    _check_supported(cfg)
    n = cfg.n_clients
    if mesh is None:
        sharded, mesh = False, ClientMesh((resolve_device(device),))
    elif device is not None:
        raise ValueError("pass device= or mesh=, not both")
    else:
        sharded = True
        check_divisible(n, mesh)
    for dev in set(mesh.devices):
        fp32_products(dev)
    flat = spec is not None
    compress = _check_compress(cfg, flat)
    n_local = n // mesh.size
    x0 = torch.as_tensor(data["x"])
    if ragged is None:
        if x0.shape[0] != n:
            raise ValueError(f"data has {x0.shape[0]} clients, "
                             f"cfg.n_clients={n}")
        n_points = x0.shape[1]
        shard_data = shard_client_data(mesh, {"x": x0, "y": data["y"]})
        shard_csr, buckets = [{}] * mesh.size, [None] * mesh.size
    else:
        if ragged.n_clients != n:
            raise ValueError(f"ragged spec describes {ragged.n_clients} "
                             f"clients, cfg.n_clients={n}")
        if x0.shape[0] != ragged.buffer_rows:
            raise ValueError(f"pooled data has {x0.shape[0]} rows, the "
                             f"ragged spec {ragged.buffer_rows}")
        # The compact slots' epoch length; the dense round takes each
        # bucket's capacity instead.
        n_points = ragged.max_size
        # The pool has no client axis: every shard's device gets a copy
        # (one copy where shards share a device), and each shard the
        # offsets and sizes of its clients, global rows of the pool.
        shard_data = replicate_data(mesh, {"x": x0, "y": data["y"]})
        shard_csr = shard_rows(
            {"offsets": ragged.offsets_array(device=mesh.devices[0]),
             "sizes": ragged.sizes_array(device=mesh.devices[0])}, mesh)
        buckets = [_bucket_tables(ragged, i * n_local, n_local, dev)
                   for i, dev in enumerate(mesh.devices)]
    is_admm = cfg.algorithm in ADMM_FAMILY
    if cfg.fused_gss and not (cfg.compact and is_admm and flat):
        raise ValueError(
            "fused_gss=True needs compact=True, an ADMM-family "
            "algorithm and the flat (spec=) layout — got "
            f"compact={cfg.compact}, algorithm={cfg.algorithm!r}, "
            f"flat={flat}")
    selects = _shard_selections(cfg, mesh)
    select = selects[0]  # decides for every shard (its L̄ is not read)
    async_mode = cfg.max_staleness is not None
    solver, masked_solver, epoch_fn = _solvers(cfg, loss_fn, spec, n_points)
    if cfg.compact:
        block = _compact_block(cfg, (solver, masked_solver, epoch_fn),
                               mesh.size, flat, ragged,
                               keep_old_rows=async_mode and cfg.fused_gss)

    def trigger(shards):
        if cfg.trigger_metric != "l2":
            return [trigger_distances(s.omega, s.z_prev, cfg.trigger_metric)
                    for s in shards]
        if sharded:
            sq = ops.trigger_sq_norms_pytree([s.z_prev for s in shards],
                                             [s.omega for s in shards],
                                             mesh=mesh)
        else:
            sq = [ops.trigger_sq_norms_pytree(shards[0].z_prev,
                                              shards[0].omega)]
        return [torch.sqrt(x) for x in sq]

    def presolve(shards):
        """(λ⁺, prox centers) per shard for the dense round."""
        if is_admm and flat:
            args = ([s.theta for s in shards], [s.lam for s in shards],
                    [s.omega for s in shards])
            if sharded:
                return list(zip(*ops.admm_update(*args, with_z=False,
                                                 mesh=mesh), strict=True))
            return [ops.admm_update(*(a[0] for a in args), with_z=False)]
        if is_admm:
            return [(lam, prox_center(s.omega, lam)) for s, lam in (
                (s, dual_ascent(s.lam, s.theta, s.omega)) for s in shards)]
        return [(s.lam, tree_broadcast_like(s.omega, n_local))
                for s in shards]

    def dense_client_update(s, lam_new, center, sd, keys, tables):
        """All the shard's solves; returns service proposals (θ_out, λ⁺,
        z, losses).  With ``ragged`` one solve per size bucket
        (``tables``: the shard's members of each bucket)."""
        theta_init = (tree_broadcast_like(s.omega, n_local)
                      if cfg.warm_start else s.theta)
        if ragged is None:
            with span("fedback/minibatch_rng"):
                idx = epoch_fn(keys)
            theta_out, losses = solver(theta_init, center, sd["x"], sd["y"],
                                       idx)
        else:
            theta_out, losses = ragged_dense_solve(theta_init, center, sd,
                                                   keys, tables)
        z_new = (tree_map(torch.add, theta_out, lam_new) if is_admm
                 else theta_out)
        return theta_out, lam_new, z_new, losses

    def ragged_dense_solve(theta_init, center, sd, keys, tables):
        """One batched solve per size bucket over the pooled rows, each
        at its bucket's capacity: the plain solve on the members' row
        blocks where no member is padded, the masked one on the pool
        otherwise; the rows are written back in client order (every
        client is in one bucket)."""
        theta_out = tree_map(torch.empty_like, theta_init)
        losses = torch.empty((n_local,), dtype=torch.float32,
                             device=keys.device)
        for bucket, members, offsets, sizes in tables:
            with span("fedback/minibatch_rng"):
                idx = _epoch_indices(keys[members], bucket.capacity,
                                     cfg.batch_size, cfg.epochs)
            rows = (gather_rows(theta_init, members),
                    gather_rows(center, members))
            if bucket.padded:
                th, ls = masked_solver(*rows, sd["x"], sd["y"], offsets,
                                       sizes, idx)
            else:
                blocks = [gather_blocks(sd[k], offsets, bucket.capacity)
                          for k in ("x", "y")]
                th, ls = solver(*rows, *blocks, idx)
            tree_map(lambda out, r: out.index_copy_(0, members, r),
                     theta_out, th)
            losses.index_copy_(0, members, ls)
        return theta_out, losses

    def overrides_on(ctrl_overrides, shards):
        """The overrides per shard, each on its shard's device."""
        if not ctrl_overrides:
            return [None] * len(shards)
        collectives.add("broadcast", [ctrl_overrides] * (len(shards) - 1))
        return [{k: v.to(s.rng.device, non_blocking=True)
                 for k, v in ctrl_overrides.items()} for s in shards]

    def select_events(shards, distances, sel_rng, arrivals, overrides):
        """(events, eligible, ctrls) per shard.  Under staleness a client
        with a solve in flight is ineligible and the controller steps
        later, on the commit-time events (ctrls None); with arrivals,
        fresh events come from this tick's arrivals only (the k-subset
        strategies draw among them) while the plan's eligibility is
        left alone, so queued demand is served without re-arrival."""
        if async_mode:
            eligible = [s.inflight.ttl == 0 for s in shards]
            admit = eligible if arrivals is None else [
                e & a for e, a in zip(eligible, arrivals, strict=True)]
        else:
            eligible, admit = None, arrivals
        events = select.decide_shards(sel_rng, shards, distances, mesh,
                                      eligible=admit)
        if admit is not None:
            events = [e & a for e, a in zip(events, admit, strict=True)]
        ctrls = None if async_mode else [
            sel.measure(s.ctrl, e, o) for sel, s, e, o in zip(
                selects, shards, events, overrides, strict=True)]
        return events, eligible or [None] * len(shards), ctrls

    def stale_commit(sel, s, e, serviced, proposals, old, overrides):
        """The bounded-staleness commit of one shard: the proposals
        routed through its delay pipeline, the ring updated and the
        controller stepped on the commit-time events.  ``old`` (the
        fused commit's slots and their rows before it) routes the
        in-place proposals row by row instead.  Returns (θ, λ, z_prev,
        InFlight, ctrl, committed, landed)."""
        fl = s.inflight
        land, direct, defer, new_ttl = staleness_masks(serviced, fl.delay,
                                                       fl.ttl)
        current = (s.theta, s.lam, s.z_prev)
        parked = (fl.theta, fl.lam, fl.z)
        if old is None:
            out = [staleness_commit(c, p, k, land, direct, defer)
                   for c, p, k in zip(current, proposals, parked,
                                      strict=True)]
        else:
            idx, valid, rows = old
            out = [staleness_commit_slots(live, k, r, idx, valid, land,
                                          defer)
                   for live, k, r in zip(proposals, parked, rows,
                                         strict=True)]
        (theta, p_th), (lam, p_lam), (z, p_z) = out
        hist = record_issue(fl.hist, e, s.round)
        ctrl = sel.measure(s.ctrl, measured_commits(hist, fl.delay,
                                                       s.round),
                              overrides, staleness_delay=fl.delay)
        new_fl = InFlight(delay=fl.delay, ttl=new_ttl, theta=p_th,
                          lam=p_lam, z=p_z, hist=hist)
        return theta, lam, z, new_fl, ctrl, direct | land, land

    def round_body(shards, ctrl_overrides=None, arrivals=None):
        s0 = shards[0]
        dev0 = s0.rng.device
        overrides = overrides_on(ctrl_overrides, shards)
        with span("fedback/trigger_select"):
            rng, sel_rng, data_rng = prng.split(s0.rng, 3)
            distances = trigger(shards)
            events, eligible, ctrls = select_events(shards, distances,
                                                    sel_rng, arrivals,
                                                    overrides)
        keys = shard_rows(prng.split(data_rng, n), mesh)
        proposals, serviced, losses, loss_mask, queues, olds = \
            [], [], [], [], [], []
        zero = torch.zeros((), dtype=torch.int32, device=dev0)
        if cfg.compact:
            limits, deferred = [], []
            for s, e, d, el, sd, k, csr in zip(shards, events, distances,
                                               eligible, shard_data, keys,
                                               shard_csr, strict=True):
                (theta, lam, z_prev, q_age, q_load, done, ls, valid,
                 limit, old) = block(e, d, el, s.queue.age, s.queue.load,
                                     s.theta, s.lam, s.z_prev, s.omega,
                                     sd["x"], sd["y"], k, **csr)
                proposals.append((theta, lam, z_prev))
                queues.append(s.queue._replace(age=q_age, load=q_load))
                serviced.append(done)
                losses.append(ls)
                loss_mask.append(valid)
                limits.append(limit)
                olds.append(old)
                deferred.append(torch.sum((q_age > 0).to(torch.int32)))
            realized_capacity = all_sum(limits)
            num_deferred = all_sum(deferred).to(torch.int32)
        else:
            with span("fedback/presolve"):
                pre = presolve(shards)
            for s, (lam_new, center), sd, k, tables in zip(
                    shards, pre, shard_data, keys, buckets, strict=True):
                theta_p, lam_p, z_p, ls = dense_client_update(
                    s, lam_new, center, sd, k, tables)
                proposals.append((theta_p, lam_p, z_p))
                queues.append(s.queue)
                losses.append(ls)
                olds.append(None)
            serviced = loss_mask = events
            realized_capacity = torch.full((), n, dtype=torch.int32,
                                           device=dev0)
            num_deferred = zero
        new, committed = [], []
        num_inflight = num_landed = zero
        with span("fedback/commit"):
            if async_mode:
                ctrls, inflight, ttls, landed = [], [], [], []
                for sel, s, e, done, prop, old, o in zip(
                        selects, shards, events, serviced, proposals, olds,
                        overrides, strict=True):
                    theta, lam, z, fl, ctrl, done, land = stale_commit(
                        sel, s, e, done, prop, old, o)
                    new.append((theta, lam, z))
                    inflight.append(fl)
                    ctrls.append(ctrl)
                    committed.append(done)
                    ttls.append(torch.sum((fl.ttl > 0).to(torch.int32)))
                    landed.append(torch.sum(land.to(torch.int32)))
                num_inflight = all_sum(ttls).to(torch.int32)
                num_landed = all_sum(landed).to(torch.int32)
            elif cfg.compact:
                new, committed = proposals, serviced
                inflight = [s.inflight for s in shards]
            else:
                for s, e, (theta_p, lam_p, z_p) in zip(shards, events,
                                                       proposals,
                                                       strict=True):
                    new.append((gated_commit(e, theta_p, s.theta),
                                gated_commit(e, lam_p, s.lam),
                                gated_commit(e, z_p, s.z_prev)))
                committed = events
                inflight = [s.inflight for s in shards]
        num_events = all_sum([torch.sum(e.to(torch.int32))
                              for e in events]).to(torch.int32)
        z_prev = [z for _, _, z in new]
        comm = [s.comm for s in shards]
        with span("fedback/consensus"):
            num_committed = None if is_admm else all_sum(
                [torch.sum(c.to(torch.int32)) for c in committed])
            if compress != "none":
                ef = dict(mode=compress, block=cfg.compress_block, mesh=mesh)
                if is_admm:
                    omega, comm = ef_consensus(z_prev, s0.omega, comm, **ef)
                else:
                    omega, comm = ef_participant_mean(
                        z_prev, committed, s0.omega, comm, num_committed,
                        **ef)
            elif is_admm:
                omega = consensus_mean(z_prev)
            else:  # the non-weighted mean over this round's uploads
                omega = participant_mean(z_prev, committed, s0.omega,
                                         num_events=num_committed)
        rate_floor = cfg.participation * n
        metrics = RoundMetrics(
            events=unshard_rows(events),
            num_events=num_events,
            distances=unshard_rows(distances),
            delta=unshard_rows([c.delta for c in ctrls]),
            load=unshard_rows([c.load for c in ctrls]),
            train_loss=participant_mean_loss(losses, loss_mask),
            num_deferred=num_deferred,
            realized_capacity=realized_capacity,
            realized_slack=(realized_capacity.to(torch.float32)
                            / (rate_floor if rate_floor > 0 else 1.0)),
            num_inflight=num_inflight,
            num_landed=num_landed,
            committed=unshard_rows(committed),
        )
        replicas = zip(replicate_data(mesh, omega), replicate_data(mesh, rng),
                       replicate_data(mesh, s0.round + 1), strict=True)
        new_shards = tuple(
            FLState(theta=theta, lam=lam, z_prev=z, omega=w, ctrl=ctrl,
                    rng=key, round=rnd, queue=queue, inflight=fl, comm=e)
            for (theta, lam, z), queue, fl, ctrl, e, (w, key, rnd) in zip(
                new, queues, inflight, ctrls, comm, replicas, strict=True))
        return new_shards, metrics

    def body(state, ctrl_overrides=None, arrivals=None):
        if arrivals is not None:
            arrivals = shard_rows(torch.as_tensor(arrivals), mesh)
        if sharded:
            return round_body(state, ctrl_overrides, arrivals)
        (new_state,), metrics = round_body((state,), ctrl_overrides,
                                           arrivals)
        return new_state, metrics

    if ctrl_arg and arrivals_arg:
        round_fn = body
    elif ctrl_arg:
        def round_fn(state, ctrl_overrides):
            return body(state, ctrl_overrides)
    elif arrivals_arg:
        def round_fn(state, arrivals):
            return body(state, None, arrivals)
    else:
        def round_fn(state):
            return body(state)
    return round_fn


def _bucket_tables(ragged: RaggedSpec, first: int, n_local: int, device):
    """The dense ragged round's per-bucket tables for the shard holding
    clients [first, first + n_local): (bucket, the shard's members as
    local rows, their offsets and sizes), int64 on ``device``, for each
    bucket with a member there.  Built once, with the round."""
    def put(v):
        return torch.tensor(v, dtype=torch.int64, device=device)

    tables = []
    for bucket in ragged.buckets:
        mine = [m for m in bucket.members if first <= m < first + n_local]
        if mine:
            tables.append((bucket, put([m - first for m in mine]),
                           put([ragged.offsets[m] for m in mine]),
                           put([ragged.sizes[m] for m in mine])))
    return tables


def make_eval_fn(loss_and_acc_fn: Callable, *,
                 spec: FlatSpec | None = None, device=None) -> Callable:
    """eval_fn(state, x, y) -> (loss, accuracy) of the server ω, on
    ``device`` (CUDA by default; x and y are moved there).  With
    ``spec`` the flat ω is unflattened to the params dict; without, ω is
    the tree layout's dict."""
    device = resolve_device(device)

    def eval_fn(state, x, y):
        if not hasattr(state, "omega"):  # a client mesh's shard list
            state = state[0]
        omega = tree_map(lambda w: w.to(device), state.omega)
        params = omega if spec is None else spec.unflatten(omega)
        return loss_and_acc_fn(params, x.to(device), y.to(device))

    return eval_fn


def run_rounds(round_fn: Callable, state, num_rounds: int):
    """Run ``num_rounds`` rounds from ``state`` (an ``FLState``, a client
    mesh's shard list or a ``HostState``); metrics stacked along a
    leading axis.

    Nothing is read back to the host inside the loop (the host backend's
    round reads its plan back itself).
    """
    history = []
    for _ in range(num_rounds):
        state, m = round_fn(state)
        history.append(m)
    if not history:
        return state, None
    return state, RoundMetrics(*(torch.stack(f) for f in zip(*history,
                                                              strict=True)))


def run_evaluated(round_fn: Callable, eval_fn: Callable, state,
                  num_rounds: int, test: dict, *, every: int = 10,
                  extra: tuple = ()):
    """Run ``num_rounds`` rounds from ``state``, reading back each round's
    participation events, and the test accuracy (``eval_fn``'s second
    output on ``test["x"]``, ``test["y"]``) after rounds 0, ``every``,
    2·``every``, ... and the last, and after each round in ``extra``.

    Returns (state, events per round, the accuracies at those rounds in
    order, {round: accuracy} for ``extra``).
    """
    events, accs, extra_accs = [], [], {}
    for k in range(num_rounds):
        state, m = round_fn(state)
        events.append(int(m.num_events))
        scheduled = k % every == 0 or k == num_rounds - 1
        if scheduled or k in extra:
            acc = float(eval_fn(state, test["x"], test["y"])[1])
            if k in extra:
                extra_accs[k] = acc
            if scheduled:
                accs.append(acc)
    return state, events, accs, extra_accs


def events_to_accuracy(events: list, accs: list, target: float, *,
                       every: int = 10):
    """The participation events of the rounds up to and including the
    first of :func:`run_evaluated`'s evaluations (``every`` rounds apart)
    whose accuracy reaches ``target``; None if none does."""
    for i, acc in enumerate(accs):
        if acc >= target:
            return sum(events[:min(i * every, len(events) - 1) + 1])
    return None

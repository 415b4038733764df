"""Capacity-bounded compaction (port of ``repro/core/compact.py``).

After selection, this round's *demand* — fresh trigger events plus the
deferral queue — is ranked and the top slots, up to the round's commit
limit, are gathered into C = ⌈slack·L̄·N⌉ capacity slots; the local
solve runs over C rows of state and data instead of N, and committed
rows are written back.  Overflow stays in the queue (``DeferQueue``)
with age-ordered, starvation-free priority.  The per-round limit
follows the demand-load estimate within [⌈L̄·N⌉, C].

Two places needed care to reproduce the reference exactly:

* **Ranking.**  torch has no ``lexsort``; the plan chains stable sorts
  from the least significant key to the most (index, −priority, −age,
  ~demand), which gives the same order.
* **Commit limit.**  ⌈Σ load⌉ flips by one when the fp32 sum lands
  within an ulp of an integer, so :func:`sum_in_xla_cpu_order` adds the
  loads in the order XLA's CPU backend does.

Under a client mesh (``core/fedback.py``, ``mesh=``) the block runs
per shard, as the reference's ``shard_map``-ped block does: each shard
plans, solves and commits its own clients with ⌈C/P⌉ slots
(:func:`capacity_for` with ``n_shards``), its own deferral queue (a
deferred client never migrates) and local row indices.  Under bounded
staleness the plan takes the round's eligibility (nothing in flight):
an ineligible client leaves the demand set.  With ragged clients
(``ragged=``) each slot reads its client's CSR slice of the pooled
data at the static max(nᵢ) epoch length.
"""
from __future__ import annotations

import math
from typing import Callable, NamedTuple

import torch

from repro_torch.device import resolve_device
from repro_torch.utils.pytree import rows_mask, tree_broadcast_like, \
    tree_map
from repro_torch.utils.spans import span

from .controller import demand_load_step
from .engine import dual_ascent, prox_center
from .state import DeferQueue


class CompactPlan(NamedTuple):
    idx: torch.Tensor  # (C,) int32 — client row feeding each slot
    valid: torch.Tensor  # (C,) bool — slot carries a demand client
    committed: torch.Tensor  # (N,) bool — in demand AND within the limit
    num_deferred: torch.Tensor  # () int32 — demand beyond the limit
    demand: torch.Tensor  # (N,) bool — fresh events ∪ carried deferrals
    num_demand: torch.Tensor  # () int32
    limit: torch.Tensor  # () int32 — rows this plan may commit (≤ C)


def init_queue(n_clients: int, device=None) -> DeferQueue:
    """Empty queue; load starts at 1 (every client fires in round 0).
    On ``device``: CUDA unless another is passed."""
    device = resolve_device(device)
    return DeferQueue(
        age=torch.zeros((n_clients,), dtype=torch.int32, device=device),
        load=torch.ones((n_clients,), dtype=torch.float32, device=device))


def capacity_for(n_clients: int, rate: float, slack: float,
                 capacity: int | None = None, *, n_shards: int = 1) -> int:
    """Static per-shard slot count C.

    ``capacity`` (if given) is the global solver-row budget; otherwise
    C_global = ⌈slack·L̄·N⌉.  The per-shard budget rounds up
    (⌈C_global/n_shards⌉, so the shards together never lose the
    remainder) and is clamped to [1, local client count].
    """
    total = capacity if capacity is not None else math.ceil(
        slack * rate * n_clients)
    if n_clients % n_shards:
        raise ValueError(
            f"n_clients={n_clients} must be divisible by n_shards="
            f"{n_shards} (equal-size client shards)")
    n_local = n_clients // n_shards
    return max(1, min(math.ceil(total / n_shards), n_local))


def capacity_bounds(n_clients: int, rate: float, slack: float,
                    capacity: int | None = None, *,
                    n_shards: int = 1) -> tuple[int, int]:
    """(C_min, C_max) per shard: the participation floor ⌈L̄·n_local⌉ and
    the slot count."""
    c_max = capacity_for(n_clients, rate, slack, capacity,
                         n_shards=n_shards)
    n_local = n_clients // n_shards
    c_min = max(1, min(math.ceil(rate * n_local), c_max))
    return c_min, c_max


def sum_in_xla_cpu_order(x: torch.Tensor, window: int = 32) -> torch.Tensor:
    """fp32 sum over the leading axis, adding in the order XLA's CPU
    backend uses for ``jnp.sum(x, axis=0)``: an axis longer than 32 is
    zero-padded evenly on both sides to a multiple of 32, each window of
    32 is summed first to last, and the window sums are reduced the
    same way; trailing axes are summed independently, column by column
    (the compressed consensus's column sum of an (N, D) matrix).  Every
    add is an elementwise fp32 add, so the result is the same on any
    device."""
    rest = tuple(x.shape[1:])
    while x.shape[0] > window:
        m = -(-x.shape[0] // window)
        pad = m * window - x.shape[0]
        x = torch.nn.functional.pad(
            x, (0, 0) * len(rest) + (pad // 2, pad - pad // 2))
        cols = x.view((m, window) + rest)
        acc = torch.zeros((m,) + rest, dtype=x.dtype, device=x.device)
        for j in range(window):
            acc = acc + cols[:, j]
        x = acc
    acc = torch.zeros(rest, dtype=x.dtype, device=x.device)
    for j in range(x.shape[0]):
        acc = acc + x[j]
    return acc


def adaptive_limit(qload: torch.Tensor, c_min: int,
                   c_max: int) -> torch.Tensor:
    """Per-round commit limit clip(⌈Σ load⌉, c_min, c_max), () int32."""
    est = torch.ceil(sum_in_xla_cpu_order(qload)).to(torch.int32)
    return torch.clamp(est, c_min, c_max)


def _stable_order(keys) -> torch.Tensor:
    """Lexicographic ascending order over ``keys`` (most significant
    last, as ``jnp.lexsort``), by chained stable sorts."""
    order = None
    for k in keys:
        k = k if order is None else k[order]
        perm = torch.sort(k, stable=True).indices
        order = perm if order is None else order[perm]
    return order


def compact_plan(events: torch.Tensor, priority: torch.Tensor,
                 capacity: int, *, age: torch.Tensor | None = None,
                 limit: torch.Tensor | int | None = None,
                 eligible: torch.Tensor | None = None) -> CompactPlan:
    """Assign demand (events ∪ queue) to capacity slots.

    Order: demand first, then age descending, then priority descending,
    then client index ascending — the reference's ``jnp.lexsort``.
    """
    n = events.shape[0]
    dev = events.device
    if age is None:
        age = torch.zeros((n,), dtype=torch.int32, device=dev)
    demand = events | (age > 0)
    if eligible is not None:
        demand = demand & eligible
    # The index key is already in ascending order, so the chain starts
    # at −priority (a stable sort keeps index order among ties).
    order = _stable_order((-priority.to(torch.float32), -age,
                           (~demand).to(torch.int8)))
    idx = order[:capacity].to(torch.int32)
    num_demand = torch.sum(demand.to(torch.int32)).to(torch.int32)
    if isinstance(limit, torch.Tensor):
        lim = torch.clamp(limit.to(torch.int32), max=capacity)
    else:  # filled on the device: no host→device copy, no stream sync
        lim = torch.full((), min(capacity if limit is None else limit,
                                 capacity), dtype=torch.int32, device=dev)
    valid = (torch.arange(capacity, dtype=torch.int32, device=dev)
             < torch.minimum(num_demand, lim))
    rank = torch.empty((n,), dtype=torch.int32, device=dev)
    rank[order] = torch.arange(n, dtype=torch.int32, device=dev)
    committed = demand & (rank < lim)
    return CompactPlan(
        idx=idx, valid=valid, committed=committed,
        num_deferred=torch.clamp(num_demand - lim, min=0),
        demand=demand, num_demand=num_demand, limit=lim)


def queue_update(queue: DeferQueue, plan: CompactPlan, *,
                 alpha: float) -> DeferQueue:
    """Served clients leave the queue (age → 0); unserved demand ages by
    one; the demand EMA takes one Eq. 3.4 step."""
    new_age = torch.where(plan.demand & ~plan.committed, queue.age + 1,
                          torch.zeros_like(queue.age))
    return DeferQueue(age=new_age.to(torch.int32),
                      load=demand_load_step(queue.load, plan.demand, alpha))


def gather_rows(tree, idx: torch.Tensor):
    """Rows ``idx`` of every (N, ...) leaf as (C, ...) leaves."""
    i = idx.long()
    return tree_map(lambda x: x[i], tree)


def gather_blocks(pool: torch.Tensor, offsets: torch.Tensor,
                  length: int) -> torch.Tensor:
    """The (C, length, ...) blocks of ``pool``'s rows starting at each of
    the (C,) ``offsets``: a gather, so a block that ran past the pool's
    end would fail on its index, never come back short (a ragged spec's
    padding keeps every client's ``max(nᵢ)``-row block inside the
    pool)."""
    rows = offsets.long()[:, None] + torch.arange(length,
                                                  device=offsets.device)
    return pool[rows]


def scatter_rows(current, rows, idx: torch.Tensor, valid: torch.Tensor):
    """A copy of ``current`` with slot rows written back where ``valid``
    (indices are distinct, so an invalid slot rewrites its own row)."""
    i = idx.long()

    def put(c, r):
        out = c.clone()
        out[i] = torch.where(rows_mask(valid, r), r.to(out.dtype), c[i])
        return out

    return tree_map(put, current, rows)


def make_compact_block(solver: Callable, epoch_fn: Callable, capacity: int,
                       *, is_admm: bool, warm_start: bool,
                       c_min: int | None = None, adaptive: bool = False,
                       alpha: float = 0.9, fused: bool = False,
                       use_admm_kernel: bool = False,
                       keep_old_rows: bool = False, ragged=None,
                       masked_solver: Callable | None = None) -> Callable:
    """Build the plan → gather → solve → commit block of one round.

    solver(theta0, center, x, y, idx) -> (theta, losses) over C rows;
    epoch_fn(keys) -> (C, steps, batch) minibatch indices.

    Returns block(events, distances, eligible, age, qload, theta, lam,
    z_prev, omega, x, y, keys) -> (θ', λ', z', age', qload', committed,
    losses, slot_valid, limit, old).  ``eligible`` (None: everyone) is
    the stale-tolerant round's mask of clients with nothing in flight: a
    client outside it leaves the demand set, whether it fired or is
    queued.  The state outputs are service proposals, which the
    stale-tolerant caller routes through its delay pipeline.  The state
    is a stacked tree: the flat (N, D) matrices or the tree layout's
    dicts.  The ADMM family's block (``is_admm``): λ⁺ and the prox
    center before the solve, z = θ + λ⁺ at the commit.  With ``fused`` (flat only) the post-solve
    commit is one fused pass (``kernels.fused_gss``) that updates
    θ/λ/z_prev **in place**; otherwise new tensors are returned and the
    inputs are left as they were, λ⁺ and the center coming from
    ``kernels.admm_update`` on the gathered rows with
    ``use_admm_kernel`` (the flat layout, unfused) and from the plain
    dual algebra otherwise (the tree layout launches neither K2 nor K3,
    as in the reference).  The AVG family's block
    (FedAvg, FedProx) launches no state kernel: λ stays as it is (zero),
    the center is ω, and the commit scatters θ and z = θ.

    ``old`` is None unless ``keep_old_rows`` (the fused commit under
    staleness): then (plan idx, slot valid, (θ, λ, z_prev) rows at the
    slots before the commit wrote them), which
    ``engine.staleness_commit_slots`` puts back where a row parks.

    With ``ragged`` (a ``utils.ragged.RaggedSpec``) ``x``/``y`` are the
    pooled buffers and the block takes two more inputs, ``offsets`` and
    ``sizes`` (N,): the slots' clients' CSR slices.  A uniform spec
    solves each slot's ``max(nᵢ)``-row block (:func:`gather_blocks`)
    with ``solver``, which gives the rectangular block's bits; otherwise
    ``masked_solver(theta0, center, x, y, offsets, sizes, idx)`` reads
    the slots' rows of the pool in place, the values the reference's
    ``max(nᵢ)``-row slices hold.

    The block's steps after the plan are also its attributes, so that
    the host-offloaded round (``core/hoststate.py``) runs them on the
    (C, D) rows it streams in, at the same width and in the same
    operations: ``block.plan(events, distances, eligible, age, qload)``
    (the plan and the queue after it), ``block.slot_inputs(idx, x, y,
    keys_rows, offsets, sizes)`` (the slots' minibatch draws and data),
    ``block.presolve(th_rows, lam_rows, omega)`` (λ⁺, the centers and
    the starting rows), ``block.solve(theta0_rows, center_rows,
    inputs)`` and ``block.commit(idx, valid, th_out_rows, lam_new_rows,
    omega, theta, lam, z_prev)``.
    """
    from repro_torch.kernels import ops

    masked = ragged is not None and not ragged.uniform
    if masked and masked_solver is None:
        raise ValueError("non-uniform ragged compaction needs masked_solver")
    if fused and not is_admm:
        raise ValueError("fused commit is the ADMM dual algebra — "
                         "non-ADMM compaction has no λ/z streams to fuse")
    if keep_old_rows and not fused:
        raise ValueError("keep_old_rows serves the fused commit, which "
                         "writes the state in place")

    def plan_step(events, distances, eligible, age, qload):
        with span("fedback/plan"):
            limit = (adaptive_limit(qload, c_min, capacity)
                     if adaptive else None)
            plan = compact_plan(events, distances, capacity, age=age,
                                limit=limit, eligible=eligible)
            return plan, queue_update(DeferQueue(age=age, load=qload), plan,
                                      alpha=alpha)

    def block(events, distances, eligible, age, qload, theta, lam, z_prev,
              omega, x, y, keys, offsets=None, sizes=None):
        plan, queue = plan_step(events, distances, eligible, age, qload)
        th_rows = gather_rows(theta, plan.idx)
        lam_rows = gather_rows(lam, plan.idx) if is_admm else None
        lam_new_rows, center_rows, theta0_rows = presolve(th_rows, lam_rows,
                                                          omega)
        th_out_rows, losses = solve(theta0_rows, center_rows, slot_inputs(
            plan.idx, x, y, gather_rows(keys, plan.idx), offsets, sizes))
        with span("fedback/commit"):
            old = None
            if keep_old_rows:
                old = (plan.idx, plan.valid,
                       (th_rows, lam_rows, gather_rows(z_prev, plan.idx)))
            theta_new, lam_new, z_new = commit(
                plan.idx, plan.valid, th_out_rows, lam_new_rows, omega,
                theta, lam, z_prev)
        return (theta_new, lam_new, z_new, queue.age, queue.load,
                plan.committed, losses, plan.valid, plan.limit, old)

    def presolve(th_rows, lam_rows, omega):
        """(λ⁺, the prox centers, the solve's starting rows) of the
        slots' θ and λ rows; λ⁺ None outside the ADMM family."""
        with span("fedback/presolve"):
            if not is_admm:
                lam_new_rows = None
                center_rows = tree_broadcast_like(omega, capacity)
            elif use_admm_kernel and not fused:
                lam_new_rows, center_rows = ops.admm_update(
                    th_rows, lam_rows, omega, with_z=False)
            else:
                # The fused commit re-derives λ⁺ itself, so the pre-solve
                # pass stays plain torch (as in the reference).
                lam_new_rows = dual_ascent(lam_rows, th_rows, omega)
                center_rows = prox_center(omega, lam_new_rows)
            theta0_rows = (tree_broadcast_like(omega, capacity)
                           if warm_start else th_rows)
        return lam_new_rows, center_rows, theta0_rows

    def slot_inputs(idx, x, y, keys_rows, offsets=None, sizes=None):
        """The slots' minibatch indices and the data their solve reads."""
        with span("fedback/minibatch_rng"):
            idx_b = epoch_fn(keys_rows)
        if ragged is None:
            return idx_b, (gather_rows(x, idx), gather_rows(y, idx))
        if masked:
            return idx_b, (x, y, gather_rows(offsets, idx),
                           gather_rows(sizes, idx))
        return idx_b, tuple(gather_blocks(t, gather_rows(offsets, idx),
                                          ragged.max_size) for t in (x, y))

    def solve(theta0_rows, center_rows, inputs):
        idx_b, data = inputs
        if masked:
            return masked_solver(theta0_rows, center_rows, *data, idx_b)
        return solver(theta0_rows, center_rows, *data, idx_b)

    def commit(idx, valid, th_out_rows, lam_new_rows, omega, theta, lam,
               z_prev):
        if fused:
            return ops.fused_gss(idx, valid, th_out_rows.contiguous(), omega,
                                 theta, lam, z_prev, with_z=True)
        theta_new = scatter_rows(theta, th_out_rows, idx, valid)
        if not is_admm:
            return theta_new, lam, scatter_rows(z_prev, th_out_rows, idx,
                                                valid)
        lam_new = scatter_rows(lam, lam_new_rows, idx, valid)
        z_new = scatter_rows(z_prev, tree_map(torch.add, th_out_rows,
                                              lam_new_rows), idx, valid)
        return theta_new, lam_new, z_new

    block.plan = plan_step
    block.slot_inputs = slot_inputs
    block.presolve = presolve
    block.solve = solve
    block.commit = commit
    return block

"""Host-offloaded client state (``state_backend="host"``).

Port of ``repro/core/hoststate.py``.  The compact round solves C =
⌈slack·L̄·N⌉ rows a round, but the device backend keeps every (N, D)
row of θ, λ, z_prev (and the EF residual ``comm``) on the card.  This
backend keeps those matrices in host memory (:class:`~.state.HostState`,
pinned when the device is CUDA) and runs each round in three legs:

1. **plan** — O(N) vectors on the device: the key split, the selection,
   the compact plan and its queue, the staleness masks and the
   controller step, in the operations of the device round
   (``make_compact_block``'s ``block.plan``).  The (C,) slot indices and
   valid flags (and, under staleness, the (N,) landing mask) are read
   back to the host.
2. **solve** — the (C, D) working set.  The host copies the C planned
   θ and λ rows into pinned staging tiles (``stream_tiles`` of them),
   each tile goes to the device with ``non_blocking=True`` on a copy
   stream and an event is recorded per tile; the compute stream draws
   the slots' minibatches meanwhile and then waits on those events.
   The tiles land in one (C, D) buffer, so the solve runs at the device
   block's width with its solver, and the pre-solve and the commit are
   the block's own (``block.presolve``, ``block.solve``,
   ``block.commit`` on the slots ``0..C−1``): K2 before the unfused
   solve, K3 after the fused one, on the working set.  The (C, D)
   results come back into pinned buffers on the copy stream, and the
   host writes the valid slots' rows into its matrices only after that
   copy's event.  A staging tile is refilled only after its previous
   copy completed.
3. **aggregate** — one full-width pass: z_prev (and ``comm``) go up,
   the consensus is the device round's (``engine.consensus_mean``, or
   ``compress`` under int8 / bf16), and the next round's distances come
   from the device round's own trigger — K1 for the l2 metric — on the
   same rows; they are kept on ``HostState.distances``.

The host never computes: it copies rows.  Every value is computed on the
device by the operations the device round runs, at the same shapes, so
the host backend gives the device backend's bits (events, ω, θ, λ,
z_prev, ``comm``, the park buffers and every ``RoundMetrics`` field).
Under bounded staleness the commit routes rows through the host park
buffers as ``engine.staleness_commit`` does: landing rows take their
parked payload, δ = 0 service commits, the rest parks.

Bytes a round (``round_fn.planned_bytes``, counted in ``round_fn.stats``):
2·C·D·4 up and 3·C·D·4 down for the rows, N·D·4 up for the server pass
(×2 and N·D·4 down with ``comm``), 5·C bytes of plan (+N under
staleness).  Between rounds the device holds ω and the O(N) vectors
(:meth:`HostState.device_state_bytes`).
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import NamedTuple

import numpy as np
import torch

from repro_torch import prng
from repro_torch.device import fp32_products, resolve_device
from repro_torch.kernels import ops
from repro_torch.sharding.clients import ClientMesh
from repro_torch.utils.flatstate import FlatSpec
from repro_torch.utils.spans import span

from .compress import check_mode, ef_consensus, ef_participant_mean
from .controller import ControllerState, init_controller
from .compact import gather_rows, init_queue
from .engine import all_sum, consensus_mean, measured_commits, \
    participant_mean, participant_mean_loss, record_issue, staleness_masks
from .fedback import ADMM_FAMILY, _check_supported, _compact_block, \
    _ctrl_cfg, _solvers
from .selection import make_selection
from .state import DeferQueue, FLState, HostState, InFlight, \
    RoundMetrics, delay_schedule
from .trigger import trigger_distances


class _PlanView(NamedTuple):
    """What the selections read of a state: ``ctrl`` and ``round``."""

    ctrl: ControllerState
    round: torch.Tensor


def _require(cond: bool, what: str) -> None:
    if not cond:
        raise ValueError(f"state_backend='host' {what}")


def _host(shape, pin: bool, fill=None) -> torch.Tensor:
    """An fp32 host tensor, pinned for CUDA copies; ``fill`` a row to
    broadcast (zeros without one)."""
    t = torch.empty(shape, dtype=torch.float32, pin_memory=pin)
    if fill is None:
        return t.zero_()
    return t.copy_(fill)


def init_host_state(cfg, params0, *, spec: FlatSpec,
                    device=None) -> HostState:
    """The host twin of ``init_state``: the same values, the (N, D)
    matrices in host memory (pinned for a CUDA ``device``, CUDA by
    default), the vectors on ``device``.  ``distances`` starts None."""
    _require(spec is not None, "needs the flat (spec=) layout")
    _require(cfg.compact, "needs compact=True (the streaming round is "
             "built on the CompactPlan slot indices)")
    device = resolve_device(device)
    pin = device.type == "cuda"
    n = cfg.n_clients
    flat0 = spec.flatten(params0).detach().to(torch.float32)
    shape = (n, flat0.shape[0])
    row = flat0.cpu()[None].expand(shape)
    inflight = None
    if cfg.max_staleness is not None:
        inflight = InFlight(
            delay=delay_schedule(n, cfg.max_staleness,
                                 kind=cfg.staleness_schedule, seed=cfg.seed,
                                 device=device),
            ttl=torch.zeros((n,), dtype=torch.int32, device=device),
            theta=_host(shape, pin), lam=_host(shape, pin),
            z=_host(shape, pin),
            hist=torch.zeros((n, cfg.max_staleness + 1), dtype=torch.bool,
                             device=device))
    return HostState(
        theta=_host(shape, pin, row), lam=_host(shape, pin),
        z_prev=_host(shape, pin, row),
        omega=flat0.to(device).clone(),
        ctrl=init_controller(n, _ctrl_cfg(cfg), device=device),
        rng=prng.PRNGKey(cfg.seed, device=device),
        round=torch.zeros((), dtype=torch.int32, device=device),
        queue=init_queue(n, device=device),
        distances=None, inflight=inflight,
        comm=(_host(shape, pin) if check_mode(cfg.consensus_compress)
              != "none" else None))


def _leaf(x, device, dtype) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.detach().to(device=device, dtype=dtype, copy=True)
    return torch.from_numpy(np.array(x)).to(device=device, dtype=dtype)


def host_state_from_tree(tree: FLState, cfg=None, *, spec: FlatSpec,
                         device=None) -> HostState:
    """A ``HostState`` from an ``FLState``-shaped tree whose leaves are
    tensors (on any device) or arrays (a checkpoint, the reference's
    state): the matrices copied into new host tensors (pinned for a
    CUDA ``device``), the vectors onto ``device`` (CUDA by default).
    ``distances`` is left None: the next round computes it."""
    _require(spec is not None, "needs the flat (spec=) layout")
    return _host_state_of(tree, resolve_device(device))


def _host_state_of(tree, device: torch.device) -> HostState:
    pin = device.type == "cuda"

    def mat(x):
        x = _leaf(x, "cpu", torch.float32)
        return _host(tuple(x.shape), pin, x)

    def vec(x, dtype):
        return _leaf(x, device, dtype)

    rng = tree.rng
    if not isinstance(rng, torch.Tensor):  # the reference's uint32 words
        rng = np.asarray(rng).astype(np.uint32).astype(np.int64)
    f32, i32 = torch.float32, torch.int32
    inflight = None
    if tree.inflight is not None:
        f = tree.inflight
        inflight = InFlight(delay=vec(f.delay, i32), ttl=vec(f.ttl, i32),
                            theta=mat(f.theta), lam=mat(f.lam), z=mat(f.z),
                            hist=vec(f.hist, torch.bool))
    c = tree.ctrl
    return HostState(
        theta=mat(tree.theta), lam=mat(tree.lam), z_prev=mat(tree.z_prev),
        omega=vec(tree.omega, f32),
        ctrl=ControllerState(delta=vec(c.delta, f32), load=vec(c.load, f32),
                             round=vec(c.round, i32),
                             event_count=vec(c.event_count, i32)),
        rng=vec(rng, torch.int64), round=vec(tree.round, i32),
        queue=DeferQueue(age=vec(tree.queue.age, i32),
                         load=vec(tree.queue.load, f32)),
        distances=None, inflight=inflight,
        comm=None if tree.comm is None else mat(tree.comm))


def host_state_to_device(host: HostState, device=None) -> FLState:
    """The device backend's ``FLState`` of a ``HostState``: every matrix
    copied to ``device`` (by default the device of ω), the vectors
    moved there."""
    device = host.omega.device if device is None else torch.device(device)

    def to(x):
        if x is None:
            return None
        if isinstance(x, tuple):
            return type(x)(*(to(f) for f in x))
        return x.to(device, copy=True)

    return FLState(*(to(x) for x in host.to_checkpoint_tree()))


def _tile_spans(capacity: int, tiles: int) -> tuple[tuple[int, int], ...]:
    """Contiguous [a, b) row spans covering the working set: the copy
    granularity of the row stream."""
    t = max(1, min(int(tiles), capacity))
    edges = [round(capacity * i / t) for i in range(t + 1)]
    return tuple(zip(edges[:-1], edges[1:], strict=True))


def make_host_round_fn(cfg, loss_fn, data, *, spec: FlatSpec | None = None,
                       device=None, mesh=None, ctrl_arg: bool = False,
                       arrivals_arg: bool = False, ragged=None,
                       body_transform=None):
    """Build ``round_fn(HostState) -> (HostState, RoundMetrics)``, the
    device backend's compact round (``make_round_fn`` with the same
    config) bit for bit, with the client matrices on the host.

    ``data`` and ``ragged`` as for ``make_round_fn``; the data is moved
    to ``device`` (CUDA by default) once and stays there.  The returned
    function carries ``planned_bytes`` (the transfer model above),
    ``stats`` (bytes and host seconds by leg, summed over rounds) and
    ``static_info``.  On a CUDA device each round also records CUDA
    events around its copies and its windows of work on the compute
    stream, and ``stats`` sums the copies' ms (``h2d_ms``, ``d2h_ms``)
    and the ms of them that overlapped such a window (``overlap_ms``).

    The legs run in spans ``hoststate/plan`` (its read-back of the plan
    in ``hoststate/readback``), ``hoststate/solve``, ``hoststate/host``
    (the row writes into host memory) and ``hoststate/aggregate``;
    ``body_transform`` wraps the solve leg, ``solve_leg(state, plan,
    clock) -> losses`` (the reference wraps its solve program).
    """
    _require(mesh is None, "is a single-host backend (mesh must be None "
             "— shard the device backend instead)")
    _require(not ctrl_arg and not arrivals_arg,
             "does not take ctrl/arrivals runtime args")
    _require(spec is not None, "needs the flat (spec=) layout")
    _require(cfg.compact, "needs compact=True")
    _check_supported(cfg)
    device = resolve_device(device)
    fp32_products(device)
    cuda = device.type == "cuda"
    n, dim = cfg.n_clients, spec.dim
    compress = check_mode(cfg.consensus_compress)
    is_admm = cfg.algorithm in ADMM_FAMILY
    async_mode = cfg.max_staleness is not None
    if cfg.fused_gss and not is_admm:
        raise ValueError(
            "fused_gss=True needs compact=True, an ADMM-family "
            "algorithm and the flat (spec=) layout — got "
            f"compact={cfg.compact}, algorithm={cfg.algorithm!r}, "
            "flat=True")
    x_dev = torch.as_tensor(data["x"]).to(device)
    y_dev = torch.as_tensor(data["y"]).to(device)
    csr = {}
    if ragged is not None:
        if ragged.n_clients != n:
            raise ValueError(f"ragged spec describes {ragged.n_clients} "
                             f"clients, cfg.n_clients={n}")
        if x_dev.shape[0] != ragged.buffer_rows:
            raise ValueError(f"pooled data has {x_dev.shape[0]} rows, the "
                             f"ragged spec {ragged.buffer_rows}")
        n_points = ragged.max_size
        csr = {"offsets": ragged.offsets_array(device=device),
               "sizes": ragged.sizes_array(device=device)}
    else:
        if x_dev.shape[0] != n:
            raise ValueError(f"data has {x_dev.shape[0]} clients, "
                             f"cfg.n_clients={n}")
        n_points = x_dev.shape[1]
    select = make_selection(cfg.selection_name(), rate=cfg.participation,
                            controller=_ctrl_cfg(cfg),
                            metric=cfg.trigger_metric)
    block = _compact_block(cfg, _solvers(cfg, loss_fn, spec, n_points), 1,
                           True, ragged, keep_old_rows=False)
    capacity = block.capacity
    mesh1 = ClientMesh((device,))
    rate_floor = cfg.participation * n
    spans = _tile_spans(capacity, cfg.stream_tiles)
    slots = torch.arange(capacity, dtype=torch.int32, device=device)
    copy_stream = torch.cuda.Stream(device) if cuda else None
    # Pinned staging (θ, λ up) and result (θ, λ⁺, z down) buffers, and
    # one event per staging tile: its last copy to the device.
    up = [_host((capacity, dim), cuda) for _ in range(2)]
    down = [_host((capacity, dim), cuda) for _ in range(3)]
    tile_done = [None] * len(spans)
    delay_host = []  # the static delays, read back once

    stats = {"rounds": 0, "h2d_row_bytes": 0, "d2h_row_bytes": 0,
             "h2d_full_bytes": 0, "d2h_full_bytes": 0, "d2h_plan_bytes": 0,
             "plan_s": 0.0, "h2d_s": 0.0, "solve_s": 0.0, "d2h_s": 0.0,
             "scatter_s": 0.0, "agg_s": 0.0,
             "h2d_ms": 0.0, "d2h_ms": 0.0, "overlap_ms": 0.0}

    def trigger(omega, z):
        if cfg.trigger_metric != "l2":
            return trigger_distances(omega, z, cfg.trigger_metric)
        return torch.sqrt(ops.trigger_sq_norms_pytree(z, omega))

    def upload(t):
        """A host matrix on the device, copied on the compute stream."""
        stats["h2d_full_bytes"] += t.numel() * t.element_size()
        return t.to(device, non_blocking=True, copy=True)

    class _Clock:
        """On CUDA, timing events around each copy on the copy stream and
        each window of work on the compute stream, read against the
        round's first event once the round has synced."""

        def __init__(self):
            self.on = cuda
            self.spans = []
            self.start = self._event(None)

        def _event(self, stream):
            if not self.on:
                return None
            ev = torch.cuda.Event(enable_timing=True)
            ev.record(stream)
            return ev

        @contextlib.contextmanager
        def span(self, kind, stream=None):
            """``kind``: "h2d" or "d2h" (a copy) or "work"."""
            a = self._event(stream)
            yield
            if self.on:
                self.spans.append((kind, a, self._event(stream)))

        def read(self):
            if not self.on:
                return
            at = {k: [(self.start.elapsed_time(a), self.start.elapsed_time(b))
                      for kind, a, b in self.spans if kind == k]
                  for k in ("h2d", "d2h", "work")}
            for k in ("h2d", "d2h"):
                stats[f"{k}_ms"] += sum(b - a for a, b in at[k])
            stats["overlap_ms"] += sum(
                max(0.0, min(b, d) - max(a, c))
                for a, b in at["h2d"] + at["d2h"] for c, d in at["work"])

    def plan_leg(state):
        """Selection, plan, queue and controller on the device, as the
        device round computes them; returns them with the plan read
        back."""
        rng, sel_rng, data_rng = prng.split(state.rng, 3)
        fl = state.inflight
        with span("fedback/trigger_select"):
            eligible = None if fl is None else fl.ttl == 0
            events = select.decide_shards(
                sel_rng, (_PlanView(state.ctrl, state.round),),
                [state.distances], mesh1,
                eligible=None if eligible is None else [eligible])[0]
            if eligible is not None:
                events = events & eligible
        plan, queue = block.plan(events, state.distances, eligible,
                                 state.queue.age, state.queue.load)
        keys_rows = gather_rows(prng.split(data_rng, n), plan.idx)
        out = dict(rng=rng, events=events, plan=plan, queue=queue,
                   keys_rows=keys_rows)
        if fl is None:
            out.update(ctrl=select.measure(state.ctrl, events),
                       committed=plan.committed, fl=None, land=None)
        else:
            land, direct, defer, new_ttl = staleness_masks(
                plan.committed, fl.delay, fl.ttl)
            hist = record_issue(fl.hist, events, state.round)
            ctrl = select.measure(state.ctrl, measured_commits(
                hist, fl.delay, state.round), staleness_delay=fl.delay)
            out.update(ctrl=ctrl, committed=direct | land, land=land,
                       fl=fl._replace(ttl=new_ttl, hist=hist))
        with span("hoststate/readback"):
            idx = plan.idx.cpu()
            valid = plan.valid.cpu()
            stats["d2h_plan_bytes"] += idx.numel() * 4 + valid.numel()
            out.update(idx_host=idx.long(), valid_host=valid)
            if fl is not None:
                out["land_host"] = out["land"].cpu()
                stats["d2h_plan_bytes"] += n
                if not delay_host:
                    delay_host.append(fl.delay.cpu())
        return out

    def solve_leg(state, p, clock):
        """The planned rows up in tiles, the block's solve and commit on
        them, the (C, D) results down; returns the host result buffers
        (θ, λ, z rows by slot)."""
        t0 = time.perf_counter()
        rows = p["idx_host"]
        work = [torch.empty((capacity, dim), dtype=torch.float32,
                            device=device) for _ in up]
        if cuda:
            copy_stream.wait_stream(torch.cuda.current_stream(device))
        for t, (a, b) in enumerate(spans):
            if tile_done[t] is not None:
                tile_done[t].synchronize()
            for host, stage, dev in zip((state.theta, state.lam), up, work,
                                        strict=True):
                torch.index_select(host, 0, rows[a:b], out=stage[a:b])
                if cuda:
                    with torch.cuda.stream(copy_stream), \
                            clock.span("h2d", copy_stream):
                        dev[a:b].copy_(stage[a:b], non_blocking=True)
                else:
                    dev[a:b].copy_(stage[a:b])
            if cuda:
                tile_done[t] = torch.cuda.Event()
                tile_done[t].record(copy_stream)
        stats["h2d_row_bytes"] += 2 * capacity * dim * 4
        stats["h2d_s"] += time.perf_counter() - t0
        t0 = time.perf_counter()
        plan = p["plan"]
        # The slots' minibatch draws and data need no rows: they run on
        # the compute stream while the tiles are copied.
        with clock.span("work"):
            inputs = block.slot_inputs(plan.idx, x_dev, y_dev,
                                       p["keys_rows"], **csr)
        if cuda:
            for ev in tile_done:
                torch.cuda.current_stream(device).wait_event(ev)
        th_rows, lam_rows = work
        with clock.span("work"):
            lam_new, center, theta0 = block.presolve(
                th_rows, lam_rows if is_admm else None, state.omega)
            th_out, losses = block.solve(theta0, center, inputs)
            with span("fedback/commit"):
                results = block.commit(slots, plan.valid, th_out, lam_new,
                                       state.omega, th_rows, lam_rows,
                                       torch.zeros_like(th_rows))
        stats["solve_s"] += time.perf_counter() - t0
        t0 = time.perf_counter()
        if cuda:
            copy_stream.wait_stream(torch.cuda.current_stream(device))
            with torch.cuda.stream(copy_stream):
                for host, dev in zip(down, results, strict=True):
                    with clock.span("d2h", copy_stream):
                        host.copy_(dev, non_blocking=True)
            fetched = torch.cuda.Event()
            fetched.record(copy_stream)
            # The host reads the results only once their copy is done.
            fetched.synchronize()
        else:
            for host, dev in zip(down, results, strict=True):
                host.copy_(dev)
        stats["d2h_row_bytes"] += 3 * capacity * dim * 4
        stats["d2h_s"] += time.perf_counter() - t0
        return losses

    def scatter_leg(state, p):
        """The valid slots' rows into the host matrices; under staleness
        through the park buffers, as ``engine.staleness_commit``."""
        t0 = time.perf_counter()
        slot = torch.nonzero(p["valid_host"]).flatten()
        cids = p["idx_host"][slot]
        mats = (state.theta, state.lam, state.z_prev)
        fl = state.inflight
        if fl is None:
            for buf, res in zip(mats, down, strict=True):
                buf.index_copy_(0, cids, res[slot])
        else:
            land = torch.nonzero(p["land_host"]).flatten()
            now = delay_host[0][cids] == 0
            for buf, park, res in zip(mats, (fl.theta, fl.lam, fl.z), down,
                                      strict=True):
                buf.index_copy_(0, land, park[land])
                buf.index_copy_(0, cids[now], res[slot[now]])
                park.index_copy_(0, cids[~now], res[slot[~now]])
        stats["scatter_s"] += time.perf_counter() - t0

    def aggregate_leg(state, p):
        """The one full-width pass: ω, the residual and the next round's
        distances from the committed z_prev."""
        t0 = time.perf_counter()
        z = [upload(state.z_prev)]
        committed = [p["committed"]]
        num_committed = None if is_admm else all_sum(
            [torch.sum(c.to(torch.int32)) for c in committed])
        comm = state.comm
        with span("fedback/consensus"):
            if compress != "none":
                ef = dict(mode=compress, block=cfg.compress_block,
                          mesh=mesh1)
                resid = [upload(state.comm)]
                if is_admm:
                    omega, resid = ef_consensus(z, state.omega, resid, **ef)
                else:
                    omega, resid = ef_participant_mean(
                        z, committed, state.omega, resid, num_committed,
                        **ef)
                if cuda:
                    # Down to pinned host memory on the copy stream, as the
                    # solve leg's results, then one event wait: a blocking
                    # copy_ would synchronize the round with the host.
                    copy_stream.wait_stream(
                        torch.cuda.current_stream(device))
                    with torch.cuda.stream(copy_stream):
                        comm.copy_(resid[0], non_blocking=True)
                    copied = torch.cuda.Event()
                    copied.record(copy_stream)
                    copied.synchronize()
                else:
                    comm.copy_(resid[0])
                stats["d2h_full_bytes"] += comm.numel() * 4
            elif is_admm:
                omega = consensus_mean(z)
            else:
                omega = participant_mean(z, committed, state.omega,
                                         num_events=num_committed)
        with span("fedback/trigger_select"):
            distances = trigger(omega, z[0])
        stats["agg_s"] += time.perf_counter() - t0
        return omega, distances

    solve = solve_leg if body_transform is None else body_transform(solve_leg)

    def round_fn(state: HostState):
        if state.distances is None:
            # After an init or a restore: one trigger pass first.
            state = dataclasses.replace(state, distances=trigger(
                state.omega, upload(state.z_prev)))
        clock = _Clock()
        t0 = time.perf_counter()
        with span("hoststate/plan"):
            p = plan_leg(state)
        stats["plan_s"] += time.perf_counter() - t0
        with span("hoststate/solve"):
            losses = solve(state, p, clock)
        with span("hoststate/host"):
            scatter_leg(state, p)
        with span("hoststate/aggregate"):
            omega, distances = aggregate_leg(state, p)
        clock.read()
        plan, queue, fl = p["plan"], p["queue"], p["fl"]
        zero = torch.zeros((), dtype=torch.int32, device=device)
        metrics = RoundMetrics(
            events=p["events"],
            num_events=all_sum([torch.sum(p["events"].to(
                torch.int32))]).to(torch.int32),
            distances=state.distances,
            delta=p["ctrl"].delta, load=p["ctrl"].load,
            train_loss=participant_mean_loss([losses], [plan.valid]),
            num_deferred=all_sum([torch.sum((queue.age > 0).to(
                torch.int32))]).to(torch.int32),
            realized_capacity=all_sum([plan.limit]),
            realized_slack=(all_sum([plan.limit]).to(torch.float32)
                            / (rate_floor if rate_floor > 0 else 1.0)),
            num_inflight=zero if fl is None else all_sum([torch.sum(
                (fl.ttl > 0).to(torch.int32))]).to(torch.int32),
            num_landed=zero if fl is None else all_sum([torch.sum(
                p["land"].to(torch.int32))]).to(torch.int32),
            committed=p["committed"])
        stats["rounds"] += 1
        new_state = HostState(
            theta=state.theta, lam=state.lam, z_prev=state.z_prev,
            omega=omega, ctrl=p["ctrl"], rng=p["rng"],
            round=state.round + 1, queue=queue, distances=distances,
            inflight=fl, comm=state.comm)
        return new_state, metrics

    row_h2d = 2 * capacity * dim * 4  # θ, λ rows up
    row_d2h = 3 * capacity * dim * 4  # θ, λ⁺, z rows down
    full_mult = 2 if compress != "none" else 1
    round_fn.planned_bytes = {
        "row_stream_h2d": row_h2d,
        "row_stream_d2h": row_d2h,
        "row_stream_budget": 8 * capacity * dim * 4,
        "server_pass_h2d": n * dim * 4 * full_mult,
        "server_pass_d2h": n * dim * 4 if compress != "none" else 0,
        "plan_d2h": capacity * 5 + (n if async_mode else 0),
    }
    round_fn.stats = stats
    round_fn.static_info = {
        "backend": "host", "capacity": capacity, "c_min": block.c_min,
        "adaptive": cfg.adaptive_capacity and cfg.capacity is None,
        "is_admm": is_admm, "ragged": ragged is not None,
        "masked": ragged is not None and not ragged.uniform,
        "tiles": len(spans), "fused": cfg.fused_gss, "async": async_mode,
        "compress": compress, "device": str(device),
    }
    return round_fn

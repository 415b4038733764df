"""Seed × gain × target-rate sweeps (port of ``repro/launch/sweep.py``).

A Table-1 row or a controller-gain ablation is many runs of one round
that differ only in the seed and the controller's gain K and target L̄.
The reference vmaps one jitted round over the flattened grid and scans
it over rounds, so that the sweep compiles once.  The port has no
compile to amortise: it builds one round with runtime controller
overrides (``make_round_fn(..., ctrl_arg=True)``) and steps it over the
runs, run by run, each round, on the states stacked along a leading
runs axis:

    runs, final_states, history = run_sweep(
        cfg, loss_fn, data, params0, rounds=100,
        seeds=(0, 1, 2, 3), gains=(0.5, 2.0))

``history`` leaves are (rounds, runs, ...).  ``init_sweep`` builds the
stacked states (R, N, ...) and the (R,) fp32 overrides, and
``make_sweep_fn`` the reusable ``sweep_fn(states, overrides)``.  Each
step works on views of the stacked tensors: the compact round's fused
commit writes through ``states.theta[r]`` (and λ, z_prev) in place, and
each leaf the round replaces is copied back into its run's slice, so
nothing is restacked and nothing is read back to the host inside the
loop.  Gains steer only a live feedback controller (``fedback``); the
open-loop selections ignore them, so sweep seeds alone there.

The compact round, ``max_staleness``, ``consensus_compress``, the tree
layout (``spec=None``), ragged clients (``ragged=``, one pool read by
every run) and the client mesh compose.  With ``mesh=`` the stacked
state is a shard list: shard i holds the stacked (R, N/P, ...) rows of
its clients on ``mesh.devices[i]`` and its own (R, ...) copies of ω,
the key and the counters (``convert.state_from_numpy(..., mesh=,
runs=True)`` builds one from the reference's stacked state).

The host-offloaded backend (``--state-backend host``) takes no runtime
overrides: the CLI runs its grid sequentially, one round per grid point
configured with the point's seed, K and L̄, and prints the same CSV.

CLI demo (least squares, the per-run realized rates), on the card, or
on the CPU with ``--device cpu``:

    PYTHONPATH=src python -m repro_torch.launch.sweep --n-clients 64 \\
        --seeds 0,1,2,3 --gains 0.5,2.0 --rounds 60
"""
from __future__ import annotations

import argparse
import dataclasses
import itertools
from typing import Callable, Sequence

import torch

from repro_torch.core.fedback import FLConfig, init_state, make_round_fn
from repro_torch.core.state import RoundMetrics

HEADER = ("seed,K,target,realized_rate,realized_slack,queue_depth,"
          "inflight_depth,final_train_loss")


@dataclasses.dataclass(frozen=True)
class SweepGrid:
    """The flattened run grid: the cartesian product of the axes given;
    a missing axis takes the config's value."""

    seeds: tuple[int, ...] = (0, 1, 2, 3)
    gains: tuple[float, ...] | None = None  # controller K values
    target_rates: tuple[float, ...] | None = None  # L̄ values

    def runs(self, cfg: FLConfig):
        gains = self.gains if self.gains is not None else (
            cfg.controller.K,)
        targets = self.target_rates if self.target_rates is not None else (
            cfg.participation,)
        return list(itertools.product(self.seeds, gains, targets))


def _stack(trees):
    """Trees of one structure (tensors in NamedTuples, tuples and dicts;
    None) stacked along a new leading axis."""
    t0 = trees[0]
    if t0 is None:
        return None
    if isinstance(t0, torch.Tensor):
        return torch.stack(trees)
    if isinstance(t0, dict):
        return {k: _stack([t[k] for t in trees]) for k in t0}
    parts = [_stack([t[i] for t in trees]) for i in range(len(t0))]
    return type(t0)(*parts) if hasattr(t0, "_fields") else tuple(parts)


def _run(tree, r: int):
    """Run ``r``'s views of a stacked tree."""
    if tree is None:
        return None
    if isinstance(tree, torch.Tensor):
        return tree[r]
    if isinstance(tree, dict):
        return {k: _run(v, r) for k, v in tree.items()}
    parts = [_run(v, r) for v in tree]
    return type(tree)(*parts) if hasattr(tree, "_fields") else tuple(parts)


def _write_back(view, new) -> None:
    """Copy each leaf of ``new`` into its view, unless the round wrote
    that view in place (the same storage)."""
    if view is None:
        return
    if isinstance(view, torch.Tensor):
        if new.data_ptr() != view.data_ptr():
            view.copy_(new)
        return
    if isinstance(view, dict):
        for k in view:
            _write_back(view[k], new[k])
        return
    for v, w in zip(view, new, strict=True):
        _write_back(v, w)


def _device(states) -> torch.device:
    return (states if hasattr(states, "rng") else states[0]).rng.device


def init_sweep(cfg: FLConfig, params0, grid: SweepGrid, *, spec=None,
               device=None, mesh=None):
    """(stacked states, overrides, runs): each run's
    ``init_state(replace(cfg, seed=s), ...)`` stacked along a leading
    runs axis (with ``mesh``, per shard), and ``{"K": (R,), "target_rate":
    (R,)}`` fp32 on the states' device (shard 0's)."""
    runs = grid.runs(cfg)
    states = _stack([
        init_state(dataclasses.replace(cfg, seed=seed), params0, spec=spec,
                   device=device, mesh=mesh)
        for seed, _, _ in runs])
    dev = _device(states)
    overrides = {
        "K": torch.tensor([k for _, k, _ in runs], dtype=torch.float32,
                          device=dev),
        "target_rate": torch.tensor([t for _, _, t in runs],
                                    dtype=torch.float32, device=dev),
    }
    return states, overrides, runs


def make_sweep_fn(cfg: FLConfig, loss_fn: Callable, data: dict, *,
                  rounds: int, spec=None, device=None, mesh=None,
                  ragged=None):
    """Build ``sweep_fn(states, overrides) -> (final_states, history)``
    over :func:`init_sweep`'s stacked states and overrides: ``rounds``
    rounds, each stepping every run's view through one
    ``make_round_fn(..., ctrl_arg=True)`` round with the run's
    overrides.  ``states`` is updated in place and returned; history
    leaves are (rounds, runs, ...).  ``spec``, ``device``, ``mesh`` and
    ``ragged`` as for ``make_round_fn`` (a ragged ``data`` is the pool
    every run reads).  The host backend takes no overrides and is
    refused."""
    round_fn = make_round_fn(cfg, loss_fn, data, spec=spec, device=device,
                             mesh=mesh, ragged=ragged, ctrl_arg=True)

    def sweep_fn(states, overrides):
        n_runs = overrides["K"].shape[0]
        history = []
        for _ in range(rounds):
            for r in range(n_runs):
                view = _run(states, r)
                new, metrics = round_fn(view, {k: v[r] for k, v in
                                               overrides.items()})
                _write_back(view, new)
                history.append(metrics)
        return states, RoundMetrics(*(
            torch.stack(f).reshape((rounds, n_runs) + tuple(f[0].shape))
            for f in zip(*history, strict=True)))

    return sweep_fn


def run_sweep(cfg: FLConfig, loss_fn: Callable, data: dict, params0, *,
              rounds: int, seeds: Sequence[int] = (0, 1, 2, 3),
              gains: Sequence[float] | None = None,
              target_rates: Sequence[float] | None = None, spec=None,
              device=None, mesh=None, ragged=None):
    """One call: returns (runs, final_states, history)."""
    grid = SweepGrid(seeds=tuple(seeds),
                     gains=tuple(gains) if gains is not None else None,
                     target_rates=(tuple(target_rates)
                                   if target_rates is not None else None))
    states, overrides, runs = init_sweep(cfg, params0, grid, spec=spec,
                                         device=device, mesh=mesh)
    sweep_fn = make_sweep_fn(cfg, loss_fn, data, rounds=rounds, spec=spec,
                             device=device, mesh=mesh, ragged=ragged)
    final_states, history = sweep_fn(states, overrides)
    return runs, final_states, history


def _row(seed, k, tgt, rate, slack, queue, inflight, loss) -> str:
    return (f"{seed},{k},{tgt},{rate:.3f},{slack:.2f},{int(queue)},"
            f"{int(inflight)},{loss:.5f}")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--n-clients", type=int, default=64)
    ap.add_argument("--rounds", type=int, default=60)
    ap.add_argument("--participation", type=float, default=0.3)
    ap.add_argument("--seeds", default="0,1,2,3")
    ap.add_argument("--gains", default=None,
                    help="comma-separated controller K values")
    ap.add_argument("--devices", type=int, default=0,
                    help="cut the client axis into this many shards of a "
                         "client mesh (0 = one device)")
    ap.add_argument("--tree-layout", action="store_true",
                    help="the stacked-tree client-state layout instead of "
                         "the flat (N, D) one")
    ap.add_argument("--compact", action="store_true",
                    help="capacity-bounded compaction: ⌈slack·L̄·N⌉ solver "
                         "rows a round, overflow carried in the queue")
    ap.add_argument("--slack", type=float, default=1.5,
                    help="capacity slack bound")
    ap.add_argument("--fused-gss", action="store_true",
                    help="the compact round's fused commit (K3); needs "
                         "--compact and the flat layout")
    ap.add_argument("--max-staleness", type=int, default=None,
                    help="stale-tolerant rounds: solves land up to this "
                         "many rounds later")
    ap.add_argument("--consensus-compress", default="none",
                    choices=("none", "bf16", "int8"),
                    help="compressed consensus with error feedback (flat "
                         "layout)")
    ap.add_argument("--state-backend", default="device",
                    choices=("device", "host"),
                    help="where the (N, D) client matrices live: 'host' "
                         "keeps them in host memory (needs --compact and "
                         "the flat layout) and runs the grid point by "
                         "point")
    ap.add_argument("--ragged", action="store_true",
                    help="per-client sizes drawn in [n/2, n] points and "
                         "pooled into one CSR buffer")
    ap.add_argument("--device", default=None,
                    help="the device to run on (default: CUDA; 'cpu' for "
                         "the plain PyTorch path)")
    args = ap.parse_args(argv)

    import numpy as np

    from repro_torch.core import ControllerConfig, run_rounds
    from repro_torch.data import make_least_squares
    from repro_torch.device import resolve_device
    from repro_torch.sharding import make_client_mesh
    from repro_torch.utils import make_flat_spec

    device = resolve_device(args.device)
    cfg = FLConfig(algorithm="fedback", n_clients=args.n_clients,
                   participation=args.participation, rho=1.0, lr=0.1,
                   momentum=0.0, epochs=2, batch_size=8,
                   compact=args.compact, capacity_slack=args.slack,
                   fused_gss=args.fused_gss,
                   max_staleness=args.max_staleness,
                   consensus_compress=args.consensus_compress,
                   controller=ControllerConfig(K=0.2, alpha=0.9))
    data, params0, loss_fn = make_least_squares(args.n_clients,
                                                device=device)
    ragged = None
    if args.ragged:
        from repro_torch.utils.ragged import pool_data
        n_pts = data["x"].shape[1]
        sizes = np.random.default_rng(0).integers(
            max(n_pts // 2, 1), n_pts + 1, size=args.n_clients)
        x, y = data["x"].cpu(), data["y"].cpu()
        data, ragged = pool_data([x[i][:s] for i, s in enumerate(sizes)],
                                 [y[i][:s] for i, s in enumerate(sizes)],
                                 device=device)
        print(f"# ragged: {ragged.total} pooled rows over "
              f"{args.n_clients} clients, sizes in "
              f"[{ragged.min_size}, {ragged.max_size}], "
              f"{len(ragged.buckets)} solve buckets")
    spec = None if args.tree_layout else make_flat_spec(params0)
    seeds = [int(s) for s in args.seeds.split(",")]
    gains = ([float(g) for g in args.gains.split(",")]
             if args.gains else None)

    if args.state_backend == "host":
        if args.tree_layout:
            raise SystemExit("--state-backend host needs the flat "
                             "(N, D) layout — drop --tree-layout")
        if not args.compact:
            raise SystemExit("--state-backend host needs --compact "
                             "(the streaming round is built on the "
                             "CompactPlan slot indices)")
        if args.devices:
            raise SystemExit("--state-backend host is a single-host "
                             "backend — drop --devices (shard the "
                             "device backend instead)")
        grid = SweepGrid(seeds=tuple(seeds),
                         gains=tuple(gains) if gains else None)
        print(HEADER)
        for seed, k, tgt in grid.runs(cfg):
            rcfg = dataclasses.replace(
                cfg, seed=seed, participation=tgt, state_backend="host",
                controller=cfg.controller._replace(K=k))
            state = init_state(rcfg, params0, spec=spec, device=device)
            round_fn = make_round_fn(rcfg, loss_fn, data, spec=spec,
                                     device=device, ragged=ragged)
            state, h = run_rounds(round_fn, state, args.rounds)
            print(_row(seed, k, tgt,
                       float(h.events.to(torch.float32).mean()),
                       float(h.realized_slack.mean()),
                       h.num_deferred[-1], h.num_inflight[-1],
                       float(h.train_loss[-1])))
        return

    mesh = None
    if args.devices:
        mesh = make_client_mesh(args.devices, None if device.type == "cuda"
                                else [device])
    runs, _, hist = run_sweep(cfg, loss_fn, data, params0,
                              rounds=args.rounds, seeds=seeds, gains=gains,
                              spec=spec, device=None if mesh else device,
                              mesh=mesh, ragged=ragged)
    rates = hist.events.to(torch.float32).mean(dim=(0, 2)).tolist()
    slacks = hist.realized_slack.mean(dim=0).tolist()
    print(HEADER)
    for (seed, k, tgt), rate, slk, q, fl, loss in zip(
            runs, rates, slacks, hist.num_deferred[-1].tolist(),
            hist.num_inflight[-1].tolist(), hist.train_loss[-1].tolist(),
            strict=True):
        print(_row(seed, k, tgt, rate, slk, q, fl, loss))


if __name__ == "__main__":
    main()

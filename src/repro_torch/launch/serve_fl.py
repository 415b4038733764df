"""FL serving: rounds as a service over a client-arrival trace
(port of ``repro/launch/serve_fl.py``).

Drives :func:`repro_torch.core.schedule.serve` over a generated trace:
updates are admitted into free capacity slots the tick they arrive, the
consensus mean ticks every tick, and the loop books per-commit latency
into a ``ServeReport``.

    python -m repro_torch.launch.serve_fl --trace bursty \\
        --n-clients 256 --ticks 96 --rate 0.25 --json serve.json

runs on the card; ``--device cpu`` runs the plain path.  ``--trace
sync`` (everyone every tick) reproduces the synchronous round bit for
bit.  Exits 1 where the books do not balance.
"""
from __future__ import annotations

import argparse
import json

from repro_torch.device import resolve_device


def build_serve_problem(n_clients: int, *, dim: int = 16,
                        n_points: int = 8, seed: int = 0,
                        algorithm: str = "fedback",
                        participation: float = 0.25,
                        compact: bool = True,
                        max_staleness: int | None = None,
                        adaptive_capacity: bool = True,
                        fused_gss: bool = False, device=None):
    """(cfg, round_fn, state) of a flat-layout serve run on the
    synthetic least-squares problem, the reference's settings, on
    ``device`` (CUDA unless another is passed)."""
    from repro_torch.core.fedback import FLConfig, init_state, \
        make_round_fn
    from repro_torch.data import make_least_squares
    from repro_torch.utils import make_flat_spec

    device = resolve_device(device)
    data, params0, loss_fn = make_least_squares(
        n_clients, n_points=n_points, dim=dim, seed=seed, device=device)
    spec = make_flat_spec(params0)
    cfg = FLConfig(
        algorithm=algorithm, n_clients=n_clients,
        participation=participation, rho=1.0, lr=0.1, momentum=0.0,
        epochs=1, batch_size=4, compact=compact,
        max_staleness=max_staleness,
        adaptive_capacity=adaptive_capacity, fused_gss=fused_gss,
        seed=seed)
    round_fn = make_round_fn(cfg, loss_fn, data, spec=spec, device=device,
                             arrivals_arg=True)
    state = init_state(cfg, params0, spec=spec, device=device)
    return cfg, round_fn, state


def main(argv=None) -> int:
    from repro_torch.core.schedule import TRACE_KINDS, TraceConfig, \
        make_trace, serve

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--trace", choices=TRACE_KINDS, default="bursty")
    ap.add_argument("--n-clients", type=int, default=256)
    ap.add_argument("--ticks", type=int, default=96)
    ap.add_argument("--rate", type=float, default=0.25,
                    help="mean per-tick arrival probability (and the "
                         "controller's target rate L̄)")
    ap.add_argument("--dim", type=int, default=16)
    ap.add_argument("--algorithm", default="fedback")
    ap.add_argument("--dense", action="store_true",
                    help="dense rounds (default: capacity-bounded "
                         "compaction)")
    ap.add_argument("--max-staleness", type=int, default=None,
                    help="bounded-staleness commit pipeline (default: "
                         "synchronous commits)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device)")
    ap.add_argument("--json", metavar="PATH",
                    help="write the ServeReport summary to PATH")
    args = ap.parse_args(argv)

    cfg, round_fn, state = build_serve_problem(
        args.n_clients, dim=args.dim, seed=args.seed,
        algorithm=args.algorithm, participation=args.rate,
        compact=not args.dense, max_staleness=args.max_staleness,
        device=args.device)
    trace = make_trace(TraceConfig(
        kind=args.trace, n_clients=args.n_clients, ticks=args.ticks,
        rate=args.rate, seed=args.seed))
    state, report = serve(round_fn, state, trace, warmup=True)

    summary = report.summary()
    device = resolve_device(args.device)
    print(f"serve[{args.trace}] N={args.n_clients} ticks={args.ticks} "
          f"rate={args.rate} compact={cfg.compact} "
          f"staleness={cfg.max_staleness} device={device}")
    for k, v in summary.items():
        print(f"  {k}: {v:.3f}" if isinstance(v, float) else f"  {k}: {v}")
    if not report.conservation_ok:
        print("  WARNING: conservation violated (admitted − commits != "
              "deferred + in-flight)")
    if args.json:
        with open(args.json, "w") as fh:
            json.dump({f"serve_{args.trace}": summary}, fh, indent=2,
                      sort_keys=True)
            fh.write("\n")
        print(f"wrote {args.json}")
    return 0 if report.conservation_ok else 1


if __name__ == "__main__":
    raise SystemExit(main())

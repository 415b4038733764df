"""Client-sharded FedBack and a seeds × gains sweep on the PyTorch/CUDA
port (the twin of ``examples/sharded_sweep.py``).

1. The same round on one device and on a client mesh of 8 shards
   (``sharding.make_client_mesh``): the event decisions are identical
   round for round and ω agrees to fp32 tolerance.
2. A (seeds × controller gains) sweep through ``launch/sweep.py``.

What differs: the reference forces 8 host devices and compiles the
sweep as one XLA program; here the 8 shards lie on one device (the card,
or the CPU with ``--device cpu``), and a sweep is R rounds stepped run by
run over the states stacked along a runs axis (``launch/sweep.py``: no
compile to amortise); ``--rounds``, ``--sweep-rounds`` and ``--shards``
shorten or reshape the reference's 20 and 60 rounds on 8 shards.

    PYTHONPATH=src python examples/sharded_sweep_torch.py
    PYTHONPATH=src python examples/sharded_sweep_torch.py --device cpu
"""
import argparse

import torch

from repro_torch.core import ControllerConfig, FLConfig, init_state, \
    make_round_fn
from repro_torch.data import make_least_squares
from repro_torch.device import resolve_device
from repro_torch.launch.sweep import run_sweep
from repro_torch.sharding import make_client_mesh


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=20)
    ap.add_argument("--sweep-rounds", type=int, default=60)
    ap.add_argument("--shards", type=int, default=8)
    ap.add_argument("--device", default=None,
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    n = 64
    data, params0, loss_fn = make_least_squares(n, device=device)
    cfg = FLConfig(algorithm="fedback", n_clients=n, participation=0.3,
                   rho=1.0, lr=0.1, momentum=0.0, epochs=2, batch_size=8,
                   controller=ControllerConfig(K=0.5, alpha=0.9))

    # --- 1. one device vs a client mesh: same round, same events -------
    mesh = make_client_mesh(args.shards, [device])
    print(f"device: {device}, client mesh: {mesh.size} shards")
    runs = {}
    for name, m in (("single", None), ("sharded", mesh)):
        place = {"mesh": m} if m else {"device": device}
        state = init_state(cfg, params0, **place)
        round_fn = make_round_fn(cfg, loss_fn, data, **place)
        events = []
        for _ in range(args.rounds):
            state, met = round_fn(state)
            events.append(met.events.cpu())
        # a mesh's ω is replicated on every shard: shard 0's is read
        omega = (state[0] if m else state).omega["theta"].cpu()
        runs[name] = (torch.stack(events), omega)
    ev_equal = bool(torch.equal(runs["single"][0], runs["sharded"][0]))
    omega_gap = float((runs["single"][1] - runs["sharded"][1]).abs().max())
    print(f"events bit-identical: {ev_equal}   max |Δω|: {omega_gap:.2e}")

    # --- 2. a whole ablation row: seeds × gains -------------------------
    grid_runs, _, hist = run_sweep(
        cfg, loss_fn, data, params0, rounds=args.sweep_rounds,
        seeds=(0, 1, 2, 3), gains=(0.25, 1.0), device=device)
    rates = hist.events.to(torch.float32).mean(dim=(0, 2)).cpu()
    print(f"\nseed  K     realized participation (target "
          f"{cfg.participation})")
    for (seed, k, _), rate in zip(grid_runs, rates.tolist(), strict=True):
        print(f"{seed:4d}  {k:4.2f}  {rate:.3f}")
    return {"events_equal": ev_equal, "omega_gap": omega_gap,
            "runs": [(s, k, r) for (s, k, _), r in
                     zip(grid_runs, rates.tolist(), strict=True)]}


if __name__ == "__main__":
    main()

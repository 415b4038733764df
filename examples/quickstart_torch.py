"""Quickstart on the PyTorch/CUDA port: FedBack on synthetic non-iid
MNIST (the twin of ``examples/quickstart.py``).

20 clients with 2 digits each (pathological non-iid), target rate 20%,
the compact round (solver rows ≤ ⌈1.5·L̄·N⌉, the overflow carried by the
deferral queue), K = 2, on the flat (N, D) client-state layout.  What
differs: it runs on the card unless ``--device cpu``; ``--rounds``
shortens the reference's 120; the weights come from the port's threefry
twin of ``jax.random.PRNGKey(0)``, so they are the reference's.

    PYTHONPATH=src python examples/quickstart_torch.py
    PYTHONPATH=src python examples/quickstart_torch.py --device cpu --rounds 20
"""
import argparse

from repro_torch import prng
from repro_torch.core import ControllerConfig, FLConfig, init_state, \
    make_eval_fn, make_round_fn
from repro_torch.data import federated_arrays, make_synthetic_mnist
from repro_torch.device import resolve_device
from repro_torch.models import init_mlp, make_loss_and_acc_fn, make_loss_fn
from repro_torch.utils import make_flat_spec


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=120)
    ap.add_argument("--device", default=None,
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    n = 20

    ds = make_synthetic_mnist(n_train=4200, n_test=1000)
    data, test = federated_arrays(ds, n_clients=n, scheme="label_shard",
                                  device=device)
    cfg = FLConfig(
        algorithm="fedback", n_clients=n, participation=0.2,
        rho=0.01, lr=0.01, epochs=2, batch_size=42,
        compact=True, capacity_slack=1.5,
        controller=ControllerConfig(K=2.0, alpha=0.9))
    params0 = init_mlp(prng.PRNGKey(0, device=device), device=device)
    spec = make_flat_spec(params0)
    state = init_state(cfg, params0, spec=spec, device=device)
    round_fn = make_round_fn(cfg, make_loss_fn(), data, spec=spec,
                             device=device)
    eval_fn = make_eval_fn(make_loss_and_acc_fn(), spec=spec, device=device)

    total_events, last = 0, args.rounds - 1
    print(f"{'round':>5} {'events':>6} {'cum_events':>10} "
          f"{'mean_delta':>10} {'deferred':>8} {'slack':>6} "
          f"{'accuracy':>8}")
    for k in range(args.rounds):
        state, m = round_fn(state)
        total_events += int(m.num_events)
        if k % 10 == 0 or k == last:
            _, acc = eval_fn(state, test["x"], test["y"])
            print(f"{k:5d} {int(m.num_events):6d} {total_events:10d} "
                  f"{float(m.delta.mean()):10.3f} "
                  f"{int(m.num_deferred):8d} "
                  f"{float(m.realized_slack):6.2f} {float(acc):8.3f}")
    rate = total_events / (args.rounds * n)
    print(f"\nrealized participation rate: {rate:.3f} (target 0.2)")
    print(f"deferral queue at exit: {int(m.num_deferred)} "
          f"(lossless carry; see docs/compaction.md)")
    return {"accuracy": float(acc), "rate": rate, "events": total_events,
            "deferred": int(m.num_deferred), "device": str(device)}


if __name__ == "__main__":
    main()

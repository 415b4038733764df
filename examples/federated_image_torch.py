"""Federated image classification on the PyTorch/CUDA port: the paper's
§5 grid, checkpoints and the events-to-accuracy report (the twin of
``examples/federated_image.py``).

Runs FedBack and the paper's baselines (``fedadmm``, ``fedavg``,
``fedprox``; ``--algorithm all`` runs the four in turn) on the paper
grid's data and weights, ``configs.paper_mnist.workload()`` (100
clients, 2 digits each, the 784-200-10 MLP) or
``configs.paper_cifar.workload()`` (100 clients, Dirichlet β = 0.5, the
CNN), with the paper's hyper-parameters (``fl_config``), and reports the
participation events each took to reach the paper's accuracy threshold.

What differs from the reference: the data and weights are the paper
grid's (the reference builds 50 clients from the default synthetic sets;
``--clients`` is gone); it runs on the card unless ``--device cpu``;
``--algorithm all`` is new; a checkpoint is written
after round k as step k + 1 (the rounds done) and a resumed run starts
at that round, where the reference saves after round k as step k and
runs round k again when it resumes.

    PYTHONPATH=src python examples/federated_image_torch.py \\
        --dataset mnist --algorithm fedback --rate 0.1 --rounds 300
    PYTHONPATH=src python examples/federated_image_torch.py --device cpu \\
        --algorithm all --rounds 2 --ckpt-dir /tmp/ck --ckpt-every 1
"""
import argparse
import os

from repro_torch.checkpoint import latest_checkpoint, load_checkpoint, \
    save_checkpoint
from repro_torch.configs import paper_cifar, paper_mnist
from repro_torch.core import init_state, make_eval_fn, make_round_fn
from repro_torch.device import resolve_device
from repro_torch.models import make_loss_and_acc_fn, make_loss_fn

ALGORITHMS = ("fedback", "fedadmm", "fedavg", "fedprox")


def run(algorithm, workload, paper, *, rate, rounds, device, ckpt_dir=None,
        ckpt_every=100) -> dict:
    """One algorithm's run: its events to the paper's threshold, the
    final accuracy and the participation events."""
    data, test, params0, logits = workload
    cfg = paper.fl_config(algorithm, rate)
    state = init_state(cfg, params0, device=device)
    start = 0
    if ckpt_dir:
        ck = latest_checkpoint(ckpt_dir)
        if ck:
            state = load_checkpoint(ck, state)
            start = int(os.path.basename(ck).split("_")[1].split(".")[0])
            print(f"resumed from {ck} (round {start})")
    round_fn = make_round_fn(cfg, make_loss_fn(logits), data, device=device)
    eval_fn = make_eval_fn(make_loss_and_acc_fn(logits), device=device)
    target = paper.TARGET_ACCURACY
    cum_events, reached, acc = 0, None, None
    for k in range(start, rounds):
        state, m = round_fn(state)
        cum_events += int(m.num_events)
        if k % 5 == 0 or k == rounds - 1:
            loss, acc = (float(x) for x in eval_fn(state, test["x"],
                                                   test["y"]))
            if reached is None and acc >= target:
                reached = cum_events
            print(f"round {k:4d} events={int(m.num_events):3d} "
                  f"cum={cum_events:6d} loss={loss:.4f} acc={acc:.4f}",
                  flush=True)
        if ckpt_dir and (k + 1) % ckpt_every == 0:
            save_checkpoint(ckpt_dir, k + 1, state)
    print(f"\n{algorithm} @ L̄={rate}: "
          + (f"reached {target:.0%} after {reached} participation events"
             if reached else f"did not reach {target:.0%} "
             f"in {rounds} rounds ({cum_events} events)"), flush=True)
    return {"algorithm": algorithm, "events_to_target": reached,
            "events": cum_events, "accuracy": acc, "start": start}


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dataset", default="mnist", choices=["mnist", "cifar"])
    ap.add_argument("--algorithm", default="fedback",
                    choices=[*ALGORITHMS, "admm", "all"])
    ap.add_argument("--rate", type=float, default=0.1)
    ap.add_argument("--rounds", type=int, default=300)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--device", default=None,
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    paper = paper_mnist if args.dataset == "mnist" else paper_cifar
    workload = paper.workload(0, device=device)
    algorithms = ALGORITHMS if args.algorithm == "all" else (args.algorithm,)
    reports = []
    for alg in algorithms:
        ckpt = (os.path.join(args.ckpt_dir, alg)
                if args.ckpt_dir and len(algorithms) > 1 else args.ckpt_dir)
        reports.append(run(alg, workload, paper, rate=args.rate,
                           rounds=args.rounds, device=device, ckpt_dir=ckpt,
                           ckpt_every=args.ckpt_every))
    print(f"\nevents to {paper.TARGET_ACCURACY:.0%} ({args.dataset}, "
          f"L̄ = {args.rate}, {args.rounds} rounds):")
    for r in reports:
        print(f"  {r['algorithm']:8s} {r['events_to_target'] or '—':>8} "
              f"(final accuracy {r['accuracy']:.4f}, {r['events']} events)")
    return reports


if __name__ == "__main__":
    main()

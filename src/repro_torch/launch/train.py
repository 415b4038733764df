"""Training launcher (port of ``repro/launch/train.py``).

Two engines:

* ``--engine sim`` — the paper's cross-silo simulation (N clients on
  one card; any algorithm; the paper datasets): ``init_state`` /
  ``make_round_fn`` / ``make_eval_fn`` on paper-MNIST or paper-CIFAR,
  the reference's end-to-end driver;
* ``--engine crosspod`` — the cross-pod FedBack engine
  (``core/crosspod.py``) over a zoo model (``--arch``; ``--reduced``
  cuts it as the reference does): one silo per pod, each training its
  own replica on synthetic next-token batches made with numpy from seed
  0, ω the mean over the pods (the token families: dense, moe, ssm,
  hybrid; the vlm and audio families take embeddings and are refused).

The flags and printed lines are the reference's, except that
``--device`` (``cuda``, the default, which raises without a card; or
``cpu``) says where ``--host-devices`` lays its mesh coordinates, and
``--shards`` places the pods on shards of the visible cards (one
controller, ``core/crosspod.py``'s client mesh).

``--host-devices N`` (default: the number of visible cards; 1 with
``--device cpu``) and ``--model-par M`` (default 1) give the
reference's ``pod × data × model`` mesh, (pods, max(N // pods // M, 1),
M), its coordinates laid over the visible cards in turn (every one on
the card where there is one card; on the CPU with ``--device cpu``).
Where that mesh puts more than one coordinate in a pod, each pod's
replica is trained fsdp over its (data, model) coordinates and the
round is ``sharding.train.make_cross_pod_round_on_mesh``'s; otherwise
all pods sit on one device (or on ``--shards`` shards).  ``--shards``
with such a mesh raises.

    python -m repro_torch.launch.train --engine sim \\
        --dataset mnist --algorithm fedback --rate 0.1 --rounds 200
    python -m repro_torch.launch.train --engine crosspod \\
        --arch granite-3-2b --rounds 10
    python -m repro_torch.launch.train --engine crosspod \\
        --arch granite-3-2b --rounds 10 --host-devices 8 --model-par 2
    PYTHONPATH=src python -m repro_torch.launch.train --engine crosspod \\
        --arch granite-3-2b --reduced --rounds 2 --device cpu
"""
from __future__ import annotations

import argparse

import numpy as np
import torch


def _sim(args, device):
    from repro_torch import prng
    from repro_torch.checkpoint import save_checkpoint
    from repro_torch.configs import paper_cifar, paper_mnist
    from repro_torch.core import init_state, make_eval_fn, make_round_fn
    from repro_torch.data import federated_arrays, make_synthetic_cifar, \
        make_synthetic_mnist
    from repro_torch.models import cnn_logits, init_cnn, init_mlp, \
        make_loss_and_acc_fn, make_loss_fn, mlp_logits

    key = prng.PRNGKey(0, device=device)
    if args.dataset == "mnist":
        ds = make_synthetic_mnist()
        data, test = federated_arrays(ds, n_clients=args.clients,
                                      scheme="label_shard", device=device)
        params0, logits = init_mlp(key, device=device), mlp_logits
        cfg = paper_mnist.fl_config(args.algorithm, args.rate,
                                    n_clients=args.clients)
    else:
        ds = make_synthetic_cifar()
        data, test = federated_arrays(ds, n_clients=args.clients,
                                      scheme="dirichlet", beta=0.5,
                                      device=device)
        params0, logits = init_cnn(key, device=device), cnn_logits
        cfg = paper_cifar.fl_config(args.algorithm, args.rate,
                                    n_clients=args.clients)

    state = init_state(cfg, params0, device=device)
    round_fn = make_round_fn(cfg, make_loss_fn(logits), data, device=device)
    eval_fn = make_eval_fn(make_loss_and_acc_fn(logits), device=device)
    cum = 0
    for k in range(args.rounds):
        state, m = round_fn(state)
        cum += int(m.num_events)
        if k % args.log_every == 0 or k == args.rounds - 1:
            loss, acc = eval_fn(state, test["x"], test["y"])
            print(f"round {k:4d} events={int(m.num_events):3d} cum={cum:6d}"
                  f" loss={float(loss):.4f} acc={float(acc):.4f}",
                  flush=True)
        if args.ckpt_dir and k and k % 100 == 0:
            save_checkpoint(args.ckpt_dir, k, state)


def _crosspod(args, device):
    from repro_torch.configs import get_config
    from repro_torch.core.controller import ControllerConfig
    from repro_torch.core.crosspod import CrossPodConfig, \
        init_cross_pod_state, make_cross_pod_round
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import build_model
    from repro_torch.sharding import make_client_mesh
    from repro_torch.sharding.params import shard_tree
    from repro_torch.sharding.train import cross_pod_batch_specs, \
        init_cross_pod_state_on_mesh, make_cross_pod_round_on_mesh

    pods = args.pods
    cpu = [device] if device.type == "cpu" else None
    n = args.host_devices or (1 if cpu else torch.cuda.device_count())
    shape = (pods, max(n // pods // args.model_par, 1), args.model_par)
    mesh = model_mesh = None
    if shape[1] * shape[2] > 1:
        if args.shards > 1:
            raise SystemExit(f"--shards places whole pods; the mesh {shape} "
                             "splits each pod over (data, model)")
        model_mesh = make_mesh(shape, ("pod", "data", "model"), cpu)
        print(f"mesh: {model_mesh.shape}")
    elif args.shards > 1:
        mesh = make_client_mesh(args.shards, cpu)
        print(f"mesh: {{'pod': {pods}, 'shards': {args.shards}, 'devices': "
              f"{[str(d) for d in mesh.devices]}}}")
    else:
        print(f"mesh: {{'pod': {pods}, 'device': '{device}'}}")

    cfg = get_config(args.arch)
    if cfg.family in ("vlm", "audio"):
        # The reference's launcher fails here with a KeyError in the loss.
        what = "patch embeddings" if cfg.family == "vlm" else \
            "frame embeddings in place of tokens"
        raise SystemExit(f"--engine crosspod trains on next-token batches; "
                         f"{cfg.name} ({cfg.family}) takes {what}")
    if args.reduced:
        cfg = cfg.reduced(num_layers=2, d_model=128, vocab_size=512,
                          remat=False)
    model = build_model(cfg)
    cp = CrossPodConfig(
        n_pods=pods, rho=args.rho, lr=args.lr, local_steps=args.local_steps,
        controller=ControllerConfig(K=args.gain, alpha=0.9,
                                    target_rate=args.rate))
    params0 = model.init(0, device=device)
    if model_mesh is not None:
        round_fn = make_cross_pod_round_on_mesh(cp, model, model_mesh)
        state = init_cross_pod_state_on_mesh(cp, params0, model_mesh)
    else:
        round_fn = make_cross_pod_round(cp, model.loss, mesh=mesh)
        state = init_cross_pod_state(cp, params0, device=None if mesh else
                                     device, mesh=mesh)
    del params0

    rng = np.random.default_rng(0)
    cum = 0
    for k in range(args.rounds):
        toks = torch.from_numpy(rng.integers(
            0, cfg.vocab_size,
            (pods, cp.local_steps, args.batch, args.seq + 1)))
        batch = {"tokens": toks[..., :-1], "labels": toks[..., 1:]}
        if model_mesh is not None:
            batch = shard_tree(batch, cross_pod_batch_specs(batch),
                               model_mesh)
        state, m = round_fn(state, batch)
        cum += int(m.num_events)
        print(f"round {k:3d} events={m.events.cpu().numpy().astype(int)} "
              f"cum={cum} loss={float(m.train_loss):.4f}", flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--engine", default="sim", choices=["sim", "crosspod"])
    # sim
    ap.add_argument("--dataset", default="mnist",
                    choices=["mnist", "cifar"])
    ap.add_argument("--algorithm", default="fedback")
    ap.add_argument("--clients", type=int, default=50)
    ap.add_argument("--log-every", type=int, default=5)
    ap.add_argument("--ckpt-dir", default=None)
    # crosspod
    ap.add_argument("--arch", default="granite-3-2b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--pods", type=int, default=2)
    ap.add_argument("--shards", type=int, default=1,
                    help="client-mesh shards the pods are placed on "
                         "(1 = all pods on one device)")
    ap.add_argument("--model-par", type=int, default=1)
    ap.add_argument("--host-devices", type=int, default=0,
                    help="mesh coordinates laid over the visible cards "
                         "(default: their number; 1 with --device cpu)")
    ap.add_argument("--local-steps", type=int, default=2)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--rho", type=float, default=1e-3)
    ap.add_argument("--lr", type=float, default=5e-3)
    ap.add_argument("--gain", type=float, default=0.05)
    # shared
    ap.add_argument("--rate", type=float, default=0.1)
    ap.add_argument("--rounds", type=int, default=100)
    ap.add_argument("--device", default=None,
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)

    from repro_torch.device import fp32_products, resolve_device
    device = resolve_device(args.device)
    fp32_products(device)
    (_sim if args.engine == "sim" else _crosspod)(args, device)


if __name__ == "__main__":
    main()

"""Cross-pod FedBack on a small LM on the PyTorch/CUDA port (the twin of
``examples/fedback_transformer.py``).

Each pod is one silo training a reduced granite-family decoder on its
own (skewed) synthetic token distribution; ω is the mean of the pods'
last committed z, and the integral controller gates which pods commit,
round by round (``core/crosspod.py``).

What differs: the reference runs a pod × data × model mesh of 8 forced
host devices, its consensus a collective over the pod axis.  Here the
two pods are the shards of a pod mesh (``sharding.make_client_mesh(2,
[device])``: both on the card, or on the CPU with ``--device cpu``) and
there are no data or model axes — one card holds a pod whole (the
``jax.sharding`` placement of parameters and activations has no
counterpart).  ``--rounds`` shortens the reference's 24.  The token
streams are the reference's numpy draws from ``default_rng(0)``.

    PYTHONPATH=src python examples/fedback_transformer_torch.py
    PYTHONPATH=src python examples/fedback_transformer_torch.py --device cpu
"""
import argparse

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core.controller import ControllerConfig
from repro_torch.core.crosspod import CrossPodConfig, init_cross_pod_state, \
    make_cross_pod_round
from repro_torch.device import resolve_device
from repro_torch.models import build_model
from repro_torch.sharding import make_client_mesh


def synthetic_tokens(rng, pods, steps, batch, seq, vocab, skew):
    """Per-pod token streams with different unigram skews (non-iid)."""
    out = []
    for _ in range(pods):
        logits = skew * rng.standard_normal(vocab)
        p = np.exp(logits - logits.max())
        p /= p.sum()
        out.append(rng.choice(vocab, size=(steps, batch, seq + 1), p=p))
    toks = torch.from_numpy(np.stack(out))  # (pods, steps, batch, seq+1)
    return {"tokens": toks[..., :-1], "labels": toks[..., 1:]}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=24)
    ap.add_argument("--device", default=None,
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = get_config("granite-3-2b").reduced(
        num_layers=2, d_model=128, vocab_size=512, remat=False)
    model = build_model(cfg)
    cp = CrossPodConfig(
        n_pods=2, rho=1e-3, lr=5e-3, local_steps=2,
        controller=ControllerConfig(K=0.05, alpha=0.9, target_rate=0.5))
    mesh = make_client_mesh(cp.n_pods, [device])
    round_fn = make_cross_pod_round(cp, model.loss, mesh=mesh)
    state = init_cross_pod_state(cp, model.init(0, device=device),
                                 mesh=mesh)

    rng = np.random.default_rng(0)
    print(f"pods on {[str(d) for d in mesh.devices]}")
    print(f"{'round':>5} {'events':>7} {'dist(pod0,pod1)':>22} "
          f"{'delta':>16} {'loss':>8}")
    losses = []
    for k in range(args.rounds):
        batch = synthetic_tokens(rng, cp.n_pods, cp.local_steps, 8, 64,
                                 cfg.vocab_size, skew=1.5)
        state, m = round_fn(state, batch)
        d, dl = m.distances.cpu().numpy(), m.delta.cpu().numpy()
        losses.append(float(m.train_loss))
        print(f"{k:5d} {m.events.cpu().numpy().astype(int).tolist()!s:>7} "
              f"[{d[0]:8.3f} {d[1]:8.3f}] [{dl[0]:6.3f} {dl[1]:6.3f}] "
              f"{losses[-1]:8.4f}")
    ev = [int(x) for s in state for x in s.ctrl.event_count.cpu()]
    print(f"\nper-pod participation over {args.rounds} rounds: {ev} "
          f"(target rate {cp.controller.target_rate})")
    return {"event_count": ev, "losses": losses, "device": str(device)}


if __name__ == "__main__":
    main()

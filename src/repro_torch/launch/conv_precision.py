"""How precisely the CIFAR CNN's solve computes its convolutions.

    python -m repro_torch.launch.conv_precision [--clients 16] [--rounds 4]

The CNN's local solve batches ``models.mlp.conv3x3_same`` over clients
with ``torch.func.vmap``; on CUDA each pass (forward, data gradient,
weight gradient) is one grouped cuDNN convolution.  The script

* holds each pass at the CNN's three layer shapes (``--clients`` ×
  batch 20 images) against the same passes in float64 — max |error| /
  max |value| — and times it (CUDA events, the median of 5), by route:
  cuDNN as a round runs it (TF32 off), cuDNN with TF32 on, PyTorch's
  convolution with cuDNN off, and ``unfold`` with one matrix product;
* lists the kernels cuDNN launches for the second layer's passes;
* with ``--rounds R``, runs R rounds of the CF-A and CF-T forms of
  ``configs.paper_cifar`` at full width on the card from the seeded
  state, each also from the same state on the CPU's plain path, with
  cuDNN on and off, and prints how far each state field lies from the
  CPU's, relative to the round's update (:func:`update_ratio`).

The passes are linear, so their error is arithmetic alone.  A round's
also holds ReLU and max-pool flips: where two values lie within a
rounding of each other, the two paths may route a gradient differently.
Runs on CUDA; ``--device cpu`` rehearses it at a small size.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import math

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.device import fp32_products, resolve_device
from repro_torch.models.mlp import conv3x3_same

# (c_in, c_out, H = W) of the CNN's three convolutions at 32 × 32 input
LAYERS = ((3, 32, 32), (32, 64, 16), (64, 64, 8))
PASSES = ("y", "gx", "gw")


def unfold_matmul(x, w):
    """:func:`conv3x3_same` as ``unfold`` and one matrix product."""
    n, _, h, wd = x.shape
    cols = F.unfold(x, 3, padding=1)  # (n, c_in·9, h·w), c_in-major
    wm = w.permute(3, 2, 0, 1).reshape(w.shape[3], -1)
    return (wm @ cols).reshape(n, w.shape[3], h, wd)


@contextlib.contextmanager
def cudnn_flags(**flags):
    """Set ``torch.backends.cudnn`` attributes, restored on exit."""
    old = {k: getattr(torch.backends.cudnn, k) for k in flags}
    for k, v in flags.items():
        setattr(torch.backends.cudnn, k, v)
    try:
        yield
    finally:
        for k, v in old.items():
            setattr(torch.backends.cudnn, k, v)


# name → (convolution, cuDNN flags while it runs)
ROUTES = {
    "cudnn": (conv3x3_same, {}),
    "cudnn_tf32": (conv3x3_same, {"allow_tf32": True}),
    "no_cudnn": (conv3x3_same, {"enabled": False}),
    "unfold_matmul": (unfold_matmul, {}),
}


def layer_inputs(clients: int, batch: int, device, seed: int = 0):
    """Per layer, float64 (x, w, gy): images in [0, 1), He-normal HWIO
    kernels and a unit-normal output gradient, for ``clients`` clients
    of ``batch`` images each."""
    g = torch.Generator().manual_seed(seed)
    out = []
    for cin, cout, hw in LAYERS:
        x = torch.rand(clients, batch, cin, hw, hw, generator=g,
                       dtype=torch.float64)
        w = torch.randn(clients, 3, 3, cin, cout, generator=g,
                        dtype=torch.float64) * math.sqrt(2.0 / (9 * cin))
        gy = torch.randn(clients, batch, cout, hw, hw, generator=g,
                         dtype=torch.float64)
        out.append(tuple(t.to(device) for t in (x, w, gy)))
    return out


def batched_passes(conv):
    """vmap over clients of (y, ∂/∂x, ∂/∂w) of ``conv`` given ∂L/∂y."""
    def one(x, w, gy):
        y, pull = torch.func.vjp(conv, x, w)
        return (y,) + pull(gy)
    return torch.func.vmap(one)


def per_example(conv):
    """``conv`` on each image of its batch alone, batched by an inner
    ``vmap`` (the ragged solve's masked loss evaluates the model on
    singleton batches, ``core.engine.masked_batch_loss``)."""
    def each(x, w):
        return torch.func.vmap(lambda xe: conv(xe[None], w)[0])(x)
    return each


def pass_errors(conv, inputs) -> dict:
    """{"conv1": {"y": e, "gx": e, "gw": e}, ...}: max |error| / max
    |value| of ``conv``'s batched passes in fp32 against the same passes
    in float64."""
    run = batched_passes(conv)
    errs = {}
    for i, (x, w, gy) in enumerate(inputs):
        want = run(x, w, gy)
        got = run(x.float(), w.float(), gy.float())
        errs[f"conv{i + 1}"] = {
            p: float((a.double() - b).abs().max() / b.abs().max())
            for p, a, b in zip(PASSES, got, want, strict=True)}
    return errs


def worst(errs: dict) -> float:
    return max(e for layer in errs.values() for e in layer.values())


def _median_ms(fn, device, reps: int = 5) -> float | None:
    if device.type != "cuda":
        return None
    fn()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(True), torch.cuda.Event(True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return sorted(times)[reps // 2]


def update_ratio(got, want, before) -> float:
    """‖got − want‖ / ‖want − before‖ over all leaves of a state field
    (numpy leaves, in float64)."""
    from repro_torch.utils.pytree import tree_leaves

    def norm(a, b):
        return math.sqrt(sum(float(np.sum(np.square(
            x.astype(np.float64) - y.astype(np.float64))))
            for x, y in zip(tree_leaves(a), tree_leaves(b), strict=True)))
    update = norm(want, before)
    return norm(got, want) / update if update else 0.0


def compare_rounds(form: str, n_rounds: int, device, flags: dict):
    """Rounds of a ``paper_cifar`` form on ``device`` under the cuDNN
    ``flags``, each held against the CPU's from the same state: yields
    (round, events equal, committed, {field: update ratio})."""
    from repro_torch.configs import paper_cifar
    from repro_torch.convert import state_from_numpy, state_to_numpy
    from repro_torch.models import make_loss_fn
    from repro_torch.utils import make_flat_spec

    data, _, params0, logits = paper_cifar.workload(0, device=device)
    f, cfg = paper_cifar.FORMS[form], paper_cifar.form_config(form)
    spec = f.spec(make_flat_spec(params0))
    loss_fn = make_loss_fn(logits)
    card = f.make_round(cfg, loss_fn, data, spec=spec, device=device)
    cpu = f.make_round(cfg, loss_fn, {k: v.cpu() for k, v in data.items()},
                       spec=spec, device="cpu")
    state = f.init(cfg, params0, spec=spec, device=device)
    for r in range(n_rounds):
        before = state_to_numpy(state)
        with cudnn_flags(**flags):
            state, m = card(state)
        want, wm = cpu(state_from_numpy(before, device="cpu"))
        got, want = state_to_numpy(state), state_to_numpy(want)
        yield (r + 1, bool(np.array_equal(m.events.cpu().numpy(),
                                          wm.events.numpy())),
               int(m.committed.sum()),
               {k: update_ratio(getattr(got, k), getattr(want, k),
                                getattr(before, k))
                for k in ("theta", "lam", "z_prev", "omega")})


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--clients", type=int, default=16,
                    help="clients batched (a CIFAR round's 16 slots)")
    ap.add_argument("--batch", type=int, default=20)
    ap.add_argument("--rounds", type=int, default=0)
    ap.add_argument("--device", default=None)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    fp32_products(device)
    inputs = layer_inputs(args.clients, args.batch, device)
    for name, (conv, flags) in ROUTES.items():
        with cudnn_flags(**flags):
            errs = pass_errors(conv, inputs)
            run = batched_passes(conv)
            ms = {f"conv{i + 1}": _median_ms(
                lambda x=x.float(), w=w.float(), gy=gy.float(): run(x, w, gy),
                device) for i, (x, w, gy) in enumerate(inputs)}
        print(json.dumps({"route": name, "worst": worst(errs),
                          "errors": errs, "ms": ms}), flush=True)
    if device.type == "cuda":
        from torch.profiler import ProfilerActivity, profile
        x, w, gy = (t.float() for t in inputs[1])
        run = batched_passes(conv3x3_same)
        run(x, w, gy)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            run(x, w, gy)
            torch.cuda.synchronize()
        kernels = sorted({e.key[:100] for e in prof.key_averages()
                          if not e.key.startswith(("cuda", "Activity",
                                                   "Buffer"))})
        print(json.dumps({"conv2 kernels (cudnn)": kernels}), flush=True)
    for form in ("CF-A", "CF-T") if args.rounds else ():
        for route, flags in (("cudnn", {}), ("no_cudnn", {"enabled": False})):
            for r, same, committed, ratios in compare_rounds(
                    form, args.rounds, device, flags):
                print(json.dumps({"form": form, "route": route, "round": r,
                                  "events_equal": same,
                                  "committed": committed,
                                  "update_ratio": ratios}), flush=True)


if __name__ == "__main__":
    main()

"""Device time of the port's kernels at their main paths' shapes.

- The FedBack round's K1 ``trigger_sq_norms`` at (100, 159010), K2
  ``admm_update`` (with_z=False, as the dense round calls it) at the
  same width and K3 ``fused_gss`` with C = 16 slots of which 14 are
  valid, each timed two ways: **warm**, :func:`device_ms` on one set of
  inputs (K3's 36 MB footprint then sits in the H100's 50 MB L2), and
  **cold**, the captured calls rotating over ``COLD_COPIES`` sets of
  inputs, so that no call finds its rows in L2, as in the round, where
  the solve runs between the gather and the commit.  Beside each, the
  bytes it must move and that over the card's HBM rate (the bound).
- The zamba2-2.7b prefill's K4 ``flash_attention`` at (4, 2048, 32, 80)
  bf16 causal in the model's (B, S, H, hd) layout, with
  ``scaled_dot_product_attention`` on the same inputs beside it; K4 on
  the same shape in fp32 (the instance the checkout's rule picks for
  fresh tensors: SIMT before the 3xTF32 instance existed, 3xTF32
  since), with ``scaled_dot_product_attention`` in fp32 beside it; and
  K5 ``ssd_scan`` at states (4, 32, 80, 64, 64) bf16.
- The other model shapes: K4 at phi3-medium-14b's prefill, (4, 2048,
  40:10, 128) bf16 causal (GQA, g = 4), and at
  moonshot-v1-16b-a3b's, (4, 2048, 16:16, 128) bf16 causal (MHA, g =
  1), each beside ``scaled_dot_product_attention(..., enable_gqa=True)``,
  and K5 at mamba2-2.7b's, states (4, 32, 80, 64, 128) bf16.
- How fp32 K4's device time splits between the kernels it launches
  (the 3xTF32 instance's pre-pass and main kernel), from torch.profiler
  (:func:`kernel_breakdown`).
- The tree and sharded triggers, cold (:func:`trigger_forms_ms`): K1c
  ``trigger_sq_norms_pytree`` on the MLP's 4 and the CNN's 12 leaves
  stacked for N = 100, K1b ``trigger_sq_norms_sharded``'s whole call on
  P = 2 and 4 shards of (100, 159010) on the card, and a lone call on
  one (25, 159010) shard.

``chip_smoke.py`` times every kernel with :func:`device_ms`; this
script applies the same measure to another checkout, so two commits are
compared on one card in one call::

    python3 src/repro_torch/launch/time_kernels.py [--src DIR]

Run it as a file (not with ``-m``): ``--src`` names the ``src``
directory whose ``repro_torch`` is built and timed, by default the one
that holds this file — e.g. ``build/parent/src`` for an earlier commit
unpacked with ``git archive``.  Prints one JSON line.  Needs a card.
"""
from __future__ import annotations

import argparse
import functools
import importlib.util
import itertools
import json
import statistics
import subprocess
import sys
from pathlib import Path

import torch


def _load_roofline():
    """``roofline.py`` beside this file, loaded by its path: the peak
    tables come from this tree even when ``--src`` times an earlier one
    (which may have no ``launch/roofline.py``)."""
    path = Path(__file__).resolve().with_name("roofline.py")
    spec = importlib.util.spec_from_file_location("_time_kernels_roofline",
                                                  path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


# Peak HBM bandwidth by card name, for bound_ms.
peak_bandwidth = _load_roofline().peak_bandwidth
# The FedBack round at the paper-MNIST width: clients, D, slots, valid.
ROUND_N, ROUND_D, ROUND_C, ROUND_VALID = 100, 159010, 16, 14
# Input sets the cold measure rotates over: 4 × K3's 36 MB footprint
# (4 × 64 MB for K1) between two calls on one set, beyond the 50 MB L2.
COLD_COPIES = 4


def device_ms(fn, calls: int = 20, reps: int = 7) -> float:
    """Device time of one call: ``calls`` calls captured in a CUDA graph,
    the graph replayed ``reps`` times between CUDA events, the median per
    call.  No host work lies between the launches, so a kernel shorter
    than its wrapper's host path is timed as the card runs it."""
    fn()  # warm up (builds, caches) outside the capture
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    del graph
    return statistics.median(times)


def cycle(calls):
    """One closure that makes the next of ``calls`` each time, round and
    round: captured by :func:`device_ms`, the graph's launches rotate
    over the inputs the calls close over."""
    it = itertools.cycle(calls)
    return lambda: next(it)()


def kernel_breakdown(fn, calls: int = 10) -> dict:
    """{CUDA kernel name: device ms per call of ``fn``}, from
    torch.profiler over ``calls`` calls after one warm-up: how a call
    that launches more than one kernel splits its time (the device-side
    copies of the port's spans left out)."""
    from torch.profiler import ProfilerActivity, profile
    try:
        from repro_torch.utils.spans import is_span
    except ImportError:  # an earlier tree (``--src``) has no spans
        def is_span(key):
            return False
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return {e.key: e.device_time_total / 1e3 / calls
            for e in prof.key_averages()
            if e.device_time_total > 0 and not is_span(e.key)}


def round_kernel_ms(ops, dev, gen, dtype=torch.float32) -> dict:
    """{name: {"warm", "cold", "bytes", "bound_ms"}} for K1, K2 and K3 at
    the round's shapes, over ``COLD_COPIES`` sets of inputs made from
    ``gen`` (bound_ms None on a card the table does not name); with
    ``dtype=torch.bfloat16``, K2a and K3a (``admm_update_bf16``,
    ``fused_gss_bf16``) at the same shapes, their bytes at 2 an
    element."""
    n, d, c = ROUND_N, ROUND_D, ROUND_C
    bf16 = dtype == torch.bfloat16
    eb = 2 if bf16 else 4
    sfx = "_bf16" if bf16 else ""

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    calls = {} if bf16 else {"trigger_sq_norms": []}
    calls.update({f"admm_update{sfx}": [], f"fused_gss{sfx}": []})
    valid = torch.arange(c, device=dev) < ROUND_VALID
    for _ in range(COLD_COPIES):
        z, w = randn(n, d), randn(d)
        if not bf16:
            calls["trigger_sq_norms"].append(
                functools.partial(ops.trigger_sq_norms, z, w))
        th, la = randn(n, d), randn(n, d)
        calls[f"admm_update{sfx}"].append(
            functools.partial(ops.admm_update, th, la, w, with_z=False))
        idx = torch.randperm(n, generator=gen, device=dev)[:c].to(
            torch.int32)
        state = (randn(n, d), randn(n, d), randn(n, d))
        calls[f"fused_gss{sfx}"].append(functools.partial(
            ops.fused_gss, idx, valid, randn(c, d), w, *state))
    nbytes = {"trigger_sq_norms": ops.trigger_sq_norms_hbm_bytes(n, d),
              f"admm_update{sfx}": ops.admm_update_hbm_bytes(
                  n, d, with_z=False, dtype_bytes=eb),
              f"fused_gss{sfx}": ops.fused_gss_hbm_bytes(
                  ROUND_VALID, d, dtype_bytes=eb) + 5 * c}
    bw = peak_bandwidth(torch.cuda.get_device_name(dev))
    return {name: dict(warm=device_ms(fns[0]), cold=device_ms(cycle(fns)),
                       bytes=nbytes[name],
                       bound_ms=nbytes[name] / bw * 1e3 if bw else None)
            for name, fns in calls.items()}


# The paper models' leaves without the client axis: the MNIST MLP's and
# the CIFAR CNN's (HWIO kernels).
MLP_LEAVES = {"fc1": {"w": (784, 200), "b": (200,)},
              "fc2": {"w": (200, 10), "b": (10,)}}
CNN_LEAVES = {"conv1": {"w": (3, 3, 3, 32), "b": (32,)},
              "conv2": {"w": (3, 3, 32, 64), "b": (64,)},
              "conv3": {"w": (3, 3, 64, 64), "b": (64,)},
              "fc1": {"w": (1024, 128), "b": (128,)},
              "fc2": {"w": (128, 64), "b": (64,)},
              "fc3": {"w": (64, 10), "b": (10,)}}


def trigger_forms_ms(ops, dev, gen) -> dict:
    """{name: cold device ms} of K1c on the MLP's and the CNN's leaves
    stacked for N = 100, of K1b's whole call on P = 2 and 4 shards of
    (100, 159010) on ``dev``, and of K1b on one (25, 159010) shard, each
    rotating over ``COLD_COPIES`` input sets made from ``gen``."""
    from repro_torch.sharding import make_client_mesh, replicate_data, \
        shard_rows

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    def tree(spec, *n):
        return {k: {j: randn(*n, *shape) for j, shape in v.items()}
                for k, v in spec.items()}

    n, d = ROUND_N, ROUND_D
    calls = {}
    for name, spec in (("pytree_mlp", MLP_LEAVES), ("pytree_cnn", CNN_LEAVES)):
        calls[name] = [functools.partial(ops.trigger_sq_norms_pytree,
                                         tree(spec, n), tree(spec))
                       for _ in range(COLD_COPIES)]
    for p, rows in ((2, n), (4, n), (1, n // 4)):
        mesh = make_client_mesh(p, [dev])
        calls[f"sharded_p{p}_rows{rows}"] = [
            functools.partial(ops.trigger_sq_norms_sharded,
                              shard_rows(randn(rows, d), mesh),
                              replicate_data(mesh, randn(d)), mesh)
            for _ in range(COLD_COPIES)]
    return {name: device_ms(cycle(fns)) for name, fns in calls.items()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", type=Path,
                    default=Path(__file__).resolve().parents[2],
                    help="the src directory whose repro_torch is timed")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("time_kernels: no CUDA device is visible", file=sys.stderr)
        return 1
    src = args.src.resolve()
    sys.path.insert(0, str(src))
    from repro_torch.kernels import ops

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False  # as chip_smoke.py
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    q32, k32, v32 = (torch.randn((4, 2048, 32, 80), generator=gen,
                                 device=dev) for _ in range(3))
    q, k, v = (t.to(torch.bfloat16) for t in (q32, k32, v32))
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    qt32, kt32, vt32 = (t.transpose(1, 2).contiguous()
                        for t in (q32, k32, v32))
    states = torch.randn((4, 32, 80, 64, 64), generator=gen,
                         device=dev).to(torch.bfloat16)
    decays = torch.rand((4, 32, 80), generator=gen, device=dev)
    pq = torch.randn((4, 2048, 40, 128), generator=gen,
                     device=dev).to(torch.bfloat16)
    pk, pv = (torch.randn((4, 2048, 10, 128), generator=gen,
                          device=dev).to(torch.bfloat16) for _ in range(2))
    pqt, pkt, pvt = (t.transpose(1, 2).contiguous() for t in (pq, pk, pv))
    states128 = torch.randn((4, 32, 80, 64, 128), generator=gen,
                            device=dev).to(torch.bfloat16)
    mq, mk, mv = (torch.randn((4, 2048, 16, 128), generator=gen,
                              device=dev).to(torch.bfloat16)
                  for _ in range(3))
    mqt, mkt, mvt = (t.transpose(1, 2).contiguous() for t in (mq, mk, mv))
    rounds = round_kernel_ms(ops, dev, gen)
    ms = {
        "flash_attention": device_ms(
            lambda: ops.flash_attention(q, k, v, layout="bshd")),
        "scaled_dot_product_attention": device_ms(
            lambda: torch.nn.functional.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True, enable_gqa=True)),
        "flash_attention_fp32": device_ms(
            lambda: ops.flash_attention(q32, k32, v32, layout="bshd")),
        "scaled_dot_product_attention_fp32": device_ms(
            lambda: torch.nn.functional.scaled_dot_product_attention(
                qt32, kt32, vt32, is_causal=True, enable_gqa=True)),
        "ssd_scan": device_ms(lambda: ops.ssd_scan(states, decays)),
        "flash_attention_phi3": device_ms(
            lambda: ops.flash_attention(pq, pk, pv, layout="bshd")),
        "scaled_dot_product_attention_phi3": device_ms(
            lambda: torch.nn.functional.scaled_dot_product_attention(
                pqt, pkt, pvt, is_causal=True, enable_gqa=True)),
        "ssd_scan_mamba2": device_ms(lambda: ops.ssd_scan(states128,
                                                          decays)),
        "flash_attention_moonshot": device_ms(
            lambda: ops.flash_attention(mq, mk, mv, layout="bshd")),
        "scaled_dot_product_attention_moonshot": device_ms(
            lambda: torch.nn.functional.scaled_dot_product_attention(
                mqt, mkt, mvt, is_causal=True, enable_gqa=True)),
    }
    fp32_kernels = kernel_breakdown(
        lambda: ops.flash_attention(q32, k32, v32, layout="bshd"))
    triggers = trigger_forms_ms(ops, dev, gen)
    print(json.dumps({"src": str(src), "card": smi, "device_ms": ms,
                      "round_kernels": rounds,
                      "flash_attention_fp32_kernels": fp32_kernels,
                      "trigger_forms_ms": triggers}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

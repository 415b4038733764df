"""Device time of the zamba2-2.7b prefill's kernels at their serve shapes:
K4 ``flash_attention`` at (4, 2048, 32, 80) bf16 causal in the model's
(B, S, H, hd) layout, with ``scaled_dot_product_attention`` on the same
inputs beside it, and K5 ``ssd_scan`` at states (4, 32, 80, 64, 64)
bf16.  ``chip_smoke.py`` times every kernel with :func:`device_ms`; this
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
import json
import statistics
import subprocess
import sys
from pathlib import Path

import torch


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
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    q, k, v = (torch.randn((4, 2048, 32, 80), generator=gen, device=dev)
               .to(torch.bfloat16) for _ in range(3))
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    states = torch.randn((4, 32, 80, 64, 64), generator=gen,
                         device=dev).to(torch.bfloat16)
    decays = torch.rand((4, 32, 80), generator=gen, device=dev)
    ms = {
        "flash_attention": device_ms(
            lambda: ops.flash_attention(q, k, v, layout="bshd")),
        "scaled_dot_product_attention": device_ms(
            lambda: torch.nn.functional.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True, enable_gqa=True)),
        "ssd_scan": device_ms(lambda: ops.ssd_scan(states, decays)),
    }
    print(json.dumps({"src": str(src), "card": smi, "device_ms": ms}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Where LM serving spends its time, from torch.profiler.

    python -m repro_torch.launch.profile_serve [--arch zamba2-2.7b]
        [--batch 4] [--prompt-len 2048] [--decode-steps 8]
        [--mesh 1,4 --mode tp]

Builds the model at full width and depth (the reference's init of
``--seed``), warms prefill and decode up, then profiles one prefill
and ``--decode-steps`` decode steps and prints, for each phase (with
``--mesh D,M``: the serving steps of ``launch/steps.py`` on a (data D,
model M) mesh of the visible cards in ``--mode``, fsdp, tp, fsdp_tp or
ep, for any architecture that serves):

* the wall time (host clock around work that ends in a synchronize);
* the device's busy time (sum of kernel durations; serving runs on one
  stream, so kernels do not overlap) and its idle share;
* kernel launches, the device time by kind — K4 ``flash_attention``,
  K5 ``ssd_scan``, matrix products (cuBLAS), and everything else;
* the kernels that took the most device time.

Runs on CUDA; ``--device cpu --reduced`` rehearses the script (host
times only).
"""
from __future__ import annotations

import argparse
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from repro_torch.configs import get_config
from repro_torch.device import resolve_device
from repro_torch.launch.serve_lm import cache_len, make_request
from repro_torch.models import build_model
from repro_torch.sharding.serve import SERVE_MODES
from repro_torch.utils.spans import is_span

# Kernel-name fragments by kind; the first match wins.
KINDS = (("K4 flash_attention", ("flash_attention_kernel",
                                  "flash_attention_tc_kernel")),
         ("K5 ssd_scan", ("ssd_scan_kernel", "ssd_scan_vec_kernel")),
         ("matmul (cuBLAS)", ("gemm", "nvjet", "xmma", "cutlass",
                              "splitK")))
# Copies (a mesh's gathers, dtype casts), counted again on a line of
# their own: most of them are PyTorch's elementwise kernels.
COPIES = ("Memcpy", "copy_kernel", "CatArrayBatchedCopy")


def kind_of(name: str) -> str:
    for kind, frags in KINDS:
        if any(f in name for f in frags):
            return kind
    return "other"


def sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def profile_phase(label, fn, reps, device) -> list[str]:
    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        sync(device)
        wall_ms = (time.perf_counter() - t0) * 1e3 / reps
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and not is_span(e.key)]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3 / reps
    launches = sum(e.count for e in kernels) / reps
    lines = [f"{label} (per call, {reps} calls): wall {wall_ms:.3f} ms, "
             f"device busy {busy_ms:.3f} ms, idle share "
             f"{1 - busy_ms / wall_ms:.4f}, kernel launches {launches:.1f}",
             "  by kind: device ms, launches"]
    by_kind = {}
    for e in kernels:
        k = by_kind.setdefault(kind_of(e.key), [0.0, 0])
        k[0] += e.self_device_time_total / 1e3 / reps
        k[1] += e.count / reps
    for kind, (t, n) in sorted(by_kind.items(), key=lambda kv: -kv[1][0]):
        lines.append(f"    {kind:<20} {t:10.3f} {n:8.1f}")
    copies = [e for e in kernels if any(c in e.key for c in COPIES)]
    copy_ms = sum(e.self_device_time_total for e in copies) / 1e3 / reps
    lines.append(f"    {'of which copies':<20} {copy_ms:10.3f} "
                 f"{sum(e.count for e in copies) / reps:8.1f}")
    lines.append("  kernels by device time: ms, launches")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:12]:
        lines.append(f"    {e.self_device_time_total / 1e3 / reps:9.4f} "
                     f"{e.count / reps:7.1f}  {e.key[:90]}")
    return lines


def _mesh_steps(model, args, device, params, max_seq):
    """(prefill, decode, sharded params) of the mesh's serving steps,
    taking plain tensors as the unsharded ones do."""
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.steps import make_mesh_serve_steps
    from repro_torch.sharding.params import shard_tree

    shape = tuple(int(x) for x in args.mesh.split(","))
    mesh = make_mesh(shape, devices=None if device.type == "cuda"
                     else [device])
    prefill, decode, pargs = make_mesh_serve_steps(
        model, mesh, batch=args.batch, seq=max_seq, mode=args.mode)
    return (lambda p, batch, _: prefill(p, batch), decode,
            shard_tree(params, pargs.in_specs[0], mesh))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=2048)
    ap.add_argument("--decode-steps", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None)
    ap.add_argument("--arch", default="zamba2-2.7b")
    ap.add_argument("--mesh", default=None,
                    help="D,M: serve on a (data D, model M) mesh")
    ap.add_argument("--mode", default="fsdp", choices=SERVE_MODES)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    model = build_model(cfg)
    params = model.init(args.seed, device=device)
    request = make_request(cfg, args.batch, args.prompt_len, args.seed,
                           device)
    max_seq = cache_len(cfg, args.prompt_len, args.decode_steps + 1)
    prefill_step, decode_step = model.prefill, model.decode_step
    where = ""
    if args.mesh:
        prefill_step, decode_step, params = _mesh_steps(
            model, args, device, params, max_seq)
        where = f", mesh {args.mesh} {args.mode}"

    def prefill():
        return prefill_step(params, request, max_seq)

    logits, cache = prefill()  # warm-up
    tok = logits[:, -1].argmax(-1)[:, None]
    decode_step(params, tok, cache)
    sync(device)
    logits, cache = prefill()
    state = {"tok": logits[:, -1].argmax(-1)[:, None], "cache": cache}

    def decode():
        out, state["cache"] = decode_step(params, state["tok"],
                                          state["cache"])
        state["tok"] = out[:, -1].argmax(-1)[:, None]

    name = (f" ({torch.cuda.get_device_name(device)})"
            if device.type == "cuda" else "")
    print(f"{cfg.name}, {cfg.num_layers} layers, batch {args.batch}, "
          f"prompt {args.prompt_len}{where}, on {device}{name}")
    for line in (profile_phase("prefill", prefill, 1, device)
                 + profile_phase("decode step", decode, args.decode_steps,
                                 device)):
        print(line, flush=True)


if __name__ == "__main__":
    main()

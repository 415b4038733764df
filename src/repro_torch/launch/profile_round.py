"""Where a paper-workload FedBack round spends its time, from torch.profiler.

    python -m repro_torch.launch.profile_round [--form A] [--rounds 3]

Builds the round at full width in one of the forms of
``configs.paper_mnist.FORMS`` (N=100, the 784-200-10 MLP, D=159,010:
FedBack compacted with the fused commit, A, or dense, B; the paper's
baselines C1–C6; SCAFFOLD, C7; FedBack on the tree layout, compacted,
TA, or dense, TB; the client-sharded forms SA, SB, ST and SR, their
shards all on ``--device``) or ``configs.paper_cifar.FORMS`` (N=100, the CIFAR
CNN, D=196,426: FedBack compacted with the fused commit, CF-A, or on
the tree layout, CF-T), on the paper grid's data and the reference's
seeded weights (the module's ``workload()``), runs two warm-up rounds,
then profiles ``--rounds`` rounds and prints, per round:

* the wall time (host clock around rounds that end in a synchronize);
* the device's busy time (sum of kernel durations; the round runs on
  one stream, so kernels do not overlap) and its idle share;
* kernel launches, and for each named range of the round
  (``fedback/*``) its host time, the device time of the kernels it
  launched, and its span on the device timeline;
* the kernels that took the most device time, and the port's own
  kernels (``kernels/ops.py``) wherever they rank.

A ragged form of ``configs.paper_mnist.RAGGED_FORMS`` (RA, RB, RS:
forms A, B and SA on the label-shard split kept whole, 114–123 examples
a client) or ``paper_cifar.RAGGED_FORMS`` (RC: CF-A on the Dirichlet
split kept whole, 33–255 a client) runs on its module's
``pooled_workload()`` with ``ragged=`` its spec.

A serve form of ``configs.paper_mnist.SERVE_FORMS`` (SVA, SVB, SVS:
FedBack with ``max_staleness=2`` over a 24-tick arrival trace) steps
its trace's ticks instead of rounds: two warm-up ticks, then the next
``--rounds`` ticks (by default the trace's other 22), each figure per
tick.

A sweep form of ``configs.paper_mnist.SWEEP_FORMS`` (WA: form A over
seeds 0–3 × K 2.0, 0.5; WB: form B over seeds 0–1 × L̄ 0.1, 0.2) steps
all its runs each round (``launch/sweep.py``), each figure per sweep
round.  A host form of ``configs.paper_mnist.HOST_FORMS`` (HA, HS, HQ,
HR: the client matrices in host memory, ``core/hoststate.py``) also
prints its legs' host ms per round, its bytes per round each way, and
its copies' ms and the share of them that overlapped work on the
compute stream (CUDA events, ``round_fn.stats``); its device busy time
includes the copies.

Runs on CUDA; ``--device cpu`` rehearses the script (host times only).
"""
from __future__ import annotations

import argparse
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from repro_torch.configs import paper_cifar, paper_mnist
from repro_torch.core.schedule import make_trace
from repro_torch.device import resolve_device
from repro_torch.kernels import ops
from repro_torch.launch.sweep import SweepGrid, init_sweep, make_sweep_fn
from repro_torch.models import make_loss_fn
from repro_torch.utils import make_flat_spec
from repro_torch.utils.spans import is_span

# The configuration module of every form.
CONFIGS = {form: m for m in (paper_mnist, paper_cifar) for form in m.FORMS}
CONFIGS.update(dict.fromkeys(paper_mnist.SERVE_FORMS, paper_mnist))
CONFIGS.update({form: m for m in (paper_mnist, paper_cifar)
                for form in m.RAGGED_FORMS})
CONFIGS.update(dict.fromkeys((*paper_mnist.SWEEP_FORMS,
                              *paper_mnist.HOST_FORMS), paper_mnist))
WARMUP = 2


def _form(cfgs, form):
    for table in ("FORMS", "SERVE_FORMS", "RAGGED_FORMS", "SWEEP_FORMS",
                  "HOST_FORMS"):
        if form in getattr(cfgs, table, {}):
            return getattr(cfgs, table)[form]
    raise KeyError(form)


def build(form: str, device):
    """(state, step): ``step(state) -> (state, metrics)`` is one round,
    for a serve form one tick of its trace, the ticks in order, and for
    a sweep form one round of every run."""
    cfgs = CONFIGS[form]
    cfg = cfgs.form_config(form)
    f = _form(cfgs, form)
    extra = {}
    if form in cfgs.RAGGED_FORMS or f.pooled:
        data, _, params0, logits_fn, extra["ragged"] = cfgs.pooled_workload(
            device=device, shards=f.shards)
    else:
        data, _, params0, logits_fn = cfgs.workload(device=device)
    spec = f.spec(make_flat_spec(params0))
    if f.sweep is not None:
        states, overrides, _ = init_sweep(cfg, params0, SweepGrid(**f.sweep),
                                          spec=spec, device=device)
        sweep_fn = make_sweep_fn(cfg, make_loss_fn(logits_fn), data,
                                 rounds=1, spec=spec, device=device)
        return states, lambda s: sweep_fn(s, overrides)
    state = f.init(cfg, params0, spec=spec, **f.placement(device))
    round_fn = f.make_round(cfg, make_loss_fn(logits_fn), data, spec=spec,
                            arrivals_arg=f.trace is not None,
                            **f.placement(device), **extra)
    if f.trace is None:
        return state, round_fn
    rows = torch.from_numpy(make_trace(f.trace)).to(device)
    ticks = iter(range(rows.shape[0]))
    return state, lambda s: round_fn(s, rows[next(ticks)])


def sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def host_legs(stats: dict, before: dict, rounds: int) -> list[str]:
    """A host form's legs per round from its ``round_fn.stats``."""
    per = {k: (v - before[k]) / rounds for k, v in stats.items()}
    copy_ms = per["h2d_ms"] + per["d2h_ms"]
    return [
        "host legs (per round, host ms): plan "
        f"{per['plan_s'] * 1e3:.3f}, rows up {per['h2d_s'] * 1e3:.3f}, "
        f"solve {per['solve_s'] * 1e3:.3f}, rows down "
        f"{per['d2h_s'] * 1e3:.3f}, scatter {per['scatter_s'] * 1e3:.3f}, "
        f"aggregate {per['agg_s'] * 1e3:.3f}",
        f"bytes per round: rows up {per['h2d_row_bytes']:.0f}, rows down "
        f"{per['d2h_row_bytes']:.0f}, server pass up "
        f"{per['h2d_full_bytes']:.0f}, down {per['d2h_full_bytes']:.0f}, "
        f"plan down {per['d2h_plan_bytes']:.0f}",
        f"copies: {copy_ms:.3f} ms per round, overlap share "
        + (f"{per['overlap_ms'] / copy_ms:.4f}" if copy_ms else
           "not measured")]


def profile_rounds(form: str, rounds: int | None, device) -> str:
    state, round_fn = build(form, device)
    stats = getattr(round_fn, "stats", None)
    trace = paper_mnist.SERVE_FORMS[form].trace \
        if form in paper_mnist.SERVE_FORMS else None
    if rounds is None:
        rounds = 3 if trace is None else trace.ticks - WARMUP
    for _ in range(WARMUP):
        state, _ = round_fn(state)
    sync(device)
    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    before = dict(stats or {})
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(rounds):
            state, _ = round_fn(state)
        sync(device)
        wall_ms = (time.perf_counter() - t0) * 1e3 / rounds
    after = dict(stats or {})
    events = prof.key_averages()
    # Device-side events: kernels, plus the device-side copies of the
    # named ranges (their spans on the device timeline, gaps included),
    # which are reported as ranges and not summed as busy time.
    kernels = [e for e in events if e.device_type == DeviceType.CUDA
               and not is_span(e.key)]
    ranges = {}
    for e in events:
        if e.key.startswith("fedback/"):
            side = "device" if e.device_type == DeviceType.CUDA else "host"
            ranges.setdefault(e.key, {})[side] = e
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3 / rounds
    launches = sum(e.count for e in kernels) / rounds
    unit = "round" if trace is None else "tick"
    if form in paper_mnist.SWEEP_FORMS:
        unit = "sweep round"
    lines = [f"form {form} on {device}"
             + (f" ({torch.cuda.get_device_name(device)})"
                if device.type == "cuda" else "")
             + ("" if trace is None else
                f", ticks {WARMUP}..{WARMUP + rounds - 1} of its "
                f"{trace.kind} trace"),
             f"per {unit}: wall {wall_ms:.3f} ms, device busy "
             f"{busy_ms:.3f} ms, idle share {1 - busy_ms / wall_ms:.4f}, "
             f"kernel launches {launches:.1f}",
             f"named ranges (per {unit}): host ms; device ms of the kernels "
             "they launched; their span on the device timeline"]
    if stats is not None:
        lines[2:2] = host_legs(after, before, rounds)

    def ms(e, attr):
        return 0.0 if e is None else getattr(e, attr) / 1e3 / rounds

    for key, r in sorted(ranges.items(),
                         key=lambda kv: -ms(kv[1].get("host"),
                                            "cpu_time_total")):
        host, dev = r.get("host"), r.get("device")
        lines.append(f"  {key:<24} {ms(host, 'cpu_time_total'):9.3f} "
                     f"{ms(host, 'device_time_total'):9.3f} "
                     f"{ms(dev, 'device_time_total'):9.3f}")
    lines.append(f"kernels by device time (per {unit}): ms, launches — the "
                 "15 longest, then the port's own kernels ranked below")
    ranked = sorted(kernels, key=lambda e: -e.self_device_time_total)
    for i, e in enumerate(ranked):
        if i < 15 or any(name in e.key for name in ops.KERNELS):
            lines.append(f"  {e.self_device_time_total / 1e3 / rounds:9.4f} "
                         f"{e.count / rounds:6.1f}  {e.key[:90]}")
    return "\n".join(lines)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--form", choices=tuple(CONFIGS),
                    action="append")
    ap.add_argument("--rounds", type=int, default=None,
                    help="rounds (ticks of a serve form) to profile after "
                         "two warm-ups; default 3, or the rest of a serve "
                         "form's trace")
    ap.add_argument("--device", default=None)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    for form in args.form or ["A", "B"]:
        print(profile_rounds(form, args.rounds, device), flush=True)


if __name__ == "__main__":
    main()

"""One-card dry-run: every (architecture × input shape × mesh) step of
the port counted on the meta device, with its roofline terms on an H100
(the twin of ``repro/launch/dryrun.py``, with its names and CLI).

The reference lowers and compiles each program for TPU meshes of 256
chips (16×16) and 512 (2×16×16) on forced host devices and reads XLA's
cost and memory analysis.  The port runs on one card, so every record
here is for one card (``n_chips`` 1, ``mesh`` "1xH100"): the step
(made by ``launch/steps.py``) is run on its meta-device arguments
(``models.api.abstract_params`` / ``abstract_cache``: shapes and
dtypes, no storage, no card) and counted:

* FLOPs by ``torch.utils.flop_counter.FlopCounterMode`` (matrix
  products, batched products, convolutions; elementwise ops count 0);
* HBM bytes as an eager, unfused run moves them: each op's tensor
  operands read once and its outputs written once; views, allocations
  without a write and metadata move nothing (XLA's "bytes accessed" of a
  program that fuses nothing);
* memory: the step's arguments, its outputs, and the peak of the
  tensors it allocates that are alive at once (``temp``; autograd's
  saved activations among them), followed through the meta tensors'
  lifetimes.

  train_4k     → train_step  (single: one FedBack local prox step and
                              AdamW; multi: the cross-pod round, 2 pods
                              × 2 local steps, both pods on the card)
  prefill_32k  → prefill
  decode_32k   → decode_step (1 token, a 32k KV/SSM cache)
  long_500k    → decode_step (1 token, 524k context; sub-quadratic
                              architectures only)

A serving record of ``--mesh multi`` is its single record again: the
pods are a training construct, and serving has no pod axis on one card.
The meshes and the sharding rules have twins (``launch/mesh.py``,
``sharding/specs.py``), and the serving and training steps run on a
data × model or pod × data × model mesh (``sharding/params.py``,
``sharding/train.py``); the dry-run counts the one-device steps, the
whole global batch on one card.  Counting the reference's records on
``make_production_mesh``'s shapes (``train_4k`` through
``make_train_step(model, mesh, ...)`` and ``make_cross_pod_step(model,
mesh, ...)``) is ROADMAP M22d.  ``sharding/actshard.py`` has no twin:
its hints place XLA's activations, and the port's mesh steps place
theirs explicitly.

Where the count needs care, and what this module does:

* **Python dispatch.**  Eager loops cost Python dispatch per op on meta
  too (``blockwise_attention``'s KV blocks, ``chunked_lm_loss``'s
  chunks, 95 layers).  The reference's own correction, for the cost it
  could not see inside its layer scan, is taken as it is
  (:func:`corrected_cost`): count the step at 1 and 2 layer units
  (:func:`_reduced_layers`; a unit is a hybrid group, or a remat group)
  and extrapolate over :func:`_scan_units`.  Every per-layer count is
  the same in each unit, so the extrapolation equals the full count
  (``tests/test_torch_dryrun.py`` holds it at 4 units); the memory
  figures are extrapolated the same way, an estimate.
* **Kernel calls on meta.**  The kernel wrappers refuse meta tensors
  (``kernels/_checks.py::is_cpu``), and never quietly take their plain
  path.  The count hands the model stand-ins of K4
  (``ops.flash_attention``) and K5 (``ops.ssd_scan``) instead
  (:func:`kernel_stand_ins`): each returns its outputs' shapes and adds
  the kernel's work, K4's FLOPs by ``flash_attention_flops`` (the
  causal mask halves S², where its plain version computes all of S²)
  and each kernel's bytes by its ``*_hbm_bytes``.  The training paths
  call no kernel.
* **Data-dependent steps.**  Whether a pod fires is read back from the
  card in the cross-pod round; on meta nothing can be read, so the
  ``multi`` training record counts every pod firing
  (``make_cross_pod_round(every_pod_fires=True)``), an upper bound,
  and says so: ``"assumed": "every pod fires"``.
* **MoE dispatch** runs on meta as it is: its capacity is static
  (``models/moe.py::capacity``) and nothing in it reads a value back.
* **The audio encoder's prefill_32k.**  ``shape_applicable`` lets it
  through (only decode is refused), and the reference's step then
  raises (its ``prefill`` has no encoder path), so its sweep writes an
  error record there.  Here the record counts the encoder's serving
  pass instead, ``steps.make_encode_step`` (frames to per-frame
  logits), and says so: ``"step": "encode"``.
* **Time.**  The count of one record is a few seconds of Python
  dispatch (zamba2-2.7b's cross-pod round, ~30 s); ``--jobs`` counts
  the records' 1- and 2-unit steps in that many processes (spawned:
  no state of a card is shared), so the whole sweep, ``--arch all
  --shape all --mesh both``, takes well under two minutes on 8 cores.

Compute time is priced at the card's bf16 tensor-core rate for a bf16
configuration and at its fp32 rate otherwise (the port's fp32 products
run in full fp32); memory at its HBM rate.  The card is
``torch.cuda.get_device_name(0)`` or ``--card NAME``; a card the
roofline tables do not name is refused.

Usage::

  python -m repro_torch.launch.dryrun --arch granite-3-2b --shape train_4k
  python -m repro_torch.launch.dryrun --arch all --shape all --mesh both \\
      --card "NVIDIA H100 80GB HBM3" --jobs 8 --out build/dryrun
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import itertools
import json
import os
import time
import traceback
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import ARCHITECTURES, INPUT_SHAPES, get_config, \
    shape_applicable
from repro_torch.kernels import ops
from repro_torch.kernels._checks import _tensors
from repro_torch.launch.roofline import card_peaks, model_flops_per_device, \
    roofline_terms, summarize
from repro_torch.launch.steps import make_cross_pod_step, make_decode_step, \
    make_encode_step, make_prefill_step, make_train_step
from repro_torch.models.api import active_param_count, build_model, \
    param_count

MESH = "1xH100"
N_CHIPS = 1
CARD_HBM_BYTES = 80e9  # the H100's 80 GB
N_PODS = 2  # the reference's multi-pod mesh has 2 pods
EVERY_POD_FIRES = "every pod fires"
# Ops that move no bytes: they allocate without writing, or alias.
_FREE = {"empty", "empty_like", "empty_strided", "new_empty",
         "new_empty_strided", "detach", "alias", "lift_fresh"}
_COUNT_KEYS = ("flops", "bytes", "coll", "args_bytes", "out_bytes",
               "temp_bytes", "flash_attention", "ssd_scan")


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class ByteCounter(TorchDispatchMode):
    """Bytes moved and peak live bytes of the ops run under it: each op
    that is not a view or in :data:`_FREE` reads its tensor operands and
    writes its outputs once; each output that is new storage (not a
    view, not an operand written in place) counts as live until it is
    freed."""

    def __init__(self):
        super().__init__()
        self.bytes = 0
        self.live = 0
        self.peak = 0

    def _free(self, n):
        self.live -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        name = func.overloadpacket.__name__
        if func.is_view or name in _FREE:
            return out
        ins = list(_tensors(args)) + list(_tensors(kwargs))
        outs = list(_tensors(out))
        self.bytes += sum(map(_nbytes, ins)) + sum(map(_nbytes, outs))
        seen = {id(t) for t in ins}
        for t in outs:
            if id(t) in seen:
                continue
            n = _nbytes(t)
            self.live += n
            self.peak = max(self.peak, self.live)
            weakref.finalize(t, self._free, n)
        return out


class _Kernels:
    """The work the K4 and K5 stand-ins add: FLOPs, bytes, calls."""

    def __init__(self):
        self.flops = 0
        self.bytes = 0
        self.calls = {"flash_attention": 0, "ssd_scan": 0}


def _flash_attention_stand_in(work, q, k, v, *, causal=True, window=0,
                              layout="bhsd"):
    if layout == "bshd":
        b, s, h, hd = q.shape
        kvh = k.shape[2]
    else:
        b, h, s, hd = q.shape
        kvh = k.shape[1]
    work.flops += ops.flash_attention_flops(b, h, s, hd, causal=causal,
                                            window=window)
    work.bytes += ops.flash_attention_hbm_bytes(b, h, kvh, s, hd,
                                                q.element_size())
    work.calls["flash_attention"] += 1
    return torch.empty_like(q)


def _ssd_scan_stand_in(work, states, decays):
    b, c, h, p, n = states.shape
    work.flops += 2 * b * c * h * p * n  # a multiply and an add a step
    work.bytes += ops.ssd_scan_hbm_bytes(b, c, h, p, n,
                                         states.element_size())
    work.calls["ssd_scan"] += 1
    return (torch.empty_like(states),
            torch.empty((b, h, p, n), dtype=torch.float32,
                        device=states.device))


@contextlib.contextmanager
def kernel_stand_ins(work: _Kernels):
    """Within: ``ops.flash_attention`` and ``ops.ssd_scan`` (which the
    attention and SSM layers look up when they run) are meta-device
    stand-ins that add K4's and K5's work to ``work``."""
    saved = ops.flash_attention, ops.ssd_scan
    ops.flash_attention = lambda *a, **kw: _flash_attention_stand_in(
        work, *a, **kw)
    ops.ssd_scan = lambda *a, **kw: _ssd_scan_stand_in(work, *a, **kw)
    try:
        yield
    finally:
        ops.flash_attention, ops.ssd_scan = saved


def analytic_hbm_bytes(cfg, *, step_mode, batch, seq, n_chips,
                       multi_pod, local_steps):
    """First-principles per-device HBM estimate (the reference's, line
    for line; here ``n_chips`` is 1)."""
    p = param_count(cfg)
    bp = 2 if cfg.dtype == "bfloat16" else 4
    d_eff = cfg.d_model
    if step_mode == "train":
        # params + grads + prox center (bp each) + adam m,v (fp32)
        state = p * (3 * bp + 8)
        if multi_pod:
            state += p * 3 * bp  # θ, λ, z_prev per pod
        stash = cfg.num_layers / max(cfg.remat_group, 1) * \
            (batch / n_chips * 16) * seq * d_eff * bp
        transient = 6 * (batch / n_chips * 16) * seq * max(
            cfg.d_ff or 2 * cfg.d_model, cfg.num_heads * cfg.head_dim or 0,
            2 * d_eff) * bp
        return state / n_chips + stash + transient
    if step_mode == "prefill":
        acts = 8 * (batch * 16 / n_chips) * seq * d_eff * bp
        cache = (cfg.num_layers * batch * seq * max(
            cfg.num_kv_heads * cfg.head_dim, 1) * 2 * bp / n_chips
            if cfg.family in ("dense", "moe", "vlm") else
            cfg.num_layers * batch * 2 * cfg.expand * d_eff *
            cfg.ssm_state * 4 / n_chips)
        return p * bp / n_chips + acts + cache
    # decode
    kv_len = min(seq, cfg.sliding_window) if cfg.sliding_window else seq
    cache = (cfg.num_layers * batch * kv_len *
             max(cfg.num_kv_heads * cfg.head_dim, 1) * 2 * bp
             if cfg.family in ("dense", "moe", "vlm") else
             cfg.num_layers * batch * cfg.expand * d_eff *
             cfg.ssm_state * 4)
    if cfg.family == "hybrid":
        ng = cfg.num_layers // cfg.attn_every
        cache += ng * batch * min(seq, cfg.sliding_window or seq) * \
            cfg.num_kv_heads * cfg.head_dim * 2 * bp
    return p * bp / n_chips + cache / min(n_chips, max(batch, 1)) + 2 ** 28


def build_step(cfg, shape: str, *, multi_pod: bool, local_steps: int = 2):
    """((cfg, model, (fn, args), step_mode, seq, batch), "") for a shape
    that applies, else (None, the reference's skip reason)."""
    ok, reason = shape_applicable(cfg, shape)
    if not ok:
        return None, reason
    step_mode, seq, batch = INPUT_SHAPES[shape]
    model = build_model(cfg)
    if step_mode == "train":
        if multi_pod:
            built = make_cross_pod_step(model, batch=batch, seq=seq,
                                        n_pods=N_PODS,
                                        local_steps=local_steps,
                                        every_pod_fires=True)
        else:
            built = make_train_step(model, batch=batch, seq=seq)
    elif step_mode == "prefill" and cfg.family == "audio":
        built = make_encode_step(model, batch=batch, seq=seq)
    elif step_mode == "prefill":
        built = make_prefill_step(model, batch=batch, seq=seq)
    else:
        built = make_decode_step(model, batch=batch, seq=seq)
    return (cfg, model, built, step_mode, seq, batch), ""


def _reduced_layers(cfg, n_units: int):
    """Config with n_units layer units (hybrid: units are groups)."""
    if cfg.family == "hybrid":
        return dataclasses.replace(cfg, num_layers=n_units * cfg.attn_every)
    g = max(cfg.remat_group, 1)
    if cfg.num_layers % g == 0 and g > 1:
        return dataclasses.replace(cfg, num_layers=n_units * g)
    return dataclasses.replace(cfg, num_layers=n_units)


def _scan_units(cfg) -> int:
    if cfg.family == "hybrid":
        return cfg.num_layers // cfg.attn_every
    g = max(cfg.remat_group, 1)
    return cfg.num_layers // g if cfg.num_layers % g == 0 else cfg.num_layers


def count_cost(cfg, shape, *, multi_pod, local_steps=2) -> dict:
    """Run one step on the meta device and count it (no correction):
    FLOPs, bytes and collective bytes (0 on one card), the arguments',
    outputs' and peak temporaries' bytes, and the K4 / K5 calls."""
    built, _ = build_step(cfg, shape, multi_pod=multi_pod,
                          local_steps=local_steps)
    _, _, (fn, args), *_ = built
    work = _Kernels()
    flop_mode = FlopCounterMode(display=False)
    bytes_mode = ByteCounter()
    with kernel_stand_ins(work), flop_mode, bytes_mode:
        out = fn(*args)
    return {
        "flops": float(flop_mode.get_total_flops() + work.flops),
        "bytes": float(bytes_mode.bytes + work.bytes),
        "coll": 0.0,
        "args_bytes": float(sum(map(_nbytes, _tensors(args)))),
        "out_bytes": float(sum(map(_nbytes, _tensors(out)))),
        "temp_bytes": float(bytes_mode.peak),
        **{k: float(v) for k, v in work.calls.items()},
    }


def _extrapolate(cfg, c1: dict, c2: dict) -> dict:
    """cost(L) = cost(1 unit) + (units − 1) · (cost(2) − cost(1))."""
    units = _scan_units(cfg)
    return {k: c1[k] + (units - 1) * max(c2[k] - c1[k], 0.0)
            for k in _COUNT_KEYS}


def corrected_cost(cfg, shape, *, multi_pod, local_steps=2) -> dict:
    """The reference's correction: count the 1-unit and 2-unit variants
    of the step and extrapolate over the units, here so that Python's
    dispatch of an eager step runs over two units and not every
    layer."""
    return _extrapolate(cfg, *(
        count_cost(_reduced_layers(cfg, n), shape, multi_pod=multi_pod,
                   local_steps=local_steps) for n in (1, 2)))


def _base(arch, shape, multi_pod, card) -> dict:
    return {"arch": arch, "shape": shape, "mesh": MESH,
            "pods": N_PODS if multi_pod else 1, "card": card}


def _check_card(card: str) -> dict:
    peaks = card_peaks(card)
    if peaks["hbm_bytes_per_s"] is None:
        raise ValueError(f"the roofline tables do not name the card "
                         f"{card!r}")
    return peaks


def make_record(arch, shape, cfg, cost, *, multi_pod, card, local_steps=2,
                count_s=0.0) -> dict:
    """The record of one applicable (arch × shape × mesh) step from its
    counted ``cost`` (the reference's keys where they apply)."""
    peaks = _check_card(card)
    step_mode, seq, batch = INPUT_SHAPES[shape]
    peak_flops = (peaks["bf16_flops"] if cfg.dtype == "bfloat16"
                  else peaks["fp32_flops"])
    terms = roofline_terms(cost["flops"], cost["bytes"], cost["coll"],
                           peak_flops=peak_flops,
                           hbm_bw=peaks["hbm_bytes_per_s"])
    # The global batch spans the cross-pod local steps (batch = pods ×
    # local_steps × per-step), as in the reference.
    mf = model_flops_per_device(
        cfg, mode=step_mode, batch=batch, seq=seq, n_chips=N_CHIPS,
        active_params=active_param_count(cfg))
    mem = {"argument_size_in_bytes": int(cost["args_bytes"]),
           "output_size_in_bytes": int(cost["out_bytes"]),
           "temp_size_in_bytes": int(cost["temp_bytes"])}
    per_dev_bytes = sum(mem.values())
    analytic = analytic_hbm_bytes(cfg, step_mode=step_mode, batch=batch,
                                  seq=seq, n_chips=N_CHIPS,
                                  multi_pod=multi_pod,
                                  local_steps=local_steps)
    record = {
        **_base(arch, shape, multi_pod, card),
        "status": "ok",
        "step": ("encode" if step_mode == "prefill"
                 and cfg.family == "audio" else step_mode),
        "seq": seq,
        "batch": batch,
        "n_chips": N_CHIPS,
        "count_s": round(count_s, 2),
        "memory_analysis": mem,
        "bytes_per_device": per_dev_bytes,
        "analytic_hbm_bytes": int(analytic),
        "fits_hbm_80GB": bool(analytic < CARD_HBM_BYTES),
        "meta_measured_fits": bool(per_dev_bytes < CARD_HBM_BYTES),
        "model_flops_per_device": mf,
        "useful_flops_ratio": (mf / terms["hlo_flops_per_device"]
                               if terms["hlo_flops_per_device"] else None),
        "kernel_calls": {"flash_attention": int(cost["flash_attention"]),
                         "ssd_scan": int(cost["ssd_scan"])},
        "roofline": terms,
    }
    if multi_pod and step_mode == "train":
        record["assumed"] = EVERY_POD_FIRES
    return record


def dry_run(arch: str, shape: str, *, multi_pod: bool = False,
            local_steps: int = 2, cost_correction: bool = True, cfg=None,
            card: str) -> dict:
    """Count one (arch × shape × mesh) step on the meta device; return
    its record (a skip record where the shape does not apply)."""
    t0 = time.time()
    cfg = cfg or get_config(arch)
    _check_card(card)
    ok, reason = shape_applicable(cfg, shape)
    if not ok:
        return {**_base(arch, shape, multi_pod, card), "status": "skipped",
                "reason": reason}
    cost = (corrected_cost if cost_correction else count_cost)(
        cfg, shape, multi_pod=multi_pod, local_steps=local_steps)
    return make_record(arch, shape, cfg, cost, multi_pod=multi_pod,
                       card=card, local_steps=local_steps,
                       count_s=time.time() - t0)


def _count_task(task):
    """One 1- or 2-unit count of a sweep, in a worker: (cost or None,
    seconds, the traceback or None)."""
    cfg, shape, multi_pod, local_steps = task
    t0 = time.time()
    try:
        cost = count_cost(cfg, shape, multi_pod=multi_pod,
                          local_steps=local_steps)
        return cost, time.time() - t0, None
    except Exception:
        return None, time.time() - t0, traceback.format_exc()[-2000:]


def sweep(combos, *, card: str, local_steps: int = 2, jobs: int = 1,
          overrides=lambda cfg: cfg):
    """Yield the record of each (arch, shape, multi_pod) in ``combos``,
    in order; their 1- and 2-unit counts run in ``jobs`` spawned
    processes (``jobs`` 1: here).  A serving step of ``multi_pod`` is the
    single one, counted once.  A count that raises gives an error
    record."""
    _check_card(card)
    plans, tasks = [], {}
    for arch, shape, mp in combos:
        cfg = overrides(get_config(arch))
        ok, reason = shape_applicable(cfg, shape)
        key = (arch, shape, mp and INPUT_SHAPES[shape][0] == "train")
        plans.append((arch, shape, mp, cfg, ok, reason, key))
        if ok:
            for n in (1, 2):
                tasks.setdefault((key, n), (_reduced_layers(cfg, n), shape,
                                            key[2], local_steps))
    keys = list(tasks)
    if jobs > 1 and len(keys) > 1:
        import multiprocessing

        # The longest counts first, so that no worker is left with one.
        def weight(i):  # cross-pod rounds, then train steps, 2 units
            (_, shape, mp_train), n = keys[i]
            return (-2 * mp_train - (INPUT_SHAPES[shape][0] == "train"), -n)

        order = sorted(range(len(keys)), key=weight)
        with multiprocessing.get_context("spawn").Pool(jobs) as pool:
            done = pool.map(_count_task, [tasks[keys[i]] for i in order],
                            chunksize=1)
        results = {keys[i]: r for i, r in zip(order, done, strict=True)}
    else:
        results = {k: _count_task(tasks[k]) for k in keys}
    for arch, shape, mp, cfg, ok, reason, key in plans:
        if not ok:
            yield {**_base(arch, shape, mp, card), "status": "skipped",
                   "reason": reason}
            continue
        (c1, s1, e1), (c2, s2, e2) = results[(key, 1)], results[(key, 2)]
        if e1 or e2:
            yield {**_base(arch, shape, mp, card), "status": "error",
                   "error": e1 or e2}
            continue
        try:
            yield make_record(arch, shape, cfg, _extrapolate(cfg, c1, c2),
                              multi_pod=mp, card=card,
                              local_steps=local_steps, count_s=s1 + s2)
        except Exception:
            yield {**_base(arch, shape, mp, card), "status": "error",
                   "error": traceback.format_exc()[-2000:]}


def _card_name(card):
    if card:
        return card
    if torch.cuda.is_available():
        return torch.cuda.get_device_name(0)
    raise SystemExit("dryrun: no CUDA device is visible; name the card "
                     "the records are for with --card NAME")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="all",
                    help="architecture id or 'all'")
    ap.add_argument("--shape", default="all",
                    help=f"one of {list(INPUT_SHAPES)} or 'all'")
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--local-steps", type=int, default=2)
    ap.add_argument("--jobs", type=int, default=min(8, os.cpu_count() or 1),
                    help="processes that count (default: the cores, at "
                         "most 8)")
    ap.add_argument("--card", default=None,
                    help="the card's name (torch.cuda.get_device_name); "
                         "default: the visible card's")
    ap.add_argument("--out", default=None,
                    help="directory for per-combo JSON records")
    ap.add_argument("--skip-existing", action="store_true",
                    help="skip combos whose JSON already exists in --out")
    ap.add_argument("--set", action="append", default=[],
                    help="ModelConfig overrides key=value (repeatable); "
                         "e.g. --set num_layers=2 --set d_model=512")
    ap.add_argument("--tag", default="",
                    help="suffix for output filenames (perf variants)")
    args = ap.parse_args(argv)
    card = _card_name(args.card)

    def apply_overrides(cfg):
        for kv in args.set:
            k, v = kv.split("=", 1)
            cur = getattr(cfg, k)
            if isinstance(cur, bool):
                v = v.lower() in ("1", "true", "yes")
            elif isinstance(cur, int):
                v = int(v)
            elif isinstance(cur, float):
                v = float(v)
            cfg = dataclasses.replace(cfg, **{k: v})
        return cfg

    archs = list(ARCHITECTURES) if args.arch == "all" else [args.arch]
    shapes = list(INPUT_SHAPES) if args.shape == "all" else [args.shape]
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]

    def fname(arch, shape, mp):
        return (f"{arch}__{shape}__{'multi' if mp else 'single'}"
                f"{('__' + args.tag) if args.tag else ''}.json")

    combos = []
    for arch, shape, mp in itertools.product(archs, shapes, meshes):
        if (args.skip_existing and args.out and os.path.exists(
                os.path.join(args.out, fname(arch, shape, mp)))):
            print(f"{arch}|{shape}|{'multi' if mp else 'single'}: exists, "
                  "skipping", flush=True)
            continue
        combos.append((arch, shape, mp))
    failures = 0
    for rec in sweep(combos, card=card, local_steps=args.local_steps,
                     jobs=args.jobs, overrides=apply_overrides):
        mp = rec["pods"] > 1
        tag = f"{rec['arch']}|{rec['shape']}|{'multi' if mp else 'single'}"
        if rec["status"] == "ok":
            if args.set:
                rec["overrides"] = list(args.set)
            print(summarize(rec), flush=True)
            mem = rec["memory_analysis"]
            print(f"    memory/device: args="
                  f"{mem['argument_size_in_bytes'] / 1e9:.2f}GB "
                  f"temp={mem['temp_size_in_bytes'] / 1e9:.2f}GB "
                  f"analytic={rec['analytic_hbm_bytes'] / 1e9:.2f}GB "
                  f"fits80GB={rec['fits_hbm_80GB']} "
                  f"count={rec['count_s']:.1f}s"
                  + (f" ({rec['assumed']})" if "assumed" in rec else ""),
                  flush=True)
        else:
            failures += rec["status"] == "error"
            print(f"{tag}: {rec['status']}: "
                  f"{rec.get('reason', rec.get('error', ''))[:300]}",
                  flush=True)
        if args.out:
            os.makedirs(args.out, exist_ok=True)
            with open(os.path.join(args.out, fname(rec["arch"],
                                                   rec["shape"], mp)),
                      "w") as f:
                json.dump(rec, f, indent=1)
    raise SystemExit(1 if failures else 0)


if __name__ == "__main__":
    main()

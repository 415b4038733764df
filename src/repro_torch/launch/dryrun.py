"""Dry-run: every (architecture × input shape × mesh) step of the port
counted on the meta device, with its roofline terms on an H100 (the twin
of ``repro/launch/dryrun.py``, with its names, records and CLI).

The reference lowers and compiles each program for its production
meshes on forced host devices and reads XLA's cost and memory analysis
per device.  Here each step is run on meta-device arguments (shapes and
dtypes, no storage, no card) and counted.

**The reference's meshes** (``--mesh single|multi|both``, the default).
``build_step`` builds every step as the reference's does
(``src/repro/launch/dryrun.py:107-129``) on
``launch.mesh.make_production_mesh``'s shapes — (16, 16) over ("data",
"model"), or (2, 16, 16) over ("pod", "data", "model") — in ``--sharding``
fsdp, tp or fsdp_tp (``dry_run`` takes ep too), the batch over
``batch_axes`` ("data", or ("pod", "data") on the multi-pod mesh, for
serving too):

  train_4k     → make_train_step(model, mesh, mode=, batch_axes=)
                 (multi: make_cross_pod_step(model, mesh, mode=,
                 local_steps=), 2 pods × 2 local steps)
  prefill_32k  → make_prefill_step(model, mesh, mode=, batch_axes=)
  decode_32k   → make_decode_step (1 token against a 32k KV/SSM cache)
  long_500k    → make_decode_step (524k context; sub-quadratic only)

The arguments are cut by the steps' ``MeshArgs.in_specs`` with
``sharding.params.shard_tree`` (a tp decode's cache in the layout the tp
executor keeps, ``sharding.serve.tp_cache_specs``: ROADMAP D14), and
the step runs over every coordinate of the mesh.  A record is one
card's, as the reference's is one chip's (``n_chips`` 256 or 512,
``mesh`` "16x16" or "2x16x16", ``sharding_mode``):

* ``argument_size_in_bytes`` / ``output_size_in_bytes``:
  ``sharding.params.per_device_bytes`` of the step's ``in_specs`` /
  ``out_specs``, exact from shapes (an output the specs leave to the
  step, as the reference leaves it to XLA — logits, a loss, a round's
  metrics — counted whole: the first coordinate holds it).  The port's
  token and label ids and the cross-pod key are int64 and a cache's
  ``pos`` is a host int, where the reference has int32, uint32 and an
  int32 (ROADMAP D17): the bytes are the port's.
* FLOPs, HBM bytes, ``temp_size_in_bytes`` and the K4 / K5 calls are
  the **busiest coordinate's**, the one of the longest roofline term.
  Each coordinate's device is a :class:`Coord` (the string "meta" with
  the coordinate's index), so every placement names its coordinate:
  a factory counts to the coordinate its ``device=`` names, a copy
  reads on its source and writes on its destination (a copy between
  coordinates is made where a card would make one, and none within
  one), any other op to the coordinate of its first operand that has
  one — ops outside any coordinate (a factory on a tensor's own
  ``.device``) to the coordinate of the op before them, and to the
  mesh's first one before any.  Under fsdp a data shard's loss runs on
  its first coordinate, so that coordinate carries the shard's whole
  forward and backward; under tp, fsdp_tp and ep the work is spread
  over the model shards.
* ``collective_bytes_per_device`` is the mesh's logical bytes by kind —
  what ``sharding.clients.collectives`` reports for every copy between
  coordinates — over the number of coordinates: for an all-gather of a
  tensor of ``size`` over n shards (n − 1)/n · size a device, for an
  all-reduce 2(n − 1)/n · size (the reference's per-device convention,
  ``src/repro/utils/hlo.py:130-159``); ``roofline.collectives`` keeps
  them by kind.  They are priced at ``launch/roofline.py::LINK_BW``, one
  rate for every axis, as the reference prices one ICI rate: a 16 × 16
  mesh of H100s spans 32 nodes of 8 cards, whose links between nodes
  the model does not price.
* ``analytic_hbm_bytes`` and ``model_flops_per_device`` take
  ``n_chips`` 256 or 512 (the reference's formulas, line for line);
  ``fits_hbm_80GB`` and ``meta_measured_fits`` are per card.

Two combinations are skip records with their reason, not errors:
``long_500k``, whose batch of 1 does not split over the data axis of 16
or pod × data of 32 (the reference's jit raises there), and
hubert-xlarge's ``prefill_32k`` (the reference's prefill has no audio
path, ROADMAP D13, and the port has no mesh encode step).  A step that
raises is an error record, and the CLI exits 1.

**One card** (``--mesh card``): the port's own records, as they were
before the meshes, since the port runs on one card: each step without a mesh,
the whole global batch on one card (``n_chips`` 1, ``mesh`` "1xH100";
``pods`` 1, and 2 for the cross-pod round with both pods on the card,
its serving records those of one pod), counted whole by
``FlopCounterMode`` and :class:`ByteCounter`; the audio encoder's
``prefill_32k`` counts its serving pass, ``steps.make_encode_step``
(``"step": "encode"``).

Where the count needs care, and what this module does:

* **FLOPs** are ``torch.utils.flop_counter``'s formulas (matrix
  products, batched products, convolutions; elementwise ops count 0);
  **HBM bytes** as an eager, unfused run moves them: each op's tensor
  operands read once and its outputs written once; views, allocations
  without a write and metadata move nothing; **memory** the peak of the
  tensors the step allocates that are alive at once (``temp``;
  autograd's saved activations among them).
* **Python dispatch.**  Eager loops cost Python dispatch per op on meta
  too, and a mesh step runs each op once per coordinate.  The
  reference's own correction, for the cost it could not see inside its
  layer scan, is taken as it is (:func:`corrected_cost`): count the step
  at 1 and 2 layer units (:func:`_reduced_layers`; a unit is a hybrid
  group, or a remat group) and extrapolate over :func:`_scan_units`.
  Every per-layer count is the same in each unit, so the extrapolation
  equals the full count (``tests/test_torch_dryrun.py``); the memory
  figures are extrapolated the same way, an estimate.  And every data
  shard of a step runs the same code on blocks of one shape: a mesh
  count passes the step its loop over data shards (``shards=``,
  :class:`DataShardSample`), which runs the first two of each of the
  executors' loops (one pod of an all-firing cross-pod round) and
  gives each later data shard the second's work — its FLOPs, bytes, kernel calls
  and collective bytes — on its own coordinates, standing in for its
  outputs; whatever crosses data shards (the logits' gather, the label
  counts, the MoE's statistics, the gradients' all-reduce over data,
  fsdp's gathers over data) runs in full
  (``tests/test_torch_dryrun_mesh.py`` holds the sample equal to the
  full count).
* **Kernel calls on meta.**  The kernel wrappers refuse meta tensors
  (``kernels/_checks.py::is_cpu``), and never quietly take their plain
  path.  The count hands the model stand-ins of K4
  (``ops.flash_attention``) and K5 (``ops.ssd_scan``) instead
  (:func:`kernel_stand_ins`): each returns its outputs' shapes and adds
  the kernel's work, K4's FLOPs by ``flash_attention_flops`` (the
  causal mask halves S², where its plain version computes all of S²)
  and each kernel's bytes by its ``*_hbm_bytes``, to the coordinate of
  its operands.  The training paths call no kernel.
* **Data-dependent steps.**  Whether a pod fires is read back from the
  card in the cross-pod round; on meta nothing can be read, so the
  ``multi`` training record counts every pod firing
  (``every_pod_fires=True``), an upper bound, and says so: ``"assumed":
  "every pod fires"``.  MoE dispatch runs on meta as it is: its
  capacity is static (``models/moe.py::capacity``).
* **Time.**  ``--jobs`` counts the records' 1- and 2-unit steps in that
  many processes (spawned: no state of a card is shared); PERF.md §6
  gives each mode's sweep time on 8 cores.

Compute time is priced at the card's bf16 tensor-core rate for a bf16
configuration and at its fp32 rate otherwise (the port's fp32 products
run in full fp32); memory at its HBM rate.  The card is
``torch.cuda.get_device_name(0)`` or ``--card NAME``; a card the
roofline tables do not name is refused.

Usage::

  python -m repro_torch.launch.dryrun --arch granite-3-2b --shape train_4k
  python -m repro_torch.launch.dryrun --arch all --shape all --mesh both \\
      --sharding tp --card "NVIDIA H100 80GB HBM3" --jobs 8 --out build/dryrun
  python -m repro_torch.launch.dryrun --mesh card --card "NVIDIA H100 80GB HBM3"
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
from torch.overrides import TorchFunctionMode
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode, flop_registry

from repro_torch.configs import ARCHITECTURES, INPUT_SHAPES, get_config, \
    shape_applicable
from repro_torch.kernels import ops
from repro_torch.kernels._checks import _tensors
from repro_torch.launch.mesh import DeviceMesh, make_production_mesh
from repro_torch.launch.roofline import card_peaks, model_flops_per_device, \
    roofline_terms, summarize
from repro_torch.launch.steps import make_cross_pod_step, make_decode_step, \
    make_encode_step, make_prefill_step, make_train_step
from repro_torch.models.api import META, abstract_cache, \
    active_param_count, build_model, param_count
from repro_torch.sharding.clients import collectives
from repro_torch.sharding.params import per_device_bytes, shard_tree
from repro_torch.sharding.serve import EVERY_DATA_SHARD, EveryDataShard, \
    TpLayout, tp_cache_specs
from repro_torch.utils.pytree import tree_leaves

CARD_MESH = "1xH100"
MESH_NAMES = {False: "16x16", True: "2x16x16"}
SHARDING_MODES = ("fsdp", "tp", "fsdp_tp")  # the reference's CLI's
CARD_HBM_BYTES = 80e9  # the H100's 80 GB
N_PODS = 2  # the reference's multi-pod mesh has 2 pods
EVERY_POD_FIRES = "every pod fires"
# Ops that move no bytes: they allocate without writing, or alias.
_FREE = {"empty", "empty_like", "empty_strided", "new_empty",
         "new_empty_strided", "detach", "alias", "lift_fresh"}
_COUNT_KEYS = ("flops", "bytes", "coll", "args_bytes", "out_bytes",
               "temp_bytes", "flash_attention", "ssd_scan")
_KERNELS = ("flash_attention", "ssd_scan")


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
    """The work the K4 and K5 stand-ins add on one card: FLOPs, bytes,
    calls."""

    def __init__(self):
        self.flops = 0
        self.bytes = 0
        self.calls = {k: 0 for k in _KERNELS}

    def add(self, operand, name, flops, nbytes):
        self.flops += flops
        self.bytes += nbytes
        self.calls[name] += 1


def _flash_attention_stand_in(work, q, k, v, *, causal=True, window=0,
                              layout="bhsd"):
    if layout == "bshd":
        b, s, h, hd = q.shape
        kvh = k.shape[2]
    else:
        b, h, s, hd = q.shape
        kvh = k.shape[1]
    work.add(q, "flash_attention",
             ops.flash_attention_flops(b, h, s, hd, causal=causal,
                                       window=window),
             ops.flash_attention_hbm_bytes(b, h, kvh, s, hd,
                                           q.element_size()))
    return torch.empty_like(q)


def _ssd_scan_stand_in(work, states, decays):
    b, c, h, p, n = states.shape
    work.add(states, "ssd_scan",
             2 * b * c * h * p * n,  # a multiply and an add a step
             ops.ssd_scan_hbm_bytes(b, c, h, p, n, states.element_size()))
    return (torch.empty_like(states),
            torch.empty((b, h, p, n), dtype=torch.float32,
                        device=states.device))


@contextlib.contextmanager
def kernel_stand_ins(work):
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


# ----------------------------------------------------------------------
# counting on a mesh
# ----------------------------------------------------------------------


class Coord(str):
    """The device of one coordinate of a counting mesh: the string
    "meta", so that torch places its tensors on the meta device, that
    carries the coordinate's row-major ``index`` (a meta tensor keeps no
    device index)."""

    def __new__(cls, index: int):
        self = super().__new__(cls, "meta")
        self.index = index
        return self

    def __eq__(self, other):
        return isinstance(other, Coord) and other.index == self.index

    def __ne__(self, other):
        return not self == other

    def __hash__(self):
        return hash(("meta", self.index))

    def __repr__(self):
        return f"Coord({self.index})"


def counting_mesh(mesh) -> DeviceMesh:
    """``mesh``'s axes and sizes, each coordinate on its :class:`Coord`."""
    return DeviceMesh(mesh.axis_names, mesh.sizes,
                      tuple(Coord(i) for i in range(mesh.size)))


def _coord(t):
    return getattr(t, "_coord", None)


def tag_tree(sharded) -> None:
    """Name each block leaf of a ShardedTree by its coordinate."""
    for i, block in enumerate(sharded.blocks):
        for x in tree_leaves(block):
            if isinstance(x, torch.Tensor):
                x._coord = i


class _Placement(TorchFunctionMode):
    """Reads the :class:`Coord` a factory's ``device=`` or a ``.to``
    names (the dispatch below sees only "meta"): the ops it dispatches
    count to that coordinate, and a ``.to`` onto another coordinate
    than its tensor's copies, as it would between cards."""

    def __init__(self, counter):
        super().__init__()
        self.counter = counter

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        dest = kwargs.get("device")
        move = func is _TO
        if isinstance(dest, Coord):
            kwargs = dict(kwargs, device=META)
        elif move:
            dest = next((a for a in args[1:] if isinstance(a, Coord)), None)
            args = tuple(META if a is dest else a for a in args)
        elif func is torch.Tensor.backward and len(args) == 1 \
                and not any(kwargs.values()):
            # the pass runs inside this handler, where the mode is off:
            # run it with the mode on, so that its copies are seen too
            with self:
                torch.autograd.Variable._execution_engine.run_backward(
                    args, (torch.ones_like(args[0]),), False, False, (),
                    True, True)
            return None
        else:
            return func(*args, **kwargs)
        if dest is None:
            return func(*args, **kwargs)
        if move and _coord(args[0]) != dest.index:
            kwargs = dict(kwargs, copy=True)
        counter = self.counter
        saved, counter.dest = counter.dest, dest.index
        try:
            return func(*args, **kwargs)
        finally:
            counter.dest = saved


_TO = torch.Tensor.to
_aten = torch.ops.aten
# Elementwise ops whose meta kernels (Python, ~0.2–1 ms an op) the count
# replaces by an empty tensor of their output's shape and dtype, by the
# rule of each set: the operands' promoted dtype; true division's, a
# floating one; a comparison's bool; a float function's, floating.
_PROMOTE = {_aten.add.Tensor, _aten.sub.Tensor, _aten.mul.Tensor,
            _aten.add.Scalar, _aten.sub.Scalar, _aten.mul.Scalar,
            _aten.rsub.Scalar, _aten.rsub.Tensor, _aten.maximum.default,
            _aten.minimum.default, _aten.bitwise_and.Tensor,
            _aten.bitwise_or.Tensor, _aten.pow.Tensor_Scalar,
            _aten.pow.Tensor_Tensor, _aten.where.self, _aten.neg.default,
            _aten.abs.default, _aten.clamp.default, _aten.clamp_min.default,
            _aten.clamp_max.default, _aten.remainder.Tensor,
            _aten.remainder.Scalar, _aten.logaddexp.default}
_DIVIDE = {_aten.div.Tensor, _aten.div.Scalar}
_COMPARE = {getattr(getattr(_aten, op), o)
            for op in ("eq", "ne", "lt", "le", "gt", "ge")
            for o in ("Tensor", "Scalar")} | {
    _aten.logical_and.default, _aten.logical_or.default,
    _aten.logical_not.default}
_FLOATING = {_aten.exp.default, _aten.log.default, _aten.sqrt.default,
             _aten.rsqrt.default, _aten.sigmoid.default, _aten.tanh.default,
             _aten.sin.default, _aten.cos.default, _aten.reciprocal.default,
             _aten.erf.default, _aten.log1p.default, _aten.expm1.default}
_ELEMENTWISE = _PROMOTE | _DIVIDE | _COMPARE | _FLOATING


def _reduced(x, dims, keepdim):
    """x's shape reduced over ``dims`` (all of them where empty)."""
    dims = range(x.dim()) if not dims else [d % x.dim() for d in dims]
    return [1 if d in dims else n for d, n in enumerate(x.shape)
            if keepdim or d not in dims]


def _like_first(args, kwargs):
    x = args[0]
    return x.shape, kwargs.get("dtype") or x.dtype


def _cumsum(args, kwargs):
    x = args[0]
    dtype = kwargs.get("dtype") or (
        x.dtype if x.dtype.is_floating_point else torch.int64)
    return x.shape, dtype


def _sum(args, kwargs):
    x = args[0]
    dtype = kwargs.get("dtype") or (
        x.dtype if x.dtype.is_floating_point else torch.int64)
    keep = kwargs.get("keepdim", args[2] if len(args) > 2 else False)
    return _reduced(x, args[1] if len(args) > 1 else None, keep), dtype


def _amax(args, kwargs):
    keep = kwargs.get("keepdim", args[2] if len(args) > 2 else False)
    return _reduced(args[0], args[1] if len(args) > 1 else None,
                    keep), args[0].dtype


def _matmul(args, kwargs):
    a, b = args[0], args[1]
    return (*a.shape[:-1], b.shape[-1]), a.dtype


# Other ops whose meta kernels the count replaces: (shape, dtype) of
# their output from their arguments.
_SHAPED = {
    _aten.clone.default: _like_first,
    _aten.zeros_like.default: _like_first,
    _aten.tril.default: _like_first,
    _aten.triu.default: _like_first,
    _aten.masked_fill.Scalar: _like_first,
    _aten.cumsum.default: _cumsum,
    _aten.sum.dim_IntList: _sum,
    _aten.amax.default: _amax,
    _aten.mm.default: _matmul,
    _aten.bmm.default: _matmul,
    _aten.select_backward.default: lambda a, k: (a[1], a[0].dtype),
    _aten.slice_backward.default: lambda a, k: (a[1], a[0].dtype),
}
_KWARGS = {"dtype", "memory_format", "layout", "device", "pin_memory",
           "keepdim"}


def _elementwise_out(func, args, kwargs):
    """The output of an elementwise op of :data:`_ELEMENTWISE` on meta
    operands (None where the op takes options this does not read)."""
    if kwargs and set(kwargs) - {"alpha"}:
        return None
    operands = [a for a in args if a is not None]
    if func is _aten.where.self:
        operands = operands[1:]
    if func in _COMPARE:
        dtype = torch.bool
    else:
        dtype = operands[0].dtype
        for other in operands[1:]:
            dtype = torch.promote_types(
                dtype, torch.result_type(operands[0], other))
        if func in _FLOATING or func in _DIVIDE:
            if not (dtype.is_floating_point or dtype.is_complex):
                dtype = torch.get_default_dtype()
    shape = []  # the operands' shapes broadcast (they are valid ones)
    for a in args:
        if isinstance(a, torch.Tensor):
            dims = a.shape
            shape[:0] = [1] * (len(dims) - len(shape))
            off = len(shape) - len(dims)
            for i, n in enumerate(dims):
                if n != 1:
                    shape[off + i] = n
    return torch.empty(shape, dtype=dtype, device=META)


def _operands(args, kwargs) -> list:
    """The tensors among an op's arguments (and in its lists)."""
    out = []
    for a in (*args, *kwargs.values()):
        if isinstance(a, torch.Tensor):
            out.append(a)
        elif isinstance(a, (list, tuple)):
            out.extend(x for x in a if isinstance(x, torch.Tensor))
    return out


class MeshCounter(TorchDispatchMode):
    """FLOPs, HBM bytes, live and peak bytes and kernel work per
    coordinate of a counting mesh, and the bytes by collective kind of
    the copies between coordinates (the module note)."""

    def __init__(self, n: int):
        super().__init__()
        self.n = n
        self.flops = [0] * n
        self.bytes = [0] * n
        self.live = [0] * n
        self.peak = [0] * n
        self.calls = {k: [0] * n for k in _KERNELS}
        self.coll: dict = {}
        self.dest = None  # the coordinate a placement names
        self.running = 0  # the coordinate of the last op
        self.check = False  # hold each shortcut output to the op's own

    def _free(self, c, n):
        self.live[c] -= n

    def listen(self, kind, t):
        self.coll[kind] = self.coll.get(kind, 0) + _nbytes(t)

    def add(self, operand, name, flops, nbytes):
        """A kernel stand-in's work, on its operand's coordinate."""
        c = _coord(operand)
        c = self.running if c is None else c
        self.flops[c] += flops
        self.bytes[c] += nbytes
        self.calls[name][c] += 1

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = None
        if func in _ELEMENTWISE:
            out = _elementwise_out(func, args, kwargs)
        elif func in _SHAPED and not set(kwargs) - _KWARGS:
            shape, dtype = _SHAPED[func](args, kwargs)
            out = torch.empty(shape, dtype=dtype, device=META)
        if out is not None and self.check:
            want = func(*args, **kwargs)
            assert (want.shape, want.dtype) == (out.shape, out.dtype), \
                (func, want.shape, want.dtype, out.shape, out.dtype)
        if out is None:
            out = func(*args, **kwargs)
        ins = _operands(args, kwargs)
        c = self.dest
        if c is None:
            c = next((x._coord for x in ins if _coord(x) is not None),
                     self.running)
        self.running = c
        outs = [out] if isinstance(out, torch.Tensor) else [
            x for x in out if isinstance(x, torch.Tensor)] if isinstance(
                out, (list, tuple)) else []
        for t in outs:
            if _coord(t) is None or self.dest is not None:
                t._coord = c
        packet = func.overloadpacket
        if func.is_view or packet.__name__ in _FREE:
            return out
        if packet in flop_registry:
            self.flops[c] += flop_registry[packet](*args, **kwargs,
                                                   out_val=out)
        moved = self.bytes
        for x in ins:  # a copy reads on its source
            src = _coord(x) if self.dest is not None else c
            moved[c if src is None else src] += _nbytes(x)
        moved[c] += sum(map(_nbytes, outs))
        seen = {id(x) for x in ins}
        for t in outs:
            if id(t) in seen:
                continue
            n = _nbytes(t)
            self.live[c] += n
            self.peak[c] = max(self.peak[c], self.live[c])
            weakref.finalize(t, self._free, c, n)
        return out


class DataShardSample(EveryDataShard):
    """The executors' loop over data shards while a step is counted (its
    ``shards=``): each loop runs the first ``runs`` (two data shards;
    of an all-firing cross-pod round's pods, the first); on leaving the
    last that runs, its work — per coordinate, and its collective bytes
    — is added again for each later one, on that one's coordinates (the
    run's and its own swapped), and each of their coordinates' peak is
    at least its counterpart's (an estimate there: what lives on the
    mesh's first coordinate or across the loop is not theirs; no
    record reads it, since the busiest coordinate is the first of
    equals, never a later one)."""

    def __init__(self, counter: MeshCounter):
        self.counter = counter

    def each(self, groups, mesh, runs=2):
        for s, group in enumerate(groups[:runs]):
            with self._scope(s, groups, mesh, runs):
                yield s, group

    def skipped(self, groups, runs=2) -> range:
        return range(min(runs, len(groups)), len(groups))

    @contextlib.contextmanager
    def _scope(self, s, groups, mesh, runs):
        if s != runs - 1 or len(groups) <= runs:
            yield
            return
        ct = self.counter
        outer = ct.flops, ct.bytes, ct.calls, ct.coll, ct.peak
        n = ct.n
        ct.flops, ct.bytes, ct.coll = [0] * n, [0] * n, {}
        ct.calls = {k: [0] * n for k in _KERNELS}
        ct.peak = list(ct.live)
        try:
            yield
        finally:
            part = ct.flops, ct.bytes, ct.calls, ct.coll, ct.peak
            ct.flops, ct.bytes, ct.calls, ct.coll, ct.peak = outer
            run = [mesh.device(c).index for c in groups[s]]
            for d in range(s, len(groups)):
                perm = list(range(n))
                for a, b in zip(run, (mesh.device(c).index
                                      for c in groups[d]), strict=True):
                    perm[a], perm[b] = b, a
                for c in range(n):
                    p = perm[c]
                    ct.flops[p] += part[0][c]
                    ct.bytes[p] += part[1][c]
                    for k in _KERNELS:
                        ct.calls[k][p] += part[2][k][c]
                    ct.peak[p] = max(ct.peak[p], part[4][c])
                for kind, v in part[3].items():
                    ct.coll[kind] = ct.coll.get(kind, 0) + v


# ----------------------------------------------------------------------
# the steps
# ----------------------------------------------------------------------


def analytic_hbm_bytes(cfg, *, step_mode, batch, seq, n_chips,
                       multi_pod, local_steps):
    """First-principles per-device HBM estimate (the reference's, line
    for line)."""
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


def mesh_skip_reason(cfg, shape, *, multi_pod) -> str:
    """Why the reference's mesh cannot take this step ("" where it
    can)."""
    step_mode, _, batch = INPUT_SHAPES[shape]
    if step_mode == "prefill" and cfg.family == "audio":
        return ("the audio encoder has no prefill on a mesh: the "
                "reference's prefill has no encoder path (ROADMAP D13) "
                "and the port has no mesh encode step")
    if step_mode != "train":
        shards = (N_PODS if multi_pod else 1) * 16
        if batch % shards:
            axes = "pod × data" if multi_pod else "data"
            return (f"batch {batch} does not split over the {shards} data "
                    f"shards of {axes}: the reference's jit raises "
                    f"(dimension 0 should be divisible by {shards})")
    return ""


def build_step(cfg, shape: str, *, multi_pod: bool, mode: str = "fsdp",
               local_steps: int = 2, one_card: bool = False, mesh=None,
               batch=None, seq=None):
    """``((cfg, model, mesh, (fn, args), step_mode, seq, batch), "")``
    for a shape that applies, else ``(None, the skip reason)``: the
    step on the reference's production mesh (``mesh`` its shapes, each
    coordinate on its :class:`Coord`; ``args`` the step's
    ``MeshArgs``), or with
    ``one_card`` the one-card step (``mesh`` None).  ``mesh``,
    ``batch`` and ``seq`` replace the production mesh and the shape's
    sizes (the tests' small steps)."""
    ok, reason = shape_applicable(cfg, shape)
    if not ok:
        return None, reason
    step_mode, seq0, batch0 = INPUT_SHAPES[shape]
    seq, batch = seq or seq0, batch or batch0
    model = build_model(cfg)
    if one_card:
        if step_mode == "train" and multi_pod:
            built = make_cross_pod_step(model, batch=batch, seq=seq,
                                        n_pods=N_PODS,
                                        local_steps=local_steps,
                                        every_pod_fires=True)
        elif step_mode == "train":
            built = make_train_step(model, batch=batch, seq=seq)
        elif step_mode == "prefill" and cfg.family == "audio":
            built = make_encode_step(model, batch=batch, seq=seq)
        elif step_mode == "prefill":
            built = make_prefill_step(model, batch=batch, seq=seq)
        else:
            built = make_decode_step(model, batch=batch, seq=seq)
        return (cfg, model, None, built, step_mode, seq, batch), ""
    if mesh is None:
        reason = mesh_skip_reason(cfg, shape, multi_pod=multi_pod)
        if reason:
            return None, reason
        mesh = make_production_mesh(multi_pod=multi_pod, devices=["meta"])
    mesh = counting_mesh(mesh)
    baxes = ("pod", "data") if multi_pod else ("data",)
    if step_mode == "train":
        if multi_pod:
            built = make_cross_pod_step(model, mesh, batch=batch, seq=seq,
                                        mode=mode, local_steps=local_steps,
                                        every_pod_fires=True)
        else:
            built = make_train_step(model, mesh, batch=batch, seq=seq,
                                    mode=mode, batch_axes=baxes)
    elif step_mode == "prefill":
        built = make_prefill_step(model, mesh, batch=batch, seq=seq,
                                  mode=mode, batch_axes=baxes)
    else:
        built = make_decode_step(model, mesh, batch=batch, seq=seq,
                                 mode=mode, batch_axes=baxes)
    return (cfg, model, mesh, built, step_mode, seq, batch), ""


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


def _card_cost(built) -> dict:
    """One card's count of a step built without a mesh."""
    _, _, _, (fn, args), *_ = built
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


def mesh_arguments(built, mesh, mode):
    """The step's arguments cut by its ``in_specs`` over ``mesh`` (a
    counting mesh, or a mesh of devices) — a decode's cache under tp,
    fsdp_tp and ep in the layout the tp executor keeps
    (``sharding.serve.tp_cache_specs``, ROADMAP D14)."""
    cfg, model, _, (_, args), step_mode, seq, batch = built
    trees, specs = list(args), list(args.in_specs)
    if step_mode == "decode" and mode != "fsdp":
        lay = TpLayout(cfg, specs[0], mesh)
        whole = abstract_cache(model, batch, seq)
        for k in ("k", "v"):
            if k in whole:
                x = whole[k]
                whole[k] = torch.empty(
                    x.shape[:3] + (lay.kv_heads * lay.model_size,)
                    + x.shape[4:], dtype=x.dtype, device=META)
        baxes = tuple(a for a in mesh.axis_names if a != "model")
        trees[2] = whole
        specs[2] = tp_cache_specs(cfg, batch, mesh, baxes)
    return [shard_tree(t, s, mesh) for t, s in zip(trees, specs,
                                                  strict=True)]


def _out_bytes(built, outs, mesh) -> int:
    """``per_device_bytes`` of the outputs by the step's ``out_specs``;
    one the specs leave to the step counted whole."""
    cfg, model, _, (_, args), step_mode, seq, batch = built
    if step_mode == "train":
        shapes = (args[0], args[1], None) if len(args) == 4 else (args[0],
                                                                  None)
    else:
        shapes = (None, abstract_cache(model, batch, seq))
    total = 0
    for shape, spec, out in zip(shapes, args.out_specs, outs, strict=True):
        if spec is None:
            total += sum(map(_nbytes, _tensors(out)))
        else:
            total += per_device_bytes(shape, spec, mesh)
    return total


def mesh_cost(built, mode, *, sample=True, check=False) -> dict:
    """A mesh step's count on its counting mesh (the module note): per
    coordinate FLOPs, bytes, peak live bytes and kernel calls, the
    mesh's collective bytes by kind, and the arguments' and outputs'
    bytes a device; ``sample`` False runs every data shard, ``check``
    holds every elementwise shortcut to the op's own output."""
    mesh = built[2]
    fn, args = built[3]
    sharded = mesh_arguments(built, mesh, mode)
    for x in sharded:
        tag_tree(x)
    counter = MeshCounter(mesh.size)
    counter.check = check
    shards = DataShardSample(counter) if sample else EVERY_DATA_SHARD
    collectives.listeners.append(counter.listen)
    try:
        with kernel_stand_ins(counter), _Placement(counter), counter:
            outs = fn(*sharded, shards=shards)
    finally:
        collectives.listeners.remove(counter.listen)
    args_bytes = sum(per_device_bytes(a, s, mesh)
                     for a, s in zip(args, args.in_specs, strict=True))
    return {
        "flops": [float(x) for x in counter.flops],
        "bytes": [float(x) for x in counter.bytes],
        "temp_bytes": [float(x) for x in counter.peak],
        **{k: [float(x) for x in v] for k, v in counter.calls.items()},
        "collectives": {k: float(v) for k, v in sorted(counter.coll.items())},
        "args_bytes": float(args_bytes),
        "out_bytes": float(_out_bytes(built, outs, mesh)),
    }


def count_cost(cfg, shape, *, multi_pod, mode="fsdp", local_steps=2,
               one_card=False, **sizes) -> dict:
    """Run one step on the meta device and count it (no correction).
    On one card: FLOPs, bytes and collective bytes (0), the arguments',
    outputs' and peak temporaries' bytes, and the K4 / K5 calls.  On the
    mesh: the same per coordinate (lists in row-major order), the
    collective bytes by kind over the mesh and the arguments' and
    outputs' bytes a device."""
    sample, check = sizes.pop("sample", True), sizes.pop("check", False)
    built, reason = build_step(cfg, shape, multi_pod=multi_pod, mode=mode,
                               local_steps=local_steps, one_card=one_card,
                               **sizes)
    if built is None:
        raise ValueError(f"{cfg.name} × {shape}: {reason}")
    return (_card_cost(built) if one_card
            else mesh_cost(built, mode, sample=sample, check=check))


def _extrapolate(cfg, c1: dict, c2: dict) -> dict:
    """cost(L) = cost(1 unit) + (units − 1) · (cost(2) − cost(1)), key by
    key (element by element for a mesh's per-coordinate lists and
    by-kind collectives)."""
    units = _scan_units(cfg)

    def ex(a, b):
        if isinstance(a, dict):
            return {k: ex(a.get(k, 0.0), b.get(k, 0.0))
                    for k in sorted(set(a) | set(b))}
        if isinstance(a, list):
            return [ex(x, y) for x, y in zip(a, b, strict=True)]
        return a + (units - 1) * max(b - a, 0.0)

    return {k: ex(c1[k], c2[k]) for k in c1}


def corrected_cost(cfg, shape, *, multi_pod, mode="fsdp", local_steps=2,
                   one_card=False, **sizes) -> dict:
    """The reference's correction: count the 1-unit and 2-unit variants
    of the step and extrapolate over the units, here so that Python's
    dispatch of an eager step runs over two units and not every
    layer."""
    return _extrapolate(cfg, *(
        count_cost(_reduced_layers(cfg, n), shape, multi_pod=multi_pod,
                   mode=mode, local_steps=local_steps, one_card=one_card,
                   **sizes)
        for n in (1, 2)))


# ----------------------------------------------------------------------
# records
# ----------------------------------------------------------------------


def _base(arch, shape, multi_pod, card, mode, one_card) -> dict:
    if one_card:
        return {"arch": arch, "shape": shape, "mesh": CARD_MESH,
                "pods": N_PODS if multi_pod else 1, "card": card}
    return {"arch": arch, "shape": shape, "mesh": MESH_NAMES[multi_pod],
            "sharding_mode": mode, "card": card}


def _check_card(card: str) -> dict:
    peaks = card_peaks(card)
    if peaks["hbm_bytes_per_s"] is None:
        raise ValueError(f"the roofline tables do not name the card "
                         f"{card!r}")
    return peaks


def busiest(cost, *, peak_flops, hbm_bw) -> int:
    """The coordinate of a mesh count's longest roofline term (the
    first of equals)."""
    terms = [max(f / peak_flops, b / hbm_bw)
             for f, b in zip(cost["flops"], cost["bytes"], strict=True)]
    return max(range(len(terms)), key=lambda c: (terms[c], -c))


def make_record(arch, shape, cfg, cost, *, multi_pod, card, mode="fsdp",
                local_steps=2, count_s=0.0, one_card=False,
                mesh=None) -> dict:
    """The record of one applicable (arch × shape × mesh) step from its
    counted ``cost`` (the reference's keys where they apply); ``mesh``
    the one counted on, if not the production mesh."""
    peaks = _check_card(card)
    step_mode, seq, batch = INPUT_SHAPES[shape]
    peak_flops = (peaks["bf16_flops"] if cfg.dtype == "bfloat16"
                  else peaks["fp32_flops"])
    hbm_bw = peaks["hbm_bytes_per_s"]
    extra = {}
    if one_card:
        n_chips = 1
        flops, moved, coll = cost["flops"], cost["bytes"], cost["coll"]
        temp = cost["temp_bytes"]
        calls = {k: int(cost[k]) for k in _KERNELS}
        by_kind = {}
    else:
        n_chips = len(cost["flops"])
        c = busiest(cost, peak_flops=peak_flops, hbm_bw=hbm_bw)
        flops, moved = cost["flops"][c], cost["bytes"][c]
        temp = cost["temp_bytes"][c]
        calls = {k: int(cost[k][c]) for k in _KERNELS}
        by_kind = {k: {"bytes": v / n_chips}
                   for k, v in cost["collectives"].items()}
        coll = sum(cost["collectives"].values()) / n_chips
        mesh = mesh or make_production_mesh(multi_pod=multi_pod,
                                            devices=["meta"])
        extra = {"busiest_coordinate": list(mesh.coords()[c]),
                 "mesh_flops": sum(cost["flops"]),
                 "link": "every axis at LINK_BW (NVLink 4, one way); the "
                         "links between nodes are not priced"}
    terms = roofline_terms(flops, moved, coll, collectives=by_kind,
                           peak_flops=peak_flops, hbm_bw=hbm_bw)
    # The global batch spans the cross-pod local steps (batch = pods ×
    # local_steps × per-step), as in the reference.
    mf = model_flops_per_device(
        cfg, mode=step_mode, batch=batch, seq=seq, n_chips=n_chips,
        active_params=active_param_count(cfg))
    mem = {"argument_size_in_bytes": int(cost["args_bytes"]),
           "output_size_in_bytes": int(cost["out_bytes"]),
           "temp_size_in_bytes": int(temp)}
    per_dev_bytes = sum(mem.values())
    analytic = analytic_hbm_bytes(cfg, step_mode=step_mode, batch=batch,
                                  seq=seq, n_chips=n_chips,
                                  multi_pod=multi_pod,
                                  local_steps=local_steps)
    record = {
        **_base(arch, shape, multi_pod, card, mode, one_card),
        "status": "ok",
        "step": ("encode" if step_mode == "prefill"
                 and cfg.family == "audio" else step_mode),
        "seq": seq,
        "batch": batch,
        "n_chips": n_chips,
        "count_s": round(count_s, 2),
        "memory_analysis": mem,
        "bytes_per_device": per_dev_bytes,
        "analytic_hbm_bytes": int(analytic),
        "fits_hbm_80GB": bool(analytic < CARD_HBM_BYTES),
        "meta_measured_fits": bool(per_dev_bytes < CARD_HBM_BYTES),
        "model_flops_per_device": mf,
        "useful_flops_ratio": (mf / terms["hlo_flops_per_device"]
                               if terms["hlo_flops_per_device"] else None),
        "kernel_calls": calls,
        "roofline": terms,
        **extra,
    }
    if multi_pod and step_mode == "train":
        record["assumed"] = EVERY_POD_FIRES
    return record


def _skip_reason(cfg, shape, multi_pod, one_card) -> str:
    ok, reason = shape_applicable(cfg, shape)
    if not ok:
        return reason
    return "" if one_card else mesh_skip_reason(cfg, shape,
                                                multi_pod=multi_pod)


def dry_run(arch: str, shape: str, *, multi_pod: bool = False,
            mode: str = "fsdp", local_steps: int = 2,
            cost_correction: bool = True, cfg=None, card: str,
            one_card: bool = False) -> dict:
    """Count one (arch × shape × mesh) step on the meta device; return
    its record (a skip record where the step does not apply)."""
    t0 = time.time()
    cfg = cfg or get_config(arch)
    _check_card(card)
    reason = _skip_reason(cfg, shape, multi_pod, one_card)
    if reason:
        return {**_base(arch, shape, multi_pod, card, mode, one_card),
                "status": "skipped", "reason": reason}
    cost = (corrected_cost if cost_correction else count_cost)(
        cfg, shape, multi_pod=multi_pod, mode=mode, local_steps=local_steps,
        one_card=one_card)
    return make_record(arch, shape, cfg, cost, multi_pod=multi_pod,
                       card=card, mode=mode, local_steps=local_steps,
                       count_s=time.time() - t0, one_card=one_card)


def _count_task(task):
    """One 1- or 2-unit count of a sweep, in a worker: (cost or None,
    seconds, the traceback or None)."""
    cfg, shape, multi_pod, mode, local_steps, one_card = task
    t0 = time.time()
    try:
        cost = count_cost(cfg, shape, multi_pod=multi_pod, mode=mode,
                          local_steps=local_steps, one_card=one_card)
        return cost, time.time() - t0, None
    except Exception:
        return None, time.time() - t0, traceback.format_exc()[-2000:]


def sweep(combos, *, card: str, mode: str = "fsdp", local_steps: int = 2,
          jobs: int = 1, overrides=lambda cfg: cfg, one_card=False):
    """Yield the record of each (arch, shape, multi_pod) in ``combos``,
    in order; their 1- and 2-unit counts run in ``jobs`` spawned
    processes (``jobs`` 1: here).  On one card a serving step of
    ``multi_pod`` is the single one, counted once.  A count that raises
    gives an error record."""
    _check_card(card)
    plans, tasks = [], {}
    for arch, shape, mp in combos:
        cfg = overrides(get_config(arch))
        reason = _skip_reason(cfg, shape, mp, one_card)
        key = (arch, shape, mp and (not one_card
                                    or INPUT_SHAPES[shape][0] == "train"))
        plans.append((arch, shape, mp, cfg, reason, key))
        if not reason:
            for n in (1, 2):
                tasks.setdefault((key, n), (_reduced_layers(cfg, n), shape,
                                            key[2], mode, local_steps,
                                            one_card))
    keys = list(tasks)
    if jobs > 1 and len(keys) > 1:
        import multiprocessing

        # The longest counts first, so that no worker is left with one.
        def weight(i):  # cross-pod rounds, then train steps, 2 units
            (_, shape, mp), n = keys[i]
            train = INPUT_SHAPES[shape][0] == "train"
            return (-2 * (mp and train) - train, -n)

        order = sorted(range(len(keys)), key=weight)
        with multiprocessing.get_context("spawn").Pool(jobs) as pool:
            done = pool.map(_count_task, [tasks[keys[i]] for i in order],
                            chunksize=1)
        results = {keys[i]: r for i, r in zip(order, done, strict=True)}
    else:
        results = {k: _count_task(tasks[k]) for k in keys}
    for arch, shape, mp, cfg, reason, key in plans:
        base = _base(arch, shape, mp, card, mode, one_card)
        if reason:
            yield {**base, "status": "skipped", "reason": reason}
            continue
        (c1, s1, e1), (c2, s2, e2) = results[(key, 1)], results[(key, 2)]
        if e1 or e2:
            yield {**base, "status": "error", "error": e1 or e2}
            continue
        try:
            yield make_record(arch, shape, cfg, _extrapolate(cfg, c1, c2),
                              multi_pod=mp, card=card, mode=mode,
                              local_steps=local_steps, count_s=s1 + s2,
                              one_card=one_card)
        except Exception:
            yield {**base, "status": "error",
                   "error": traceback.format_exc()[-2000:]}


def _card_name(card):
    if card:
        return card
    if torch.cuda.is_available():
        return torch.cuda.get_device_name(0)
    raise SystemExit("dryrun: no CUDA device is visible; name the card "
                     "the records are for with --card NAME")


def record_name(arch, shape, multi_pod, *, sharding=None, tag="") -> str:
    """A record's file name: the reference's
    ``{arch}__{shape}__{single|multi}__{sharding}{__tag}.json``, and
    without the sharding for the one-card records."""
    return (f"{arch}__{shape}__{'multi' if multi_pod else 'single'}"
            + (f"__{sharding}" if sharding else "")
            + (f"__{tag}" if tag else "") + ".json")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="all",
                    help="architecture id, ids joined by commas, or 'all'")
    ap.add_argument("--shape", default="all",
                    help=f"one of {list(INPUT_SHAPES)} or 'all'")
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both", "card"],
                    help="the reference's 16x16 (single), 2x16x16 "
                         "(multi) or both; 'card': the port's one-card "
                         "records, one pod and two")
    ap.add_argument("--sharding", default="fsdp", choices=SHARDING_MODES)
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
    one_card = args.mesh == "card"
    sharding = None if one_card else args.sharding

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

    archs = (list(ARCHITECTURES) if args.arch == "all"
             else args.arch.split(","))
    shapes = list(INPUT_SHAPES) if args.shape == "all" else [args.shape]
    meshes = {"single": [False], "multi": [True], "both": [False, True],
              "card": [False, True]}[args.mesh]

    def fname(arch, shape, mp):
        return record_name(arch, shape, mp, sharding=sharding, tag=args.tag)

    combos = []
    for arch, shape, mp in itertools.product(archs, shapes, meshes):
        if (args.skip_existing and args.out and os.path.exists(
                os.path.join(args.out, fname(arch, shape, mp)))):
            print(f"{arch}|{shape}|{'multi' if mp else 'single'}: exists, "
                  "skipping", flush=True)
            continue
        combos.append((arch, shape, mp))
    failures = 0
    t0 = time.time()
    records = sweep(combos, card=card, mode=args.sharding,
                    local_steps=args.local_steps, jobs=args.jobs,
                    overrides=apply_overrides, one_card=one_card)
    for (arch, shape, mp), rec in zip(combos, records, strict=True):
        tag = f"{arch}|{shape}|{'multi' if mp else 'single'}"
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
            with open(os.path.join(args.out, fname(arch, shape, mp)),
                      "w") as f:
                json.dump(rec, f, indent=1)
    print(f"dryrun: {len(combos)} records, {failures} in error, "
          f"{time.time() - t0:.1f} s", flush=True)
    raise SystemExit(1 if failures else 0)


if __name__ == "__main__":
    main()

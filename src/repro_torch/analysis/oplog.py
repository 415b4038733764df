"""The op log: what one round of the port does, op by op.

The twin of the reference's jaxpr/HLO view (``repro/utils/hlo.py``).
Eager torch builds no program to read, so the checker records one:
:class:`OpLog` is a context manager that, while it is open,

- records every ATen op (a ``TorchDispatchMode``): its name, input and
  output shapes and dtypes, whether it writes an input in place or
  returns a view, and the spans it ran in (``utils/spans.py``), so a
  rule can leave out the ops of a kernel wrapper (``kernel/*``, the
  plain version on the CPU) and of the local solve (``fedback/solve``,
  the reference's ``scan`` body);
- records every read of a tensor back to the host (a
  ``TorchFunctionMode``): ``.item()``, ``.tolist()``, ``.numpy()``,
  ``.cpu()`` and ``bool``/``int``/``float``/``index`` of a tensor on the
  round's device — on the CPU a ``.cpu()`` makes no ATen op, so it is
  seen only here;
- takes the kernel wrappers' ``calls`` and ``launches`` over the round
  (``kernels/ops.py``) and every copy between shards with its bytes
  (``sharding.clients.collectives``).

On a CUDA device it also takes the CUDA kernels' names from a
``torch.profiler`` trace, ``torch.cuda.max_memory_allocated`` over the
round less its start, and the calls that synchronize with the card
under ``torch.cuda.set_sync_debug_mode`` (in ``"warn"`` mode, each
warning assigned to the torch call it came out of — the mode warns as
the call returns to Python, not from the ATen op; :mod:`.retrace`'s
transfer guard runs in ``"error"`` mode).

A **sync op** is one that would make the card wait: a host read (above),
an ATen op that needs a value on the host (``_local_scalar_dense``,
``nonzero``, ``masked_select``, the ``unique`` family) on a tensor of
the round's device, or a blocking copy from the round's CUDA device to
the CPU; ops inside a host read count once, as the read.  On the CPU the
round's device is the host, so the host backend's row writes into host
memory run in the span ``hoststate/host`` and their ops are not sync
ops there, as they are not on the card.
"""
from __future__ import annotations

import dataclasses
import warnings
from collections import Counter

import torch
from torch.overrides import TorchFunctionMode
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from repro_torch.kernels import ops
from repro_torch.sharding.clients import collectives
from repro_torch.utils import spans

#: ATen ops that read a value back to the host.
SYNC_OPS = frozenset({"_local_scalar_dense", "nonzero", "masked_select",
                      "_unique", "_unique2", "unique_dim",
                      "unique_consecutive", "unique_dim_consecutive"})
#: Tensor methods that read a tensor back to the host.
HOST_READS = frozenset({"item", "tolist", "numpy", "cpu", "__bool__",
                        "__int__", "__float__", "__index__"})
#: The profiler's own ops (a ``span`` makes two): not the round's.
_PROFILER_OPS = frozenset({"_record_function_enter",
                           "_record_function_enter_new",
                           "_record_function_exit"})
#: The span of the host backend's writes into host memory.
HOST_GLUE = "hoststate/host"


@dataclasses.dataclass(frozen=True)
class OpRecord:
    """One ATen op of the round."""

    name: str  # overload packet: "add", "add_", "_to_copy", ...
    in_shapes: tuple
    in_dtypes: tuple
    shapes: tuple  # output shapes
    dtypes: tuple  # output dtypes, as "torch.float32"
    inplace: bool  # writes an input (its schema says so)
    view: bool  # returns a view of an input
    scopes: tuple  # the open spans, outermost first
    sync: bool  # a sync op by name or by copy (module docstring)
    nested: bool  # ran inside a host read (counted as the read)

    def within(self, prefixes) -> bool:
        """Whether any open span starts with one of ``prefixes``."""
        return any(s.startswith(p) for s in self.scopes for p in prefixes)


@dataclasses.dataclass(frozen=True)
class Transfer:
    """A copy between shards (``sharding.clients.collectives``)."""

    kind: str
    shape: tuple
    dtype: str
    nbytes: int


def _is_sync_warning(w) -> bool:
    """The sync debug mode's warning (not its own "prototype" notice)."""
    text = str(w.message).lower()
    return "synchroniz" in text and "prototype" not in text


def _tensors(tree) -> list:
    return [x for x in tree_flatten(tree)[0] if isinstance(x, torch.Tensor)]


def _copies_to_host(name, args, kwargs, outs, device) -> bool:
    """A blocking copy from the CUDA ``device`` to the CPU."""
    if device.type == "cpu" or kwargs.get("non_blocking"):
        return False
    if name == "_to_copy":
        src, dst = args[0], outs[0] if outs else None
    elif name == "copy_":
        if len(args) > 2 and args[2]:
            return False
        dst, src = args[0], args[1]
    else:
        return False
    return (isinstance(src, torch.Tensor) and dst is not None
            and src.device.type == device.type and dst.device.type == "cpu")


class _Dispatch(TorchDispatchMode):
    def __init__(self, log: OpLog):
        super().__init__()
        self.log = log

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        log = self.log
        out = func(*args, **kwargs)
        name = func.overloadpacket.__name__
        if name in _PROFILER_OPS:
            return out
        ins, outs = _tensors((args, kwargs)), _tensors(out)
        scopes = spans.scopes()
        on_device = any(t.device.type == log.device.type for t in ins)
        sync = ((name in SYNC_OPS and on_device and HOST_GLUE not in scopes)
                or _copies_to_host(name, args, kwargs, outs, log.device))
        schema = func._schema
        nested = log._reading > 0
        log._op_syncs += sync and not nested
        log.ops.append(OpRecord(
            name=name,
            in_shapes=tuple(tuple(t.shape) for t in ins),
            in_dtypes=tuple(str(t.dtype) for t in ins),
            shapes=tuple(tuple(t.shape) for t in outs),
            dtypes=tuple(str(t.dtype) for t in outs),
            inplace=schema.is_mutable,
            view=any(r.alias_info is not None and not r.alias_info.is_write
                     for r in schema.returns),
            scopes=scopes, sync=sync, nested=nested))
        return out


class _Reads(TorchFunctionMode):
    def __init__(self, log: OpLog):
        super().__init__()
        self.log = log

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        log = self.log
        name = getattr(func, "__name__", "")
        read = (name in HOST_READS and args
                and isinstance(args[0], torch.Tensor)
                and args[0].device.type == log.device.type)
        scopes = spans.scopes()
        if read:
            log.host_reads.append((name, scopes))
        warned = len(log._warnings) if log._warnings is not None else 0
        op_syncs = log._op_syncs
        log._reading += bool(read)
        try:
            return func(*args, **kwargs)
        finally:
            log._reading -= bool(read)
            if log._warnings is not None and any(
                    _is_sync_warning(w) for w in log._warnings[warned:]):
                # Counted once: as the read, as the ATen sync op inside
                # the call, or as the call.
                log.cuda_syncs.append((name, scopes,
                                       bool(read) or log._op_syncs
                                       > op_syncs))


class OpLog:
    """``with OpLog(device) as log:`` around one round; see the module
    docstring.  ``profile`` (CUDA only, default on) takes the CUDA
    kernels' names from a profiler trace; ``sync_mode`` ("warn" by
    default; None leaves it) is the CUDA sync debug mode it records
    under."""

    def __init__(self, device, *, profile: bool = True,
                 sync_mode: str | None = "warn"):
        self.device = torch.device(device)
        self.cuda = self.device.type == "cuda"
        self.profile = profile and self.cuda
        self.sync_mode = sync_mode if self.cuda else None
        self.ops: list[OpRecord] = []
        self.host_reads: list[tuple] = []
        # (call, scopes, counted elsewhere) per call the CUDA sync debug
        # mode warned during.
        self.cuda_syncs: list[tuple] = []
        self.transfers: list[Transfer] = []
        self.calls: dict = {}
        self.launches: dict = {}
        self.cuda_kernels: Counter | None = None
        self.peak_bytes: int | None = None
        self._warnings = None
        self._reading = 0
        self._op_syncs = 0

    # --- recording --------------------------------------------------
    def _on_copy(self, kind, t):
        self.transfers.append(Transfer(
            kind=kind, shape=tuple(t.shape), dtype=str(t.dtype),
            nbytes=t.numel() * t.element_size()))

    def __enter__(self):
        if self.cuda:
            torch.cuda.synchronize(self.device)
            self._start_bytes = torch.cuda.memory_allocated(self.device)
            torch.cuda.reset_peak_memory_stats(self.device)
        self._calls0 = ops.call_counts()
        self._launches0 = ops.launch_counts()
        collectives.listeners.append(self._on_copy)
        self._stack = []
        if self.profile:
            prof = torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA])
            prof.__enter__()
            self._stack.append(prof)
        if self.sync_mode is not None:
            self._prev_sync = torch.cuda.get_sync_debug_mode()
            catcher = warnings.catch_warnings(record=True)
            self._warnings = catcher.__enter__()
            warnings.simplefilter("always")
            self._stack.append(catcher)
            torch.cuda.set_sync_debug_mode(self.sync_mode)
        self._reads = _Reads(self)
        self._dispatch = _Dispatch(self)
        self._reads.__enter__()
        self._dispatch.__enter__()
        return self

    def __exit__(self, *exc):
        self._dispatch.__exit__(*exc)
        self._reads.__exit__(*exc)
        if self.sync_mode is not None:
            torch.cuda.set_sync_debug_mode(self._prev_sync)
        collectives.listeners.remove(self._on_copy)
        prof = None
        for ctx in reversed(self._stack):
            ctx.__exit__(*exc)
            if isinstance(ctx, torch.profiler.profile):
                prof = ctx
        calls, launches = ops.call_counts(), ops.launch_counts()
        self.calls = {k: v - self._calls0[k] for k, v in calls.items()
                      if v != self._calls0[k]}
        self.launches = {k: v - self._launches0[k]
                         for k, v in launches.items()
                         if v != self._launches0[k]}
        if self.cuda:
            torch.cuda.synchronize(self.device)
            self.peak_bytes = (torch.cuda.max_memory_allocated(self.device)
                               - self._start_bytes)
        if prof is not None:
            self.cuda_kernels = Counter(
                e.name for e in prof.events()
                if e.device_type == torch.autograd.DeviceType.CUDA
                and not spans.is_span(e.name))
        return False

    # --- facts ------------------------------------------------------
    def outside(self, prefixes):
        """The ops that ran in none of the spans starting with
        ``prefixes``."""
        return [op for op in self.ops if not op.within(prefixes)]

    def syncs(self) -> list[tuple]:
        """(what, scopes) of each sync op: the host reads, the ATen
        sync ops outside a host read, and the other calls the CUDA sync
        debug mode warned during."""
        out = [(f"Tensor.{name}", sc) for name, sc in self.host_reads]
        out += [(op.name, op.scopes) for op in self.ops
                if op.sync and not op.nested]
        out += [(name, sc) for name, sc, counted in self.cuda_syncs
                if not counted]
        return out

    def signature(self) -> tuple:
        """The round's op signature: per op its name, input and output
        shapes and dtypes and innermost span, then the kernel calls.
        Equal signatures are what a CUDA graph of the round needs."""
        return (tuple((op.name, op.in_shapes, op.in_dtypes, op.shapes,
                       op.dtypes, op.scopes[-1] if op.scopes else "")
                      for op in self.ops),
                tuple(sorted(self.calls.items())))

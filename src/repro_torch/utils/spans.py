"""Named ranges of the round, and the kernel wrappers' call counts.

:func:`span` opens a ``torch.profiler.record_function`` range (a no-op
costing about a microsecond when no profiler is running) and pushes its
name onto a stack that :mod:`repro_torch.analysis.oplog` reads, so each
ATen op it records carries the ranges it ran in: ``fedback/solve`` (the
local solve, the reference's ``scan`` body), ``kernel/<name>`` (a kernel
wrapper, on the kernel path and on the plain one), ``hoststate/*`` (the
host backend's legs), ``compress/fma`` (the compressed consensus's
float64 FMA emulation).

:func:`kernel_wrapper` makes a function of ``kernels/ops.py::KERNELS`` a
counted wrapper: each call runs inside ``span("kernel/<name>")`` and
ticks ``calls`` on the kernel path and the plain path alike, while the
wrapper's own ``launches`` goes on counting launches on the card only.
A wrapper that hands its work to another (``trigger_sq_norms_pytree`` on
a flat matrix → ``trigger_sq_norms``, ``admm_update(mesh=)`` →
``admm_update_sharded``) counts no call: the innermost wrapper does.
"""
from __future__ import annotations

import functools

import torch

_SCOPES: list[str] = []
# One entry per kernel wrapper being run: whether it called another.
_WRAPPERS: list[list[bool]] = []
#: Every span name made in this process.  A profiler trace carries each
#: span as a range and, with CUDA activity, as a copy of the range on the
#: device timeline, which readers of kernel events leave out
#: (:func:`is_span`).
NAMES: set[str] = set()


def scopes() -> tuple[str, ...]:
    """The names of the open spans, outermost first."""
    return tuple(_SCOPES)


def is_span(key: str) -> bool:
    """Whether a profiler event's key is a span, not a kernel."""
    return key in NAMES


class span:
    """``with span(name):`` — a profiler range that the op log sees."""

    __slots__ = ("name", "_range")

    def __init__(self, name: str):
        self.name = name
        NAMES.add(name)
        self._range = torch.profiler.record_function(name)

    def __enter__(self):
        _SCOPES.append(self.name)
        self._range.__enter__()
        return self

    def __exit__(self, *exc):
        try:
            self._range.__exit__(*exc)
        finally:
            _SCOPES.pop()
        return False


def kernel_wrapper(name: str):
    """Decorate a kernel wrapper: a ``kernel/<name>`` span around each
    call, ``calls`` (innermost wrapper only) and ``launches`` (set by
    the wrapper where it launches) start at 0."""
    def wrap(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            if _WRAPPERS:
                _WRAPPERS[-1][0] = True
            frame = [False]
            _WRAPPERS.append(frame)
            try:
                with span(f"kernel/{name}"):
                    out = fn(*args, **kwargs)
            finally:
                _WRAPPERS.pop()
            if not frame[0]:
                wrapper.calls += 1
            return out

        wrapper.calls = 0
        wrapper.launches = 0
        return wrapper
    return wrap

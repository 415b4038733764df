"""Dynamic invariants: one op signature per run, no read-back at run
time.

Port of ``repro/analysis/retrace.py``.  Eager torch does not trace, so
the twin of "the round traces once" is **one op signature**: the
sequence of ATen ops (name, input and output shapes and dtypes, span)
and kernel calls (:meth:`~.oplog.OpLog.signature`) is the same in every
round of a run.  That is what a CUDA graph of the round needs: one
launch sequence, replayed with new values.  The checks keep the
reference's result names:

- :func:`run_single_trace_check` (``single-trace``) steps the round
  across rounds and controller-override values (``ctrl_arg=True``);
- :func:`run_serve_trace_check` (``serve-single-trace``) drains a
  varying arrival trace through the serve step;
- :func:`run_transfer_guard_check` (``transfer-guard``) runs steady
  rounds with zero sync ops, and on the card under
  ``torch.cuda.set_sync_debug_mode("error")``, which raises on one.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.fedback import init_state, make_round_fn
from repro_torch.device import resolve_device

from .artifacts import ConfigKey, build_config, build_problem
from .oplog import OpLog
from .rules import RuleResult, _result


def _setup(key, n, n_points, dim, device, **round_kw):
    device = resolve_device(device)
    data, params0, loss_fn, spec, ragged = build_problem(
        key, n=n, n_points=n_points, dim=dim, device=device)
    cfg = build_config(key, n=n)
    round_fn = make_round_fn(cfg, loss_fn, data, spec=spec, ragged=ragged,
                             device=device, **round_kw)
    return device, round_fn, init_state(cfg, params0, spec=spec,
                                        device=device)


def _signatures(device, round_fn, state, calls) -> list:
    """Run ``round_fn(state, *args)`` for each args in ``calls``, each
    under an op log; returns the distinct signatures, in order.  A round
    that raises (a mask of another dtype can fail the round's ops where
    the reference would retrace) ends the run with ``("raised", text)``
    as its last entry."""
    sigs = []
    for args in calls:
        try:
            with OpLog(device, profile=False, sync_mode=None) as log:
                state, _metrics = round_fn(state, *args)
        except RuntimeError as e:
            sigs.append(("raised", f"{type(e).__name__}: {e}"))
            break
        if log.signature() not in sigs:
            sigs.append(log.signature())
    return sigs


def _signature_violations(name: str, sigs: list, steps: int,
                          what: str) -> list[str]:
    """A run passes with one signature and no raise; a round that
    raised is a violation wherever it came, the first round included."""
    raised = [s[1] for s in sigs if s[0] == "raised"]
    if raised:
        return [f"{name}: a round raised after {len(sigs) - 1} op "
                f"signature(s): {raised[0]}"]
    if len(sigs) != 1:
        return [f"{name}: {len(sigs)} op signatures over {steps} {what}"]
    return []


def run_single_trace_check(key: ConfigKey | None = None, *, n: int = 16,
                           n_points: int = 8, dim: int = 8,
                           rounds: int = 3,
                           rates: tuple = (0.3, 0.7, 0.5),
                           shape_mutation: bool = False,
                           device=None) -> RuleResult:
    """Step ``rounds × len(rates)`` rounds varying the controller
    overrides (0-d fp32 tensors); every round must run one op signature.

    ``shape_mutation=True`` is the seeded violation: alternating rates
    are fed as per-client (N,) targets, which changes the ops' shapes.
    """
    key = key or ConfigKey("dense", "flat", "sync", "uniform", 1)
    device, round_fn, state = _setup(key, n, n_points, dim, device,
                                     ctrl_arg=True)
    calls = []
    for i, rate in enumerate(rates):
        shape = (n,) if shape_mutation and i % 2 else ()
        overrides = {
            "K": torch.tensor(0.2, dtype=torch.float32, device=device),
            "target_rate": torch.full(shape, rate, dtype=torch.float32,
                                      device=device)}
        calls += [(overrides,)] * rounds
    sigs = _signatures(device, round_fn, state, calls)
    violations = _signature_violations(
        key.name, sigs, len(calls),
        "rounds (override values and state must not change the ops)")
    return _result("single-trace", violations,
                   {"signatures": len(sigs), "rounds": len(calls)})


def run_serve_trace_check(key: ConfigKey | None = None, *, n: int = 16,
                          n_points: int = 8, dim: int = 8,
                          ticks: int = 6,
                          shape_mutation: bool = False,
                          device=None) -> RuleResult:
    """Drain a Bernoulli(0.5) arrival trace through the serve step;
    every tick must run one op signature — arrival masks are values.

    ``shape_mutation=True`` is the seeded violation: alternating ticks
    feed the mask as int32 instead of bool.
    """
    key = key or ConfigKey("compact", "flat", "serve", "uniform", 1)
    device, round_fn, state = _setup(key, n, n_points, dim, device,
                                     arrivals_arg=True)
    rng = np.random.default_rng(17)
    calls = []
    for t in range(ticks):
        mask = torch.from_numpy(rng.random(n) < 0.5).to(device)
        if shape_mutation and t % 2:
            mask = mask.to(torch.int32)
        calls.append((mask,))
    sigs = _signatures(device, round_fn, state, calls)
    violations = _signature_violations(
        key.name, sigs, ticks,
        "ticks (arrival masks are values and must not change the ops)")
    return _result("serve-single-trace", violations,
                   {"signatures": len(sigs), "ticks": ticks})


def run_transfer_guard_check(key: ConfigKey | None = None, *,
                             n: int = 16, n_points: int = 8,
                             dim: int = 8, rounds: int = 3,
                             device=None) -> RuleResult:
    """Steady rounds with no sync op.

    The first round runs outside the check; every later one must read
    nothing back (``OpLog.syncs``), and on the card runs under the sync
    debug mode's ``"error"``, which raises on a synchronizing call.
    """
    key = key or ConfigKey("dense", "flat", "sync", "uniform", 1)
    device, round_fn, state = _setup(key, n, n_points, dim, device)
    state, _ = round_fn(state)
    violations = []
    syncs = 0
    try:
        for _ in range(rounds):
            with OpLog(device, profile=False, sync_mode="error") as log:
                state, _metrics = round_fn(state)
            for what, scopes in log.syncs():
                syncs += 1
                violations.append(f"{key.name}: {what} in "
                                  f"{'/'.join(scopes) or 'round'}")
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    except RuntimeError as e:  # the sync debug mode raises RuntimeError
        violations.append(f"{key.name}: sync under the guard: {e}")
    return _result("transfer-guard", violations,
                   {"rounds": rounds, "syncs": syncs})

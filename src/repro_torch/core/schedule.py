"""Rounds as a service: the arrival-driven serve loop
(port of ``repro/core/schedule.py``).

Client updates arrive on a trace (:func:`make_trace`: Poisson, diurnal,
bursty, or the degenerate "everyone every tick"), are admitted into
free capacity slots the tick they arrive through the compact plan and
its deferral queue (overflow waits, nothing is dropped), and the
consensus mean ticks every tick over the freshest z-rows.  The step is
``make_round_fn(..., arrivals_arg=True)``: ``round_fn(state,
arrivals)`` with the tick's (N,) bool arrival mask on the card.

:func:`serve` drains a trace through it and keeps the books of
:class:`ServeReport`: admissions, commits, per-commit latency in ticks
and microseconds, commits per second.  The host's only read per tick is
one copy of the tick's events, committed rows and the two depths
(deferral queue and delay pipeline) — the round itself never waits for
the card.  The traces are numpy (``default_rng`` draws), the
reference's bit for bit.

**Parity anchor.**  With the all-ones trace every tick is a
synchronous round: the step gives the plain round's events and ω bit
for bit (``tests/test_torch_serve.py``).
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from .state import RoundMetrics

TRACE_KINDS = ("sync", "poisson", "diurnal", "bursty")


@dataclasses.dataclass(frozen=True)
class TraceConfig:
    """A (ticks, N) boolean arrival trace: ``sync`` everyone every tick;
    ``poisson`` i.i.d. Bernoulli(rate) per client and tick; ``diurnal``
    Bernoulli at a sinusoidal rate (``period`` ticks, relative
    ``amplitude``); ``bursty`` a quiet Bernoulli(rate·quiet_frac) with a
    ``burst_len``-tick burst at Bernoulli(burst_rate) every
    ``burst_every`` ticks."""

    kind: str = "poisson"
    n_clients: int = 64
    ticks: int = 64
    rate: float = 0.5
    seed: int = 0
    period: int = 24
    amplitude: float = 0.9
    quiet_frac: float = 0.25
    burst_every: int = 16
    burst_len: int = 4
    burst_rate: float = 0.9


def make_trace(cfg: TraceConfig) -> np.ndarray:
    """(ticks, N) bool arrival mask; deterministic per seed."""
    if cfg.kind not in TRACE_KINDS:
        raise ValueError(f"unknown trace kind {cfg.kind!r}; "
                         f"expected one of {TRACE_KINDS}")
    t, n = cfg.ticks, cfg.n_clients
    if cfg.kind == "sync":
        return np.ones((t, n), bool)
    rng = np.random.default_rng(cfg.seed)
    if cfg.kind == "poisson":
        rates = np.full((t,), cfg.rate)
    elif cfg.kind == "diurnal":
        phase = 2.0 * np.pi * np.arange(t) / max(cfg.period, 1)
        rates = cfg.rate * (1.0 + cfg.amplitude * np.sin(phase))
    else:  # bursty
        rates = np.full((t,), cfg.rate * cfg.quiet_frac)
        for start in range(0, t, max(cfg.burst_every, 1)):
            rates[start: start + cfg.burst_len] = cfg.burst_rate
    rates = np.clip(rates, 0.0, 1.0)
    return rng.random((t, n)) < rates[:, None]


def sync_trace(n_clients: int, ticks: int) -> np.ndarray:
    """The degenerate "everyone arrives every tick" parity trace."""
    return make_trace(TraceConfig(kind="sync", n_clients=n_clients,
                                  ticks=ticks))


@dataclasses.dataclass
class ServeReport:
    """What the serve loop saw.  *Admission* is the tick a client's
    arrival fired an event; *commit* the tick its row landed (the same
    tick on the dense synchronous round, later under deferral or
    staleness).  One latency sample per admission→commit pair, the
    earliest admission kept when a pending client fires again.  The
    wall-clock latency runs from the admission tick's dispatch to the
    host's read of the commit tick's results."""

    ticks: int
    n_clients: int
    arrivals_total: int  # Σ trace
    admitted_total: int  # admissions (latency starts)
    commits_total: int  # commits (latency stops)
    pending_final: int  # still queued or in flight at the end
    conservation_ok: bool  # admitted − commits == pending ==
    #                        deferred + in flight (the round's own counts)
    latency_ticks: np.ndarray  # (commits_total,) int
    latency_us: np.ndarray  # (commits_total,) float
    wall_s: float  # the whole trace, host clock
    final_num_deferred: int
    final_num_inflight: int

    @property
    def commits_per_sec(self) -> float:
        return self.commits_total / max(self.wall_s, 1e-12)

    @property
    def ticks_per_sec(self) -> float:
        return self.ticks / max(self.wall_s, 1e-12)

    def percentiles(self, q=(50, 99)) -> dict:
        out: dict = {}
        for name, arr in (("ticks", self.latency_ticks),
                          ("us", self.latency_us)):
            for p in q:
                out[f"p{p}_latency_{name}"] = (float(np.percentile(arr, p))
                                               if arr.size else 0.0)
        return out

    def summary(self) -> dict:
        """A JSON-able digest, the reference's keys."""
        return {
            "ticks": self.ticks,
            "n_clients": self.n_clients,
            "arrivals_total": self.arrivals_total,
            "admitted_total": self.admitted_total,
            "commits_total": self.commits_total,
            "pending_final": self.pending_final,
            "conservation_ok": self.conservation_ok,
            **self.percentiles(),
            "commits_per_sec": self.commits_per_sec,
            "ticks_per_sec": self.ticks_per_sec,
            "wall_s": self.wall_s,
            "final_num_deferred": self.final_num_deferred,
            "final_num_inflight": self.final_num_inflight,
        }


def clone_state(state):
    """A deep copy: every tensor of the state (or of a client mesh's
    shard list) cloned.  The compacted round's fused commit updates its
    input state in place, so a probe step must run on such a copy."""
    if isinstance(state, torch.Tensor):
        return state.clone()
    if isinstance(state, dict):
        return {k: clone_state(v) for k, v in state.items()}
    if isinstance(state, tuple) and hasattr(state, "_fields"):
        return type(state)(*(clone_state(v) for v in state))
    if isinstance(state, (tuple, list)):
        return type(state)(clone_state(v) for v in state)
    return state


def state_device(state) -> torch.device:
    """The device of a state, or of shard 0 of a shard list: where the
    step takes its arrivals."""
    return (state if hasattr(state, "rng") else state[0]).rng.device


def _synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def serve(round_fn, state, trace, *, warmup: bool = False,
          collect_metrics: bool = False):
    """Drain an arrival trace through the serve step.

    ``round_fn`` comes from ``make_round_fn(..., arrivals_arg=True)``;
    ``trace`` is a (ticks, N) bool array.  The trace goes to the state's
    device once, before the clock starts; per tick the host steps the
    round on its row and reads back, in one copy, the tick's events,
    committed rows and the deferral and in-flight depths.

    ``warmup=True`` first steps one all-quiet tick on a deep copy of
    ``state`` (:func:`clone_state`; the fused commit writes its input
    in place) and waits for it, so the latencies leave first-call costs
    out and the served state is not touched.

    Returns ``(state, ServeReport)``, or ``(state, report, history)``
    with ``collect_metrics=True`` (``history``: the ticks'
    ``RoundMetrics``).
    """
    trace = np.asarray(trace, bool)
    ticks, n = trace.shape
    device = state_device(state)
    rows = torch.from_numpy(trace).to(device)
    if warmup and ticks:
        round_fn(clone_state(state), torch.zeros_like(rows[0]))
    _synchronize(device)  # the upload (and the probe) off the clock

    pending_tick = np.full((n,), -1, np.int64)
    pending_wall = np.zeros((n,), np.float64)
    latency_ticks: list = []
    latency_us: list = []
    admitted_total = commits_total = 0
    history: list = []
    final_deferred = final_inflight = 0

    t_begin = time.perf_counter()
    for t in range(ticks):
        t_dispatch = time.perf_counter()
        state, metrics = round_fn(state, rows[t])
        fetched = torch.cat([
            metrics.events.to(torch.int32), metrics.committed.to(
                torch.int32), metrics.num_deferred.reshape(1).to(
                torch.int32), metrics.num_inflight.reshape(1).to(
                torch.int32)]).cpu().numpy()
        t_done = time.perf_counter()
        events = fetched[:n].astype(bool)
        committed = fetched[n:2 * n].astype(bool)
        final_deferred, final_inflight = (int(x) for x in fetched[2 * n:])
        if collect_metrics:
            history.append(metrics)

        # One bit of demand per client: a commit closes the earliest
        # open admission, and a re-fire while pending (or on the tick
        # the commit lands) merges into it, as the deferral queue does.
        was_pending = pending_tick >= 0
        landed = committed & was_pending
        for i in np.nonzero(landed)[0]:
            latency_ticks.append(t - pending_tick[i])
            latency_us.append((t_done - pending_wall[i]) * 1e6)
            pending_tick[i] = -1
        commits_total += int(landed.sum())

        fresh = events & ~was_pending
        admitted_total += int(fresh.sum())
        instant = fresh & committed  # admitted and committed in one tick
        for _ in range(int(instant.sum())):
            latency_ticks.append(0)
            latency_us.append((t_done - t_dispatch) * 1e6)
        commits_total += int(instant.sum())
        opened = fresh & ~instant
        pending_tick[opened] = t
        pending_wall[opened] = t_dispatch
    wall_s = time.perf_counter() - t_begin

    pending_final = int((pending_tick >= 0).sum())
    report = ServeReport(
        ticks=ticks,
        n_clients=n,
        arrivals_total=int(trace.sum()),
        admitted_total=admitted_total,
        commits_total=commits_total,
        pending_final=pending_final,
        conservation_ok=(admitted_total - commits_total == pending_final
                         and pending_final
                         == final_deferred + final_inflight),
        latency_ticks=np.asarray(latency_ticks, np.int64),
        latency_us=np.asarray(latency_us, np.float64),
        wall_s=wall_s,
        final_num_deferred=final_deferred,
        final_num_inflight=final_inflight,
    )
    if collect_metrics:
        return state, report, history
    return state, report


def run_trace(round_fn, state, trace):
    """Step every tick of ``trace`` and stack the metrics (the serve
    counterpart of ``run_rounds``; no latency books, no host read)."""
    rows = torch.from_numpy(np.asarray(trace, bool)).to(state_device(state))
    history = []
    for t in range(rows.shape[0]):
        state, m = round_fn(state, rows[t])
        history.append(m)
    if not history:
        return state, None
    return state, RoundMetrics(*(torch.stack(f)
                                 for f in zip(*history, strict=True)))


__all__ = [
    "TRACE_KINDS",
    "TraceConfig",
    "make_trace",
    "sync_trace",
    "ServeReport",
    "serve",
    "run_trace",
    "clone_state",
]

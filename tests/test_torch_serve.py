"""FL serving over arrival traces (``core/schedule.py``,
``launch/serve_fl.py``, ``make_round_fn(..., arrivals_arg=True)``) of
the port against the reference's.

* ``make_trace``: equal to the reference's for every kind (numpy draws).
* The all-ones trace: the serve step gives the port's synchronous round
  bit for bit (events and ω) — dense, compact with deferral, adaptive,
  compact + fused, compact with staleness, FedAvg — as
  tests/test_serve.py holds the reference (its ragged leg is in
  tests/test_torch_ragged.py).
* The bursty golden configuration (N = 64, 30 ticks, bursts of 3 every
  10) state-synced against live JAX through the serve step
  (``_run_synced(trace=)``), and with the fused commit and
  ``max_staleness=2``.
* ``serve``: the same books (admissions, commits, pending, latency in
  ticks) as the reference's ``serve`` on the same trace, conservation,
  and ``warmup=True`` leaves the state and the books as ``warmup=False``
  (the probe tick runs on a deep copy: the fused commit writes its
  input in place).
* The launcher: ``main(["--device", "cpu", ...])`` end to end.
* The client mesh: the sharded serve step on P = 2 and 4 CPU shards
  against the reference's on forced host devices (the subprocess of
  tests/test_torch_async.py).
"""
import dataclasses
import json

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.core import ControllerConfig as JCtrl
from repro.core import FLConfig as JFLConfig
from repro.core import init_state as jax_init_state
from repro.core import make_flat_spec as jax_make_flat_spec
from repro.core import make_round_fn as jax_make_round_fn
from repro.core import schedule as jschedule
from repro_torch.core import ControllerConfig, FLConfig, init_state, \
    make_round_fn, run_rounds
from repro_torch.core.schedule import TRACE_KINDS, TraceConfig, \
    clone_state, make_trace, run_trace, serve, sync_trace
from repro_torch.data import make_least_squares
from repro_torch.utils import make_flat_spec
from test_torch_async import MESH_LS, check_sharded_case, \
    run_mesh_reference
from test_torch_round import _both, _run_synced, jax_make_least_squares


def _cfg(n, **kw):
    base = dict(algorithm="fedback", n_clients=n, participation=0.5,
                rho=1.0, lr=0.1, momentum=0.0, epochs=2, batch_size=4,
                controller=ControllerConfig(K=0.2, alpha=0.9))
    base.update(kw)
    return FLConfig(**base)


def _problem(n):
    data, params0, ls = make_least_squares(n, 8, 5, device="cpu")
    return data, params0, ls, make_flat_spec(params0)


# --- traces ---------------------------------------------------------------

TRACES = [dict(kind="sync", n_clients=5, ticks=7),
          dict(kind="poisson", n_clients=12, ticks=20, seed=3),
          dict(kind="poisson", n_clients=100, ticks=24, rate=0.1, seed=0),
          dict(kind="diurnal", n_clients=64, ticks=48, rate=0.5, period=24,
               amplitude=0.9, seed=1),
          dict(kind="bursty", n_clients=100, ticks=24, rate=0.1, seed=0,
               burst_every=8, burst_len=2, burst_rate=0.9),
          dict(kind="bursty", n_clients=64, ticks=30, rate=0.25, seed=0,
               burst_every=10, burst_len=3, burst_rate=0.9)]


@pytest.mark.parametrize("kw", TRACES, ids=lambda kw: kw["kind"])
def test_make_trace_equals_reference(kw):
    for seed in (kw.get("seed", 0), 11):
        cfg = dict(kw, seed=seed)
        got = make_trace(TraceConfig(**cfg))
        want = jschedule.make_trace(jschedule.TraceConfig(**cfg))
        assert got.dtype == bool and got.shape == want.shape
        np.testing.assert_array_equal(got, want)


def test_trace_kinds_and_refusal():
    assert TRACE_KINDS == jschedule.TRACE_KINDS
    np.testing.assert_array_equal(sync_trace(5, 7), np.ones((7, 5), bool))
    with pytest.raises(ValueError, match="unknown trace kind"):
        make_trace(TraceConfig(kind="fractal"))


# --- the all-ones trace: the synchronous round -----------------------------

SYNC_PARITY = {
    "dense": _cfg(8),
    "compact_deferral": _cfg(8, compact=True, capacity=3),
    "compact_adaptive": _cfg(16, participation=0.25, compact=True,
                             capacity_slack=1.5,
                             controller=ControllerConfig(K=0.5, alpha=0.9)),
    "compact_fused": _cfg(8, compact=True, capacity=3, fused_gss=True),
    "compact_staleness": _cfg(8, compact=True, capacity=3, max_staleness=2),
    "fedavg": _cfg(8, algorithm="fedavg", rho=0.0),
}


@pytest.mark.parametrize("case", list(SYNC_PARITY))
def test_sync_trace_is_the_synchronous_round(case):
    cfg = SYNC_PARITY[case]
    n = cfg.n_clients
    data, params0, ls, spec = _problem(n)
    serve_fn = make_round_fn(cfg, ls, data, spec=spec, device="cpu",
                             arrivals_arg=True)
    sync_fn = make_round_fn(cfg, ls, data, spec=spec, device="cpu")
    s_serve, m_serve = run_trace(
        serve_fn, init_state(cfg, params0, spec=spec, device="cpu"),
        sync_trace(n, 10))
    s_sync, m_sync = run_rounds(
        sync_fn, init_state(cfg, params0, spec=spec, device="cpu"), 10)
    assert torch.equal(m_serve.events, m_sync.events)
    assert s_serve.omega.numpy().tobytes() == s_sync.omega.numpy().tobytes()
    for f in ("committed", "num_deferred", "num_inflight", "num_landed"):
        assert torch.equal(getattr(m_serve, f), getattr(m_sync, f)), f
    if not cfg.compact and cfg.max_staleness is None:
        assert torch.equal(m_serve.committed, m_serve.events)


# --- state-synced against live JAX ---------------------------------------

GOLDEN_SERVE = dict(algorithm="fedback", n_clients=64, participation=0.25,
                    rho=1.0, lr=0.1, momentum=0.0, epochs=2, batch_size=4,
                    seed=0, compact=True, capacity_slack=1.25)
GOLDEN_TRACE = TraceConfig(kind="bursty", n_clients=64, ticks=30, rate=0.25,
                           seed=0, burst_every=10, burst_len=3,
                           burst_rate=0.9)
SYNCED = {
    # tests/test_serve.py::TestGoldenServeTrace's configuration.
    "golden_bursty": GOLDEN_SERVE,
    # The serve forms' shape: compact + fused under staleness.
    "bursty_fused_s2": dict(GOLDEN_SERVE, fused_gss=True,
                            use_trigger_kernel=True, use_admm_kernel=True,
                            max_staleness=2),
    "bursty_dense_s2": dict(GOLDEN_SERVE, compact=False,
                            use_trigger_kernel=True, use_admm_kernel=True,
                            max_staleness=2),
}


@pytest.mark.parametrize("case", list(SYNCED))
def test_bursty_serve_matches_jax(case):
    kw = SYNCED[case]
    jcfg, tcfg = _both(kw, dict(K=0.5, alpha=0.9))
    jdata, jparams, jls = jax_make_least_squares(64, 8, 5)
    tdata, tparams, tls = make_least_squares(64, 8, 5, device="cpu")
    trace = make_trace(GOLDEN_TRACE)
    seen = _run_synced(jcfg, tcfg, jls, tls, jdata, tdata, jparams, tparams,
                       rounds=30, trace=trace)
    assert seen["flipped_rounds"] == 0 and seen["events"] > 0
    if kw["compact"]:
        assert seen["deferred"] > 0
    if kw.get("max_staleness"):
        assert seen["landed"] > 0 and seen["inflight"] > 0


def _jax_serve(cfg_kw, ctrl_kw, trace, warmup):
    jdata, jparams, jls = jax_make_least_squares(cfg_kw["n_clients"], 8, 5)
    spec = jax_make_flat_spec(jparams)
    jcfg = JFLConfig(controller=JCtrl(**ctrl_kw), **cfg_kw)
    round_fn = jax_make_round_fn(jcfg, jls, jdata, spec=spec,
                                 arrivals_arg=True)
    return jschedule.serve(round_fn, jax_init_state(jcfg, jparams,
                                                    spec=spec),
                           trace, warmup=warmup, collect_metrics=True)


def _torch_serve(cfg_kw, ctrl_kw, trace, warmup):
    data, params0, ls, spec = _problem(cfg_kw["n_clients"])
    cfg = FLConfig(controller=ControllerConfig(**ctrl_kw), **cfg_kw)
    round_fn = make_round_fn(cfg, ls, data, spec=spec, device="cpu",
                             arrivals_arg=True)
    return serve(round_fn, init_state(cfg, params0, spec=spec,
                                      device="cpu"),
                 trace, warmup=warmup, collect_metrics=True)


BOOKS = ("ticks", "n_clients", "arrivals_total", "admitted_total",
         "commits_total", "pending_final", "conservation_ok",
         "final_num_deferred", "final_num_inflight")
SERVE_CASES = {
    "compact_fused_s2_bursty": (
        dict(GOLDEN_SERVE, n_clients=16, fused_gss=True, max_staleness=2),
        dict(kind="bursty", n_clients=16, ticks=12, rate=0.25, seed=4,
             burst_every=5, burst_len=2, burst_rate=0.9)),
    "dense_s1_poisson": (
        dict(GOLDEN_SERVE, n_clients=16, compact=False, max_staleness=1),
        dict(kind="poisson", n_clients=16, ticks=10, rate=0.4, seed=2)),
    "compact_sync_diurnal": (
        dict(GOLDEN_SERVE, n_clients=16),
        dict(kind="diurnal", n_clients=16, ticks=12, rate=0.4, seed=1,
             period=6)),
}


@pytest.mark.parametrize("case", list(SERVE_CASES))
def test_serve_books_match_jax(case):
    cfg_kw, trace_kw = SERVE_CASES[case]
    trace = make_trace(TraceConfig(**trace_kw))
    ctrl = dict(K=0.5, alpha=0.9)
    _, want, whist = _jax_serve(cfg_kw, ctrl, trace, warmup=False)
    state, got, thist = _torch_serve(cfg_kw, ctrl, trace, warmup=False)
    for t, (a, b) in enumerate(zip(thist, whist, strict=True)):
        np.testing.assert_array_equal(a.events.numpy(), np.asarray(b.events),
                                      err_msg=f"tick {t}")
        np.testing.assert_array_equal(a.committed.numpy(),
                                      np.asarray(b.committed))
    for f in BOOKS:
        assert getattr(got, f) == getattr(want, f), f
    assert got.conservation_ok
    np.testing.assert_array_equal(got.latency_ticks, want.latency_ticks)
    assert got.latency_us.shape == want.latency_us.shape
    assert np.all(got.latency_us >= 0)
    assert got.commits_total > 0 and got.latency_ticks.max() > 0
    # warmup=True: the probe runs on a deep copy, so the served state
    # and the books are those of warmup=False.
    state_w, got_w, _ = _torch_serve(cfg_kw, ctrl, trace, warmup=True)
    for f in BOOKS:
        assert getattr(got_w, f) == getattr(got, f), f
    np.testing.assert_array_equal(got_w.latency_ticks, got.latency_ticks)
    for a, b in zip(_tensor_leaves(state_w), _tensor_leaves(state),
                    strict=True):
        assert torch.equal(a, b)
    summary = got.summary()
    assert set(summary) == set(want.summary())
    json.dumps(summary)


def _tensor_leaves(state):
    """Every tensor of a state, in field order."""
    out = []

    def walk(x):
        if isinstance(x, torch.Tensor):
            out.append(x)
        elif isinstance(x, dict):
            for k in sorted(x):
                walk(x[k])
        elif isinstance(x, tuple):
            for v in x:
                walk(v)
    walk(state)
    return out


def test_clone_state_is_deep():
    cfg = _cfg(8, compact=True, capacity=3, fused_gss=True, max_staleness=1)
    data, params0, ls, spec = _problem(8)
    state = init_state(cfg, params0, spec=spec, device="cpu")
    copy = clone_state(state)
    for a, b in zip(_tensor_leaves(copy), _tensor_leaves(state), strict=True):
        assert torch.equal(a, b) and a.data_ptr() != b.data_ptr()
    round_fn = make_round_fn(cfg, ls, data, spec=spec, device="cpu",
                             arrivals_arg=True)
    theta0 = state.theta.clone()
    round_fn(copy, torch.ones(8, dtype=torch.bool))
    assert torch.equal(state.theta, theta0)
    assert not torch.equal(copy.theta, theta0)  # the copy was written


class TestLatencyBookkeeping:
    def test_dense_round_commits_instantly(self):
        cfg_kw = dict(GOLDEN_SERVE, n_clients=8, compact=False)
        trace = make_trace(TraceConfig(kind="poisson", n_clients=8, ticks=8,
                                       rate=0.6, seed=2))
        _, rep, _ = _torch_serve(cfg_kw, dict(K=0.2, alpha=0.9), trace,
                                 warmup=True)
        assert rep.conservation_ok and rep.pending_final == 0
        assert rep.admitted_total == rep.commits_total
        np.testing.assert_array_equal(rep.latency_ticks, 0)

    def test_queued_demand_drains_without_rearrival(self):
        n = 8
        data, params0, ls, spec = _problem(n)
        cfg = _cfg(n, compact=True, capacity=2,
                   controller=ControllerConfig(K=0.2, alpha=0.9,
                                               target_rate=1.0))
        round_fn = make_round_fn(cfg, ls, data, spec=spec, device="cpu",
                                 arrivals_arg=True)
        trace = np.zeros((n, n), bool)
        trace[0] = True
        _, rep = serve(round_fn, init_state(cfg, params0, spec=spec,
                                            device="cpu"), trace,
                       warmup=True)
        assert rep.conservation_ok and rep.pending_final == 0
        assert rep.admitted_total == rep.commits_total == n
        assert rep.latency_ticks.max() > 0
        assert rep.latency_ticks.size == rep.commits_total

    def test_empty_trace(self):
        data, params0, ls, spec = _problem(4)
        cfg = _cfg(4)
        round_fn = make_round_fn(cfg, ls, data, spec=spec, device="cpu",
                                 arrivals_arg=True)
        _, rep = serve(round_fn, init_state(cfg, params0, spec=spec,
                                            device="cpu"),
                       np.zeros((0, 4), bool))
        assert rep.commits_total == rep.admitted_total == 0
        assert rep.conservation_ok
        assert rep.percentiles()["p99_latency_ticks"] == 0.0


class _SharedRounds:
    """One serve step per config, shared across the property examples."""

    _cache: dict = {}

    @classmethod
    def get(cls, compact: bool, staleness):
        key = (compact, staleness)
        if key not in cls._cache:
            data, params0, ls, spec = _problem(12)
            cfg = _cfg(12, participation=0.25, compact=compact,
                       max_staleness=staleness,
                       **({"capacity_slack": 1.25} if compact else {}))
            cls._cache[key] = (cfg, params0, spec, make_round_fn(
                cfg, ls, data, spec=spec, device="cpu", arrivals_arg=True))
        return cls._cache[key]


class TestServeConservation:
    @settings(max_examples=12, deadline=None)
    @given(kind=st.sampled_from(("poisson", "diurnal", "bursty")),
           rate=st.floats(0.05, 0.95), seed=st.integers(0, 2**31 - 1),
           compact=st.booleans(), staleness=st.sampled_from((None, 0, 2)))
    def test_every_trace_conserves_admissions(self, kind, rate, seed,
                                              compact, staleness):
        cfg, params0, spec, round_fn = _SharedRounds.get(compact, staleness)
        trace = make_trace(TraceConfig(kind=kind, n_clients=12, ticks=10,
                                       rate=rate, seed=seed))
        _, rep = serve(round_fn, init_state(cfg, params0, spec=spec,
                                            device="cpu"), trace)
        assert rep.conservation_ok, rep.summary()
        assert rep.admitted_total <= rep.arrivals_total
        assert rep.pending_final \
            == rep.final_num_deferred + rep.final_num_inflight
        assert rep.latency_ticks.size == rep.commits_total
        assert rep.latency_ticks.min(initial=0) >= 0


# --- the launcher -------------------------------------------------------

def test_launcher_runs_on_the_cpu(tmp_path, capsys):
    from repro_torch.launch.serve_fl import build_serve_problem, main
    out = tmp_path / "serve.json"
    rc = main(["--device", "cpu", "--trace", "bursty", "--n-clients", "16",
               "--ticks", "8", "--dim", "4", "--max-staleness", "2",
               "--json", str(out)])
    assert rc == 0
    blob = json.loads(out.read_text())["serve_bursty"]
    assert blob["conservation_ok"] is True and blob["ticks"] == 8
    assert "device=cpu" in capsys.readouterr().out
    cfg, _, state = build_serve_problem(8, dim=4, device="cpu",
                                        max_staleness=1)
    assert cfg.max_staleness == 1 and state.inflight is not None
    assert state.theta.device.type == "cpu"


def test_serving_modules_leave_jax_out():
    import os
    import subprocess
    import sys
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = ("import sys, repro_torch.core.schedule, "
            "repro_torch.launch.serve_fl, repro_torch.configs.paper_mnist; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')]; print(bad); sys.exit(bool(bad))")
    env = dict(os.environ, PYTHONPATH=os.path.join(root, "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_launcher_defaults_to_the_card(monkeypatch):
    from repro_torch.launch.serve_fl import main
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        main(["--n-clients", "4", "--ticks", "2"])


# --- the client mesh ----------------------------------------------------

MESH_SERVE = {
    # name: (P, FLConfig keywords, trace)
    "serve_compact_fused_s2_p2": (
        2, dict(compact=True, fused_gss=True, participation=0.25,
                capacity_slack=1.5),
        dict(kind="bursty", n_clients=8, ticks=5, rate=0.5, seed=0,
             burst_every=4, burst_len=2)),
    "serve_compact_s2_p4": (
        4, dict(compact=True, participation=0.25, capacity_slack=1.5),
        dict(kind="bursty", n_clients=8, ticks=5, rate=0.5, seed=1,
             burst_every=4, burst_len=2)),
    "serve_dense_sync_p2": (
        2, dict(max_staleness=None),
        dict(kind="poisson", n_clients=8, ticks=5, rate=0.6, seed=2)),
}


@pytest.fixture(scope="module")
def mesh_reference(tmp_path_factory):
    return run_mesh_reference(tmp_path_factory.mktemp("serve_mesh"),
                              MESH_SERVE, MESH_LS, 5)


@pytest.mark.parametrize("case", list(MESH_SERVE))
def test_sharded_serve_step_matches_jax(case, mesh_reference):
    p, kw, _ = MESH_SERVE[case]
    seen = check_sharded_case(p, kw, mesh_reference[case], MESH_LS)
    assert seen["events"] > 0
    if dict(MESH_LS, **kw)["max_staleness"] is not None:
        assert seen["landed"] > 0


def test_sharded_serve_conserves():
    from repro_torch.sharding import make_client_mesh
    cfg = dataclasses.replace(_cfg(8, compact=True, participation=0.25,
                                   capacity_slack=1.5), max_staleness=2)
    data, params0, ls, spec = _problem(8)
    mesh = make_client_mesh(2, ["cpu"])
    round_fn = make_round_fn(cfg, ls, data, spec=spec, mesh=mesh,
                             arrivals_arg=True)
    trace = make_trace(TraceConfig(kind="bursty", n_clients=8, ticks=8,
                                   rate=0.5, seed=0, burst_every=4,
                                   burst_len=2))
    state, rep = serve(round_fn, init_state(cfg, params0, spec=spec,
                                            mesh=mesh), trace, warmup=True)
    assert len(state) == 2 and rep.conservation_ok
    assert rep.commits_total > 0

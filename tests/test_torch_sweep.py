"""The port's sweep runner (``repro_torch.launch.sweep``) and its runtime
controller overrides, against the JAX package's ``repro.launch.sweep``.

* ``SweepGrid.runs`` and ``init_sweep``'s stacked states and overrides
  equal the reference's, bit for bit; so does the reference's stacked
  state carried across by ``convert.state_from_numpy(runs=True)``, on
  one device and cut over 2 CPU shards.
* The port's sweep is bit-equal to the port's runs stepped alone, each
  with the run's seed, K and L̄ in its config, on the dense and the
  compact round, both layouts, with ``max_staleness``, int8 consensus,
  ragged clients and a client mesh of 2 CPU shards.
* Against the reference's ``run_sweep`` on the quadratic problem of
  tests/test_sharded_engine.py, free-running 10 rounds: events equal
  except clients within ``_run_synced``'s 1e-5 margin of their
  threshold, ω at the reference's own rtol 1e-5 / atol 1e-6.
* The gain grid orders the realized rates as the reference's test does.
* ``ctrl_overrides`` on every selection against the reference's
  ``measure`` under ``jax.jit`` with traced scalars: δ and the load
  within one ulp (XLA contracts δ + K·(L − L̄) and the low-pass filter
  into FMAs, ROADMAP D1), with and without the staleness clamp.
* The CLI with ``--device cpu`` (also ``--state-backend host``) prints
  the reference's header and its rows.
"""
import dataclasses
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import ControllerConfig as JCtrl
from repro.core import FLConfig as JFLConfig
from repro.core import make_flat_spec as jax_make_flat_spec
from repro.core.selection import make_selection as jax_make_selection
from repro.data import make_least_squares as jax_make_least_squares
from repro.launch import sweep as jax_sweep
from repro_torch.convert import state_from_numpy, state_to_numpy
from repro_torch.core import ControllerConfig, FLConfig, init_state, \
    make_round_fn, make_selection, pool_data
from repro_torch.core.controller import ControllerState
from repro_torch.data import make_least_squares
from repro_torch.launch import sweep
from repro_torch.sharding import make_client_mesh
from repro_torch.utils import make_flat_spec
from test_torch_round import _margin_clients

N = 8
BASE = dict(algorithm="fedback", n_clients=N, participation=0.5, rho=1.0,
            lr=0.1, momentum=0.0, epochs=2, batch_size=4)


def _cfg(K=0.2, **kw):
    return FLConfig(**{**BASE, **kw},
                    controller=ControllerConfig(K=K, alpha=0.9))


def _jcfg(K=0.2, **kw):
    return JFLConfig(**{**BASE, **kw}, controller=JCtrl(K=K, alpha=0.9))


def _problem():
    return make_least_squares(N, 8, 5, device="cpu")


def _leaves(s):
    """Every leaf of an FLState with numpy leaves, by field path."""
    out = {}
    for f in s._fields:
        v = getattr(s, f)
        if v is None:
            continue
        if isinstance(v, tuple):
            out.update({f"{f}.{k}": x for k, x in v._asdict().items()})
        elif isinstance(v, dict):
            out.update({f"{f}.{k}": x for k, x in v.items()})
        else:
            out[f] = v
    return out


def _assert_states_equal(a, b):
    la, lb = _leaves(state_to_numpy(a)), _leaves(state_to_numpy(b))
    assert la.keys() == lb.keys()
    for k in la:
        assert la[k].tobytes() == lb[k].tobytes(), k


def _run_alone(cfg, seed, k, t, loss, data, params0, spec, rounds,
               ragged=None, **where):
    """One run configured with its seed, K and L̄ (another L̄ than
    ``cfg.participation`` as a 0-d fp32 target, so that the plan's
    participation stays)."""
    ctrl = cfg.controller._replace(K=k)
    if t != cfg.participation:
        ctrl = ctrl._replace(target_rate=torch.tensor(t))
    rcfg = dataclasses.replace(cfg, seed=seed, controller=ctrl)
    state = init_state(rcfg, params0, spec=spec, **where)
    round_fn = make_round_fn(rcfg, loss, data, spec=spec, ragged=ragged,
                             **where)
    history = []
    for _ in range(rounds):
        state, m = round_fn(state)
        history.append(m)
    return state, history


def test_grid_and_init_sweep_match_the_reference():
    cfg, jcfg = _cfg(), _jcfg()
    for seeds, gains, rates in (((0, 1, 2, 3), None, None),
                                ((0, 3), (0.5, 2.0), None),
                                ((1,), (0.05, 5.0), (0.1, 0.2))):
        grid = sweep.SweepGrid(seeds, gains, rates)
        jgrid = jax_sweep.SweepGrid(seeds, gains, rates)
        assert grid.runs(cfg) == jgrid.runs(jcfg)
    data, params0, _ = _problem()
    jdata, jparams, _ = jax_make_least_squares(N, 8, 5)
    grid = sweep.SweepGrid((0, 3), (0.5, 2.0), (0.25,))
    jgrid = jax_sweep.SweepGrid((0, 3), (0.5, 2.0), (0.25,))
    for kw, layout in ((dict(), "tree"),
                       (dict(compact=True, max_staleness=2,
                             consensus_compress="int8"), "flat")):
        spec = make_flat_spec(params0) if layout == "flat" else None
        jspec = jax_make_flat_spec(jparams) if layout == "flat" else None
        states, over, runs = sweep.init_sweep(_cfg(**kw), params0, grid,
                                              spec=spec, device="cpu")
        jstates, jover, jruns = jax_sweep.init_sweep(_jcfg(**kw), jparams,
                                                     jgrid, spec=jspec)
        assert runs == jruns
        for k in ("K", "target_rate"):
            assert over[k].dtype == torch.float32
            assert over[k].numpy().tobytes() == np.asarray(
                jover[k]).tobytes()
        want = _leaves(jax.device_get(jstates))
        # The reference's stacked state carried across, whole and cut
        # over a client mesh's shards (the client axis second).
        mesh = make_client_mesh(2, ["cpu"])
        sharded, _, _ = sweep.init_sweep(_cfg(**kw), params0, grid,
                                         spec=spec, mesh=mesh)
        carried = state_from_numpy(jax.device_get(jstates), mesh=mesh,
                                   runs=True)
        for s in (states, state_from_numpy(jax.device_get(jstates),
                                           device="cpu")):
            _assert_leaves_match(_leaves(state_to_numpy(s)), want)
        for s in (sharded, carried):
            assert len(s) == 2 and s[0].ctrl.delta.shape == (len(runs), N // 2)
            _assert_leaves_match(_leaves(state_to_numpy(s, runs=True)), want)


def _assert_leaves_match(got, want):
    assert got.keys() == want.keys()
    for k, v in got.items():
        w = np.asarray(want[k])
        assert v.shape == w.shape and v.tobytes() == w.astype(
            v.dtype).tobytes(), k


SETTINGS = {
    "dense_flat": (dict(), "flat"),
    "compact_fused_flat": (dict(compact=True, fused_gss=True), "flat"),
    "dense_tree": (dict(), "tree"),
    "compact_tree": (dict(compact=True), "tree"),
    "stale_compact_fused": (dict(compact=True, fused_gss=True,
                                 max_staleness=2), "flat"),
    "int8_dense": (dict(consensus_compress="int8"), "flat"),
    "ragged_compact": (dict(compact=True), "ragged"),
    "ragged_dense": (dict(), "ragged"),
    "mesh2_compact_fused": (dict(compact=True, fused_gss=True), "mesh"),
    "mesh2_dense_stale": (dict(max_staleness=1), "mesh"),
}


@pytest.mark.parametrize("setting", list(SETTINGS))
def test_sweep_is_bit_equal_to_the_runs_alone(setting):
    kw, layout = SETTINGS[setting]
    data, params0, loss = _problem()
    spec = None if layout == "tree" else make_flat_spec(params0)
    ragged = None
    if layout == "ragged":
        sizes = np.random.default_rng(1).integers(4, 9, size=N)
        data, ragged = pool_data(
            [data["x"][i][:s] for i, s in enumerate(sizes)],
            [data["y"][i][:s] for i, s in enumerate(sizes)], device="cpu")
    where = ({"mesh": make_client_mesh(2, ["cpu"])} if layout == "mesh"
             else {"device": "cpu"})
    rates = (0.5, 0.25)
    cfg, rounds = _cfg(**kw), 5
    runs, final, hist = sweep.run_sweep(
        cfg, loss, data, params0, rounds=rounds, seeds=(0, 3),
        gains=(0.2, 2.0), target_rates=rates, spec=spec, ragged=ragged,
        **where)
    n_runs = 4 * len(rates)
    assert len(runs) == n_runs
    assert tuple(hist.events.shape) == (rounds, n_runs, N)
    for r, (seed, k, t) in enumerate(runs):
        alone, history = _run_alone(cfg, seed, k, t, loss, data, params0,
                                    spec, rounds, ragged=ragged, **where)
        for i, m in enumerate(history):
            for f in m._fields:
                assert torch.equal(getattr(hist, f)[i, r], getattr(m, f)), \
                    (r, i, f)
        _assert_states_equal(sweep._run(final, r), alone)


def test_sweep_matches_the_reference_run_sweep():
    """The quadratic problem of tests/test_sharded_engine.py, tree
    layout, seeds (0, 3) × gains (0.2, 2.0), 10 rounds free-running."""
    rounds = 10
    jdata, jparams, jloss = jax_make_least_squares(N, 8, 5)
    data, params0, loss = _problem()
    jruns, jfinal, jhist = jax_sweep.run_sweep(
        _jcfg(), jloss, jdata, jparams, rounds=rounds, seeds=(0, 3),
        gains=(0.2, 2.0))
    runs, final, hist = sweep.run_sweep(
        _cfg(), loss, data, params0, rounds=rounds, seeds=(0, 3),
        gains=(0.2, 2.0), device="cpu")
    assert runs == jruns
    jhist = jax.device_get(jhist)
    delta0 = np.zeros((len(runs), N), np.float32)
    for i in range(rounds):
        before = delta0 if i == 0 else np.asarray(jhist.delta[i - 1])
        margin = _margin_clients(np.asarray(jhist.distances[i]), before)
        got, want = hist.events[i].numpy(), np.asarray(jhist.events[i])
        np.testing.assert_array_equal(got[~margin], want[~margin])
        assert not (got != want).any(), f"a margin client flipped, round {i}"
    np.testing.assert_allclose(final.omega["theta"].numpy(),
                               np.asarray(jfinal.omega["theta"]),
                               rtol=1e-5, atol=1e-6)


def test_gain_grid_changes_dynamics():
    """tests/test_sharded_engine.py::test_gain_grid_changes_dynamics_
    without_retrace: the high-gain run throttles harder toward L̄ =
    0.2."""
    data, params0, loss = _problem()
    cfg = FLConfig(**{**BASE, "participation": 0.2, "epochs": 1,
                      "batch_size": 8},
                   controller=ControllerConfig(K=0.1, alpha=0.9))
    states, overrides, runs = sweep.init_sweep(
        cfg, params0, sweep.SweepGrid(seeds=(0,), gains=(0.05, 5.0)),
        device="cpu")
    _, hist = sweep.make_sweep_fn(cfg, loss, data, rounds=30,
                                  device="cpu")(states, overrides)
    rates = hist.events.to(torch.float32).mean(dim=(0, 2))
    assert float(rates[1]) < float(rates[0]) - 0.05, rates


def test_sweep_threads_ragged_like_the_reference():
    """tests/test_ragged.py::TestRaggedSweep: the pool read by every
    run, history (6, 2, N), finite losses."""
    sizes = np.random.default_rng(1).integers(4, 9, size=N)
    data, params0, loss = _problem()
    pooled, rspec = pool_data(
        [data["x"][i][:s] for i, s in enumerate(sizes)],
        [data["y"][i][:s] for i, s in enumerate(sizes)], device="cpu")
    cfg = _cfg(compact=True, capacity_slack=1.5)
    runs, final, hist = sweep.run_sweep(
        cfg, loss, pooled, params0, rounds=6, seeds=(0, 1),
        spec=make_flat_spec(params0), ragged=rspec, device="cpu")
    assert tuple(hist.events.shape) == (6, 2, N)
    assert bool(torch.isfinite(hist.train_loss).all())


SELECTIONS = ("fedback", "random", "bernoulli", "full", "round_robin")


@pytest.mark.parametrize("name", SELECTIONS)
@pytest.mark.parametrize("stale", [False, True])
def test_ctrl_overrides_match_the_reference_measure(name, stale):
    rng = np.random.default_rng(7)
    n = 16
    delta = rng.normal(size=n).astype(np.float32)
    load = rng.random(n).astype(np.float32)
    count = rng.integers(0, 5, n).astype(np.int32)
    events = rng.random(n) < 0.4
    delay = (np.arange(n) % 3).astype(np.int32)
    ctrl_kw = dict(K=2.0, alpha=0.9, target_rate=0.1)
    over = {"K": np.float32(0.7), "target_rate": np.float32(0.3)}

    jsel = jax_make_selection(name, rate=0.25, controller=JCtrl(**ctrl_kw))
    from repro.core.controller import ControllerState as JState

    @jax.jit
    def jmeasure(d, ld, c, ev, K, t, dl):
        st = JState(delta=d, load=ld, round=jnp.int32(3), event_count=c)
        return jsel.measure(st, ev, {"K": K, "target_rate": t},
                            staleness_delay=dl if stale else None)

    want = jax.device_get(jmeasure(delta, load, count, events, over["K"],
                                   over["target_rate"], delay))
    sel = make_selection(name, rate=0.25, controller=ControllerConfig(
        **ctrl_kw))
    t = torch.from_numpy
    got = sel.measure(
        ControllerState(delta=t(delta), load=t(load),
                        round=torch.tensor(3, dtype=torch.int32),
                        event_count=t(count)), t(events),
        {k: torch.tensor(v) for k, v in over.items()},
        staleness_delay=t(delay) if stale else None)
    for f in ("delta", "load"):
        a, b = getattr(got, f).numpy(), np.asarray(getattr(want, f))
        assert np.all(np.abs(a - b) <= np.spacing(np.maximum(
            np.abs(a), np.abs(b)))), (f, a, b)
    assert got.event_count.numpy().tolist() == np.asarray(
        want.event_count).tolist()


CLI = ["--n-clients", "16", "--seeds", "0,1", "--gains", "0.5,2.0",
       "--rounds", "5"]


@pytest.mark.parametrize("extra", [[], ["--compact", "--state-backend",
                                        "host"]])
def test_cli_prints_the_reference_rows(extra, capsys, monkeypatch):
    sweep.main(CLI + extra + ["--device", "cpu"])
    mine = capsys.readouterr().out.strip().splitlines()
    monkeypatch.setattr(sys, "argv", ["sweep"] + CLI + extra)
    jax_sweep.main()
    ref = capsys.readouterr().out.strip().splitlines()
    assert mine[0] == ref[0] == sweep.HEADER
    assert len(mine) == len(ref) == 5
    for a, b in zip(mine[1:], ref[1:], strict=True):
        a, b = a.split(","), b.split(",")
        assert a[:7] == b[:7], (a, b)  # up to the final loss
        assert abs(float(a[7]) - float(b[7])) <= 1e-4 * abs(float(b[7]))

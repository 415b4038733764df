"""The stale-tolerant round (``max_staleness``) of the port against the
reference's.

* ``prng.fold_in`` / ``prng.randint`` and ``delay_schedule`` (both
  kinds): bit-equal to ``jax.random`` and the reference's schedule.
* ``feasible_rate`` / ``clamp_target_rate``: bit-equal, and the clamp is
  the identity at δ ≡ 0.
* The mask algebra (``staleness_masks``, ``staleness_commit``,
  ``record_issue``, ``measured_commits``): equal to the reference's on
  random inputs, and its conservation laws under hypothesis, as
  tests/test_async.py holds the reference's.
* Zero staleness: ``max_staleness=0`` gives the port's synchronous round
  bit for bit (events and ω) — dense flat and tree, compact with
  deferral, adaptive, compact + fused, FedAvg.
* The pipeline's mechanics: a delayed solve lands exactly δ rounds
  later, an in-flight client cannot fire, the controller measures at
  commit time.
* State-synced against live JAX (``tests/test_torch_round.py``'s
  ``_run_synced``: each round from the reference's state; events,
  ``committed``, the in-flight and landed counts, the delays,
  countdowns, event ring and queue equal, the state and the parked
  payloads at rtol 1e-4 / atol 1e-6): the golden "async_s2"
  configuration over 30 rounds, the same with the fused commit (which
  writes the state in place: the serviced δ > 0 rows must come back),
  and dense, tree-layout, uniform-schedule and FedAvg variants.
* The client mesh: the port's sharded stale-tolerant round on P = 2 and
  4 CPU shards against the reference's on forced host devices (one
  subprocess; ``XLA_FLAGS`` is set before ``jax`` is imported), as
  tests/test_torch_sharded_round.py does for the synchronous round.
"""
import dataclasses
import json
import os
import pickle
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.core import controller as jcontroller
from repro.core import engine as jengine
from repro.core.state import delay_schedule as jax_delay_schedule
from repro_torch import prng
from repro_torch.convert import state_from_numpy, state_to_numpy
from repro_torch.core import ControllerConfig, FLConfig, init_state, \
    make_round_fn, run_rounds
from repro_torch.core import controller, engine
from repro_torch.core.state import delay_schedule
from repro_torch.data import make_least_squares
from repro_torch.sharding import make_client_mesh
from repro_torch.utils import make_flat_spec
from repro_torch.utils.pytree import tree_leaves
from test_torch_round import _both, _mlp_problem, _run_synced, \
    jax_make_least_squares, jax_make_loss_fn, jax_mlp_logits, \
    make_loss_fn, nest_params, params_from_numpy

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEEDS = [0, 7, 2024, 2 ** 31 - 1]


# --- the PRNG twin and the delay schedule --------------------------------

@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("data", [0, 1, 0x5A1E, 2 ** 32 - 1])
def test_fold_in_bit_equal(seed, data):
    want = np.asarray(jax.random.fold_in(jax.random.PRNGKey(seed), data),
                      np.int64)
    got = prng.fold_in(prng.PRNGKey(seed, device="cpu"), data)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("n", [1, 7, 64, 100])
def test_randint_bit_equal(seed, n):
    key = jax.random.PRNGKey(seed)
    tkey = prng.PRNGKey(seed, device="cpu")
    for lo, hi in [(0, s) for s in range(1, 6)] + [(-3, 2), (5, 5),
                                                    (10, 3), (0, 100000)]:
        want = np.asarray(jax.random.randint(key, (n,), lo, hi, jnp.int32))
        got = prng.randint(tkey, (n,), lo, hi)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want, err_msg=(lo, hi))


@pytest.mark.parametrize("kind", ["roundrobin", "uniform"])
@pytest.mark.parametrize("n,s", [(9, 2), (64, 3), (100, 2), (5, 0)])
def test_delay_schedule_equal_to_reference(kind, n, s):
    for seed in (0, 7, 8):
        want = np.asarray(jax_delay_schedule(n, s, kind=kind, seed=seed))
        got = delay_schedule(n, s, kind=kind, seed=seed, device="cpu")
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)


def test_delay_schedule_refusals(monkeypatch):
    with pytest.raises(ValueError, match="max_staleness"):
        delay_schedule(4, -1, device="cpu")
    with pytest.raises(ValueError, match="unknown delay schedule"):
        delay_schedule(4, 1, kind="zipf", device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        delay_schedule(4, 1)  # the card by default, never the CPU


def test_feasible_rate_clamp_bit_equal():
    d = np.array([0, 1, 2, 3, 0, 7], np.int32)
    for target in (0.1, 0.4, 1.0, np.linspace(0.05, 0.9, 6,
                                              dtype=np.float32)):
        want = np.asarray(jcontroller.clamp_target_rate(
            jnp.asarray(target), jnp.asarray(d)))
        t = torch.from_numpy(target) if isinstance(target, np.ndarray) \
            else target
        got = controller.clamp_target_rate(t, torch.from_numpy(d))
        assert got.dtype == torch.float32 and got.shape == (6,)
        assert got.numpy().tobytes() == want.astype(np.float32).tobytes()
    np.testing.assert_array_equal(
        controller.feasible_rate(torch.from_numpy(d)).numpy(),
        np.asarray(jcontroller.feasible_rate(jnp.asarray(d))))
    # δ ≡ 0: the target itself, bit for bit.
    got = controller.clamp_target_rate(0.1, torch.zeros(5, dtype=torch.int32))
    assert got.numpy().tobytes() == np.full(5, 0.1, np.float32).tobytes()


# --- the mask algebra ----------------------------------------------------

@pytest.mark.parametrize("seed", range(4))
def test_mask_algebra_equal_to_reference(seed):
    rng = np.random.default_rng(seed)
    n, s = 12, 3
    delay = rng.integers(0, s + 1, n).astype(np.int32)
    ttl = np.where(rng.random(n) < 0.5, rng.integers(0, s + 1, n),
                   0).astype(np.int32)
    serviced = (rng.random(n) < 0.6) & (ttl == 0)
    want = jengine.staleness_masks(jnp.asarray(serviced), jnp.asarray(delay),
                                   jnp.asarray(ttl))
    got = engine.staleness_masks(torch.from_numpy(serviced),
                                 torch.from_numpy(delay),
                                 torch.from_numpy(ttl))
    for g, w in zip(got, want, strict=True):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    land, direct, defer = (np.array(x) for x in want[:3])
    cur, prop, park = (rng.normal(size=(n, 5)).astype(np.float32)
                       for _ in range(3))
    wc, wp = jengine.staleness_commit(cur, prop, park, land, direct, defer)
    gc, gp = engine.staleness_commit(*(torch.from_numpy(x) for x in (
        cur, prop, park, land, direct, defer)))
    np.testing.assert_array_equal(gc.numpy(), np.asarray(wc))
    np.testing.assert_array_equal(gp.numpy(), np.asarray(wp))
    hist = rng.random((n, s + 1)) < 0.5
    for rnd in (0, 5, 11):
        wh = jengine.record_issue(jnp.asarray(hist), jnp.asarray(serviced),
                                  jnp.asarray(rnd, jnp.int32))
        gh = engine.record_issue(torch.from_numpy(hist),
                                 torch.from_numpy(serviced),
                                 torch.tensor(rnd, dtype=torch.int32))
        np.testing.assert_array_equal(gh.numpy(), np.asarray(wh))
        np.testing.assert_array_equal(
            engine.measured_commits(gh, torch.from_numpy(delay),
                                    torch.tensor(rnd,
                                                 dtype=torch.int32)).numpy(),
            np.asarray(jengine.measured_commits(wh, jnp.asarray(delay),
                                                jnp.asarray(rnd,
                                                            jnp.int32))))


def test_slot_commit_equals_the_full_width_commit():
    """``staleness_commit_slots`` on a state whose planned rows already
    hold their proposals gives ``staleness_commit``'s bits."""
    rng = np.random.default_rng(3)
    n, d, c = 10, 7, 4
    delay = torch.from_numpy(rng.integers(0, 3, n).astype(np.int32))
    ttl = torch.from_numpy(np.array([0, 1, 0, 2, 0, 0, 1, 0, 0, 0],
                                    np.int32))
    idx = torch.tensor([2, 5, 0, 9], dtype=torch.int32)
    valid = torch.tensor([True, True, True, False])
    serviced = torch.zeros(n, dtype=torch.bool)
    serviced[idx[valid].long()] = True
    land, direct, defer, _ = engine.staleness_masks(serviced, delay, ttl)
    current = torch.from_numpy(rng.normal(size=(n, d)).astype(np.float32))
    parked = torch.from_numpy(rng.normal(size=(n, d)).astype(np.float32))
    solved = torch.from_numpy(rng.normal(size=(c, d)).astype(np.float32))
    proposed = current.clone()
    rows = idx.long()
    proposed[rows] = torch.where(valid[:, None], solved, current[rows])
    want_c, want_p = engine.staleness_commit(current, proposed, parked, land,
                                             direct, defer)
    live, park = proposed.clone(), parked.clone()
    got_c, got_p = engine.staleness_commit_slots(
        live, park, current[rows], idx, valid, land, defer)
    assert got_c is live and got_p is park  # in place
    assert torch.equal(got_c, want_c) and torch.equal(got_p, want_p)
    assert bool(defer.any() and land.any() and direct.any())


class TestInflightConservation:
    """tests/test_async.py::TestInflightConservation on the port's
    algebra: issued − committed = in flight at every round, nothing
    lost or duplicated, and the ring is the issue stream delayed by
    exactly δ_i."""

    @settings(max_examples=20, deadline=None)
    @given(n=st.integers(2, 24), max_staleness=st.integers(0, 4),
           fire_p=st.floats(0.0, 1.0), seed=st.integers(0, 2**31 - 1))
    def test_mask_algebra_conserves_work(self, n, max_staleness, fire_p,
                                         seed):
        rng = np.random.default_rng(seed)
        delay = delay_schedule(n, max_staleness, kind="uniform",
                               seed=seed % 1000, device="cpu")
        ttl = torch.zeros(n, dtype=torch.int32)
        hist = torch.zeros((n, max_staleness + 1), dtype=torch.bool)
        issued = np.zeros(n, np.int64)
        committed = np.zeros(n, np.int64)
        for rnd in range(3 * (max_staleness + 1) + 4):
            eligible = ttl.numpy() == 0
            events = (rng.random(n) < fire_p) & eligible
            land, direct, defer, ttl = engine.staleness_masks(
                torch.from_numpy(events), delay, ttl)
            land, direct, defer = (x.numpy() for x in (land, direct, defer))
            assert not np.any(land & (direct | defer))
            hist = engine.record_issue(hist, torch.from_numpy(events),
                                       torch.tensor(rnd, dtype=torch.int32))
            issued += events
            committed += direct | land
            assert int(issued.sum()) - int(committed.sum()) \
                == int((ttl > 0).sum())
        for _ in range(max_staleness + 1):
            land, _, _, ttl = engine.staleness_masks(
                torch.zeros(n, dtype=torch.bool), delay, ttl)
            committed += land.numpy()
        assert int(ttl.max()) == 0
        np.testing.assert_array_equal(issued, committed)

    @settings(max_examples=15, deadline=None)
    @given(n=st.integers(2, 16), max_staleness=st.integers(0, 3),
           seed=st.integers(0, 2**31 - 1))
    def test_measurement_is_delayed_issue_stream(self, n, max_staleness,
                                                 seed):
        rng = np.random.default_rng(seed)
        delay = rng.integers(0, max_staleness + 1, n).astype(np.int32)
        hist = torch.zeros((n, max_staleness + 1), dtype=torch.bool)
        stream, measured = [], []
        for rnd in range(4 * (max_staleness + 1)):
            events = rng.random(n) < 0.5
            stream.append(events)
            rnd_t = torch.tensor(rnd, dtype=torch.int32)
            hist = engine.record_issue(hist, torch.from_numpy(events), rnd_t)
            measured.append(engine.measured_commits(
                hist, torch.from_numpy(delay), rnd_t).numpy())
        stream, measured = np.asarray(stream), np.asarray(measured)
        for i in range(n):
            d = int(delay[i])
            expect = np.concatenate([np.zeros(d, bool), stream[:, i]])
            np.testing.assert_array_equal(measured[:, i],
                                          expect[:len(measured)])


# --- zero staleness: the synchronous round, bit for bit ---------------------

def _cfg(n, **kw):
    base = dict(algorithm="fedback", n_clients=n, participation=0.5,
                rho=1.0, lr=0.1, momentum=0.0, epochs=2, batch_size=4,
                controller=ControllerConfig(K=0.2, alpha=0.9))
    base.update(kw)
    return FLConfig(**base)


def _run(cfg, *, flat=True, rounds=10, state_fn=None):
    data, params0, ls = make_least_squares(cfg.n_clients, 8, 5,
                                           device="cpu")
    spec = make_flat_spec(params0) if flat else None
    state = init_state(cfg, params0, spec=spec, device="cpu")
    if state_fn is not None:
        state = state_fn(state)
    round_fn = make_round_fn(cfg, ls, data, spec=spec, device="cpu")
    return (state, round_fn) if rounds is None else run_rounds(
        round_fn, state, rounds)


ZERO_STALENESS = {
    "dense_flat": (_cfg(8), True, 10),
    "dense_tree": (_cfg(6), False, 10),
    "compact_deferral": (_cfg(8, compact=True, capacity=3), True, 10),
    "compact_adaptive": (_cfg(16, participation=0.25, compact=True,
                              capacity_slack=1.5,
                              controller=ControllerConfig(K=0.5, alpha=0.9)),
                         True, 15),
    "compact_fused": (_cfg(8, compact=True, capacity=3, fused_gss=True),
                      True, 10),
    "fedavg": (_cfg(8, algorithm="fedavg", rho=0.0), True, 10),
}


@pytest.mark.parametrize("case", list(ZERO_STALENESS))
def test_zero_staleness_is_the_synchronous_round(case):
    cfg, flat, rounds = ZERO_STALENESS[case]
    s_sync, h_sync = _run(cfg, flat=flat, rounds=rounds)
    s_async, h_async = _run(dataclasses.replace(cfg, max_staleness=0),
                            flat=flat, rounds=rounds)
    assert s_sync.inflight is None and s_async.inflight is not None
    assert torch.equal(h_sync.events, h_async.events)
    for a, b in zip(tree_leaves(s_sync.omega), tree_leaves(s_async.omega),
                    strict=True):
        assert a.numpy().tobytes() == b.numpy().tobytes()
    for f in ("num_deferred", "realized_capacity", "committed"):
        assert torch.equal(getattr(h_sync, f), getattr(h_async, f)), f
    assert not h_async.num_inflight.any() and not h_async.num_landed.any()
    assert not h_sync.num_inflight.any() and not h_sync.num_landed.any()


# --- the pipeline's mechanics ---------------------------------------------

def _pin(state, delay=None, delta=None):
    fl = state.inflight
    if delay is not None:
        fl = fl._replace(delay=torch.tensor(delay, dtype=torch.int32))
    ctrl = state.ctrl
    if delta is not None:
        ctrl = ctrl._replace(delta=torch.tensor(delta, dtype=torch.float32))
    return state._replace(inflight=fl, ctrl=ctrl)


def test_delayed_solve_lands_exactly_delta_rounds_later():
    state, round_fn = _run(_cfg(4, max_staleness=2), rounds=None,
                           state_fn=lambda s: _pin(s, [2, 0, 0, 0],
                                                   [-1.0, 1e9, 1e9, 1e9]))
    th0 = state.theta.clone()
    state, m = round_fn(state)  # serviced: parks, commits nothing
    assert int(m.num_events) == 1 and int(m.num_inflight) == 1
    assert int(m.num_landed) == 0 and torch.equal(state.theta, th0)
    state = _pin(state, delta=[1e9] * 4)
    state, m = round_fn(state)
    assert (int(m.num_inflight), int(m.num_landed)) == (1, 0)
    assert torch.equal(state.theta, th0)
    state, m = round_fn(state)  # lands now
    assert (int(m.num_inflight), int(m.num_landed)) == (0, 1)
    changed = (state.theta - th0).abs().amax(dim=1) > 0
    assert changed.tolist() == [True, False, False, False]
    assert m.committed.tolist() == [True, False, False, False]


def test_inflight_client_cannot_fire_and_controller_measures_late():
    state, round_fn = _run(_cfg(4, max_staleness=3), rounds=None,
                           state_fn=lambda s: _pin(s, [3] * 4))
    state, m = round_fn(state)  # δ⁰ = 0: everyone fires and parks
    assert int(m.num_events) == 4 and int(state.ctrl.event_count.sum()) == 0
    for _ in range(2):
        state, m = round_fn(state)
        assert int(m.num_events) == 0
        assert int(state.ctrl.event_count.sum()) == 0
    state, m = round_fn(state)  # round 3: lands, round 0 measured
    assert int(m.num_landed) == 4 and int(state.ctrl.event_count.sum()) == 4


def test_compact_queue_drains_through_the_pipeline():
    """The round-0 burst through two slots: every serviced solve lands,
    the queue and the pipeline end empty (fused commit)."""
    n = 8
    state, round_fn = _run(_cfg(n, compact=True, capacity=2, fused_gss=True,
                                max_staleness=2), rounds=None)
    th0 = state.theta.clone()
    cum_issued, prev = 0, 0
    for _ in range(3 * n):
        state, m = round_fn(state)
        cum_issued += int(m.num_events)
        done = cum_issued - int(m.num_deferred) - int(m.num_inflight)
        assert done >= prev
        prev = done
        state = _pin(state, delta=[1e9] * n)
    assert bool(((state.theta - th0).abs().amax(dim=1) > 0).all())
    assert int(state.queue.age.max()) == 0
    assert int(state.inflight.ttl.max()) == 0


def test_random_selection_redraws_among_eligible():
    """FedAvg's k-subset at δ ≡ 1 and L̄ = 0.5 reaches the feasible rate
    0.5, not the L̄/(1+L̄) of discarding in-flight picks."""
    state, round_fn = _run(_cfg(8, algorithm="fedavg", rho=0.0,
                                max_staleness=1), rounds=None,
                           state_fn=lambda s: _pin(s, [1] * 8))
    state, hist = run_rounds(round_fn, state, 30)
    assert float(hist.events.to(torch.float32).mean()) > 0.45


# --- state-synced against live JAX ------------------------------------------

LS = dict(algorithm="fedback", n_clients=64, participation=0.25, rho=1.0,
          lr=0.1, momentum=0.0, epochs=2, batch_size=4, seed=0,
          compact=True, capacity_slack=1.25, max_staleness=2)
SYNCED = {
    # name: (FLConfig keywords, rounds, layout)
    "golden_async_s2": (LS, 30, "flat"),
    "async_s2_fused": (dict(LS, fused_gss=True, use_trigger_kernel=True,
                            use_admm_kernel=True), 30, "flat"),
    "dense_s2_uniform": (dict(LS, compact=False, use_trigger_kernel=True,
                              use_admm_kernel=True,
                              staleness_schedule="uniform"), 12, "flat"),
    "tree_compact_s1": (dict(LS, max_staleness=1), 12, "tree"),
    "fedavg_random_s2": (dict(LS, algorithm="fedavg", rho=0.0), 12, "flat"),
}


@pytest.mark.parametrize("case", list(SYNCED))
def test_least_squares_matches_jax(case):
    kw, rounds, layout = SYNCED[case]
    jcfg, tcfg = _both(kw, dict(K=0.5, alpha=0.9))
    jdata, jparams, jls = jax_make_least_squares(64, 8, 5)
    tdata, tparams, tls = make_least_squares(64, 8, 5, device="cpu")
    seen = _run_synced(jcfg, tcfg, jls, tls, jdata, tdata, jparams, tparams,
                       rounds=rounds, layout=layout)
    assert seen["flipped_rounds"] == 0
    assert seen["events"] > 0 and seen["landed"] > 0 and seen["inflight"] > 0
    if kw["compact"] and kw["algorithm"] == "fedback":
        assert seen["deferred"] > 0


def test_mlp_compact_fused_matches_jax():
    """Form A's configuration (compact + fused, trigger and ADMM kernels
    on the JAX side) on a small MLP with ``max_staleness=2``."""
    from test_torch_round import FORMS
    params, x, y = _mlp_problem()
    jcfg, tcfg = _both(dict(FORMS["A_compact_fused"], max_staleness=2),
                       dict(K=1.0, alpha=0.9))
    seen = _run_synced(
        jcfg, tcfg, jax_make_loss_fn(jax_mlp_logits), make_loss_fn(),
        {"x": jnp.asarray(x), "y": jnp.asarray(y)}, {"x": x, "y": y},
        params, nest_params(params_from_numpy(params, device="cpu")),
        rounds=8)
    assert seen["flipped_rounds"] == 0
    assert seen["landed"] > 0 and seen["deferred"] > 0


def test_state_round_trip_carries_the_pipeline():
    from repro.core import FLConfig as JFLConfig
    from repro.core import init_state as jax_init_state
    from repro.core import make_flat_spec as jax_make_flat_spec
    _, params, _ = jax_make_least_squares(8, 8, 5)
    for spec in (jax_make_flat_spec(params), None):
        want = jax.device_get(jax_init_state(
            JFLConfig(n_clients=8, max_staleness=3,
                      staleness_schedule="uniform", seed=5),
            params, spec=spec))
        got = state_to_numpy(state_from_numpy(want, device="cpu"))
        for a, b in zip(jax.tree.leaves(got.inflight),
                        jax.tree.leaves(want.inflight), strict=True):
            np.testing.assert_array_equal(a, np.asarray(b))
            assert a.dtype == np.asarray(b).dtype
        mine = init_state(FLConfig(n_clients=8, max_staleness=3,
                                   staleness_schedule="uniform", seed=5),
                          {"theta": torch.zeros(5)},
                          spec=make_flat_spec({"theta": torch.zeros(5)})
                          if spec is not None else None, device="cpu")
        mine = state_to_numpy(mine)
        for a, b in zip(jax.tree.leaves(mine.inflight),
                        jax.tree.leaves(want.inflight), strict=True):
            np.testing.assert_array_equal(a, np.asarray(b))


# --- the client mesh ----------------------------------------------------

N_MESH, MESH_ROUNDS = 8, 5
MESH_LS = dict(algorithm="fedback", n_clients=N_MESH, participation=0.5,
               rho=1.0, lr=0.1, momentum=0.0, epochs=2, batch_size=4,
               use_trigger_kernel=True, use_admm_kernel=True,
               max_staleness=2)
MESH_CASES = {
    # name: (P, FLConfig keywords, trace seed or None)
    "compact_fused_s2_p2": (2, dict(compact=True, fused_gss=True,
                                    participation=0.25,
                                    capacity_slack=1.5), None),
    "compact_fused_s2_p4": (4, dict(compact=True, fused_gss=True,
                                    participation=0.25,
                                    capacity_slack=1.5), None),
    "dense_s2_p2": (2, {}, None),
    "compact_s1_p2_uniform": (2, dict(compact=True, max_staleness=1,
                                      participation=0.25,
                                      staleness_schedule="uniform"), None),
}
MESH_CTRL = dict(K=0.2, alpha=0.9)

MESH_SCRIPT = r"""
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import json, pickle, sys
import jax, jax.numpy as jnp, numpy as np
from repro.core import ControllerConfig, FLConfig, init_state, make_round_fn
from repro.core import make_flat_spec
from repro.core.schedule import TraceConfig, make_trace
from repro.data import make_least_squares
from repro.sharding.clients import make_client_mesh

cases, ctrl, n, rounds, out_path = json.loads(sys.argv[1])
data, params, loss = make_least_squares(n, 8, 5)
spec = make_flat_spec(params)
out = {}
for name, (p, kw, trace) in cases.items():
    cfg = FLConfig(controller=ControllerConfig(**ctrl), **kw)
    mesh = make_client_mesh(p)
    state = init_state(cfg, params, mesh=mesh, spec=spec)
    round_fn = make_round_fn(cfg, loss, data, mesh=mesh, spec=spec,
                             arrivals_arg=trace is not None)
    rows = None if trace is None else make_trace(TraceConfig(**trace))
    steps = []
    for r in range(rounds):
        before = jax.device_get(state)
        args = () if rows is None else (jnp.asarray(rows[r]),)
        state, m = round_fn(state, *args)
        steps.append((before, jax.device_get(state), jax.device_get(m),
                      None if rows is None else rows[r]))
    out[name] = steps
with open(out_path, "wb") as f:
    pickle.dump(out, f)
"""


def run_mesh_reference(tmp_path, cases, base, rounds):
    """The reference's sharded rounds of ``cases`` (one subprocess):
    per case, per round, (state before, state after, metrics, arrivals
    or None)."""
    path = tmp_path / "mesh.pkl"
    spec = {k: (p, dict(base, **kw), trace)
            for k, (p, kw, trace) in cases.items()}
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               JAX_PLATFORMS="cpu")
    out = subprocess.run(
        [sys.executable, "-c", MESH_SCRIPT,
         json.dumps([spec, MESH_CTRL, N_MESH, rounds, str(path)])],
        env=env, capture_output=True, text=True, timeout=600, cwd=REPO)
    assert out.returncode == 0, out.stderr[-3000:]
    with open(path, "rb") as f:  # written by the subprocess above
        return pickle.load(f)


def check_sharded_case(p, kw, steps, base, ctrl=None):
    """Step the port's sharded round from each of the reference's states
    and compare: events, ``committed`` and the counts equal; the queue,
    delays, countdowns and ring equal; the loads within one ulp and δ
    within one ulp of its operands (D1); the state and parked payloads
    at rtol 1e-4 / atol 1e-6, ω at rtol 1e-6 / atol 1e-7.  ``ctrl``
    (default ``MESH_CTRL``) may give a per-client ``target_rate`` as a
    list.  Returns the landed, in-flight and event totals."""
    ctrl = dict(ctrl or MESH_CTRL)
    if isinstance(ctrl.get("target_rate"), list):
        ctrl["target_rate"] = torch.tensor(ctrl["target_rate"],
                                           dtype=torch.float32)
    cfg = FLConfig(controller=ControllerConfig(**ctrl), **dict(base, **kw))
    data, params, loss = make_least_squares(N_MESH, 8, 5, device="cpu")
    spec = make_flat_spec(params)
    mesh = make_client_mesh(p, ["cpu"])
    serve = steps[0][3] is not None
    round_fn = make_round_fn(cfg, loss, data, spec=spec, mesh=mesh,
                             arrivals_arg=serve)
    seen = {"landed": 0, "inflight": 0, "events": 0}
    for r, (before, want, wm, arrivals) in enumerate(steps):
        shards = state_from_numpy(before, mesh=mesh)
        args = () if not serve else (torch.from_numpy(np.asarray(arrivals)),)
        new, m = round_fn(shards, *args)
        assert len(new) == p
        got = state_to_numpy(new)
        msg = f"P={p} round {r}"
        np.testing.assert_allclose(m.distances.numpy(), wm.distances,
                                   rtol=1e-6, atol=1e-7, err_msg=msg)
        np.testing.assert_array_equal(m.events.numpy(), wm.events,
                                      err_msg=msg)
        np.testing.assert_array_equal(m.committed.numpy(), wm.committed,
                                      err_msg=msg)
        for f in ("num_events", "num_deferred", "realized_capacity",
                  "num_inflight", "num_landed"):
            assert int(getattr(m, f)) == int(getattr(wm, f)), (msg, f)
        # D1: XLA contracts δ + K·(L − L̄) into one FMA.  With K = 0.2
        # the product is inexact, and where the sum cancels (δ near 0)
        # the gap is one ulp of the operands, not of the result.
        d_ulp = np.spacing(np.maximum.reduce([
            np.abs(got.ctrl.delta), np.abs(np.asarray(want.ctrl.delta)),
            np.abs(np.asarray(before.ctrl.delta))]))
        assert np.all(np.abs(got.ctrl.delta - np.asarray(want.ctrl.delta))
                      <= d_ulp), msg
        for a, b in ((got.ctrl.load, want.ctrl.load),
                     (got.queue.load, want.queue.load)):
            b = np.asarray(b)
            assert np.all(np.abs(a - b) <= np.spacing(np.maximum(
                np.abs(a), np.abs(b)))), msg
        np.testing.assert_array_equal(got.queue.age, want.queue.age)
        np.testing.assert_array_equal(got.ctrl.event_count,
                                      want.ctrl.event_count)
        pairs = [(got.theta, want.theta), (got.lam, want.lam),
                 (got.z_prev, want.z_prev)]
        assert (got.inflight is None) == (want.inflight is None), msg
        if want.inflight is not None:
            for f in ("delay", "ttl", "hist"):
                np.testing.assert_array_equal(getattr(got.inflight, f),
                                              getattr(want.inflight, f),
                                              err_msg=f"{msg} {f}")
            pairs += [(getattr(got.inflight, f), getattr(want.inflight, f))
                      for f in ("theta", "lam", "z")]
        for g, w in pairs:
            np.testing.assert_allclose(g, np.asarray(w), rtol=1e-4,
                                       atol=1e-6, err_msg=msg)
        np.testing.assert_allclose(got.omega, np.asarray(want.omega),
                                   rtol=1e-6, atol=1e-7, err_msg=msg)
        np.testing.assert_array_equal(got.rng, np.asarray(want.rng))
        seen["landed"] += int(wm.num_landed)
        seen["inflight"] += int(wm.num_inflight)
        seen["events"] += int(np.asarray(wm.events).sum())
    return seen


@pytest.fixture(scope="module")
def mesh_reference(tmp_path_factory):
    return run_mesh_reference(tmp_path_factory.mktemp("async_mesh"),
                              MESH_CASES, MESH_LS, MESH_ROUNDS)


@pytest.mark.parametrize("case", list(MESH_CASES))
def test_sharded_stale_round_matches_jax(case, mesh_reference):
    p, kw, _ = MESH_CASES[case]
    seen = check_sharded_case(p, kw, mesh_reference[case], MESH_LS)
    assert seen["events"] > 0 and seen["landed"] > 0
    assert seen["inflight"] > 0


def test_sharded_pipeline_rows_stay_on_their_shard():
    """Each shard holds its own clients' rows of the pipeline, and the
    shards' delays put together are the one-device schedule."""
    cfg = FLConfig(n_clients=8, max_staleness=2,
                   staleness_schedule="uniform", seed=3)
    params = {"theta": torch.zeros(5)}
    spec = make_flat_spec(params)
    shards = init_state(cfg, params, spec=spec,
                        mesh=make_client_mesh(4, ["cpu"]))
    single = init_state(cfg, params, spec=spec, device="cpu")
    assert all(s.inflight.hist.shape == (2, 3) and s.inflight.theta.shape
               == (2, 5) for s in shards)
    assert torch.equal(torch.cat([s.inflight.delay for s in shards]),
                       single.inflight.delay)

"""The reference's small public helpers, each against its JAX twin, and
the paper's Lemma 1 and Theorem 2 on the port.

* ``core/controller.py``: ``delta_bounds``, ``tracking_error_bounds``,
  ``realized_rate``; ``core/trigger.py``: ``trigger_events``;
  ``optim/sgd.py``: ``SGDState``, ``sgd_init`` and ``sgd_state_step``
  bit-equal to the reference's ``sgd_step`` on an ``SGDState``;
  ``optim/prox.py``: ``prox_grad_fn`` and ``solve_prox`` at rtol 1e-5
  (gradients and the loss's mean are reductions);
  ``utils/flatstate.py``: ``flat_loss_fn``, ``flatten_problem``;
  ``utils/pytree.py``'s algebra — elementwise ones bit-equal, the
  reductions (``tree_dot``, norms) at rtol 1e-6.
* tests/test_controller.py's Lemma 1 and Theorem 2 property tests on
  the port's controller (the closed loop over a bounded distance
  process, as there), and on the port's FedBack round itself: over 60
  rounds every δ_i stays within Lemma 1's bounds for δ₊ above the
  largest distance the round measured, and every client's realized rate
  lies within Theorem 2's c1/T, c2/T of L̄.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import controller as jctrl
from repro.core.trigger import trigger_events as jax_trigger_events
from repro.optim import prox as jprox
from repro.optim import sgd as jsgd
from repro.utils import flatstate as jflat
from repro.utils import pytree as jtree
from repro_torch.core import ControllerConfig, FLConfig, controller, \
    init_state, make_round_fn
from repro_torch.core.trigger import evaluate_trigger, trigger_events
from repro_torch.data import make_least_squares
from repro_torch.optim import SGDState, prox_grad_fn, sgd_init, \
    sgd_state_step, solve_prox
from repro_torch.utils import flat_loss_fn, flatten_problem, make_flat_spec
from repro_torch.utils import pytree as ttree


def _params(seed=0):
    rng = np.random.default_rng(seed)
    return {"fc": {"w": rng.normal(size=(4, 3)).astype(np.float32),
                   "b": rng.normal(size=(3,)).astype(np.float32)},
            "out": rng.normal(size=(5,)).astype(np.float32)}


def _t(tree):
    return jax.tree.map(torch.from_numpy, tree)


def _np(tree):
    return jax.tree.map(lambda x: x.detach().numpy() if isinstance(
        x, torch.Tensor) else np.asarray(x), tree)


def _bit_equal(got, want):
    got, want = jax.tree.leaves(_np(got)), jax.tree.leaves(_np(want))
    assert len(got) == len(want)
    for a, b in zip(got, want, strict=True):
        assert a.shape == b.shape and a.tobytes() == b.tobytes()


@pytest.mark.parametrize("K,alpha,delta0,dplus", [
    (2.0, 0.9, 0.0, 5.0), (0.5, 0.3, -1.5, 0.7), (7.0, 0.99, 3.0, 2.0)])
def test_controller_bounds_match_the_reference(K, alpha, delta0, dplus):
    tc = ControllerConfig(K=K, alpha=alpha, delta0=delta0)
    jc = jctrl.ControllerConfig(K=K, alpha=alpha, delta0=delta0)
    assert controller.delta_bounds(tc, dplus) == jctrl.delta_bounds(
        jc, dplus)
    for horizon in (1, 60, 3000):
        assert controller.tracking_error_bounds(tc, dplus, horizon) == \
            jctrl.tracking_error_bounds(jc, dplus, horizon)


def test_realized_rate_matches_the_reference():
    rng = np.random.default_rng(0)
    tcfg = ControllerConfig(K=1.0, alpha=0.9, target_rate=0.3)
    jcfg = jctrl.ControllerConfig(K=1.0, alpha=0.9, target_rate=0.3)
    ts = controller.init_controller(6, tcfg, device="cpu")
    js = jctrl.init_controller(6, jcfg)
    assert float(controller.realized_rate(ts).sum()) == 0.0  # round 0
    for _ in range(7):
        ev = rng.random(6) < 0.4
        ts = controller.controller_step(ts, torch.from_numpy(ev), tcfg)
        js = jctrl.controller_step(js, jnp.asarray(ev), jcfg)
    got, want = controller.realized_rate(ts), jctrl.realized_rate(js)
    assert got.numpy().tobytes() == np.asarray(want).tobytes()


@pytest.mark.parametrize("metric", ["l2", "linf", "cosine"])
def test_trigger_events_matches_the_reference(metric):
    rng = np.random.default_rng(1)
    z = rng.normal(size=(9, 7)).astype(np.float32)
    w = rng.normal(size=(7,)).astype(np.float32)
    dist = np.linalg.norm(z - w, axis=1)
    delta = (np.median(dist) * rng.uniform(0.5, 1.5, 9)).astype(np.float32)
    if metric != "l2":
        delta = rng.uniform(0, 1.2, 9).astype(np.float32)
    got = trigger_events(torch.from_numpy(w), torch.from_numpy(z),
                         torch.from_numpy(delta), metric)
    want = jax_trigger_events(jnp.asarray(w), jnp.asarray(z),
                              jnp.asarray(delta), metric)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert 0 < int(got.sum()) < 9 or metric != "l2"


@pytest.mark.parametrize("lr, momentum",
                         [(0.1, 0.9), (0.01, 0.9), (0.05, 0.0), (0.2, 0.5)])
def test_sgd_state_steps_match_the_reference(lr, momentum):
    params = _params()
    tp, jp = _t(params), jax.tree.map(jnp.asarray, params)
    tstate, jstate = sgd_init(tp), jsgd.sgd_init(jp)
    assert isinstance(tstate, SGDState) and int(tstate.step) == 0
    _bit_equal(tstate.momentum, jstate.momentum)
    for k in range(4):
        grads = _params(10 + k)
        tp, tstate = sgd_state_step(tp, _t(grads), tstate, lr, momentum)
        jp, jstate = jsgd.sgd_step(jp, jax.tree.map(jnp.asarray, grads),
                                   jstate, lr, momentum)
        _bit_equal(tp, jp)
        _bit_equal(tstate.momentum, jstate.momentum)
        assert int(tstate.step) == int(jstate.step) == k + 1


def test_sgd_state_steps_bit_equal_at_a_fixed_rate():
    params, grads = _params(), _params(3)
    tp, tstate = sgd_state_step(_t(params), _t(grads), sgd_init(_t(params)),
                                0.05, 0.9)
    jp, jstate = jsgd.sgd_step(jax.tree.map(jnp.asarray, params),
                               jax.tree.map(jnp.asarray, grads),
                               jsgd.sgd_init(params), 0.05, 0.9)
    _bit_equal(tp, jp)
    _bit_equal(tstate.momentum, jstate.momentum)


def _lsq_loss_t(params, batch):
    x, y = batch
    pred = x @ params["w"] + params["b"]
    return torch.mean((pred - y) ** 2)


def _lsq_loss_j(params, batch):
    x, y = batch
    pred = x @ params["w"] + params["b"]
    return jnp.mean((pred - y) ** 2)


def test_prox_solver_matches_the_reference():
    rng = np.random.default_rng(2)
    params = {"w": rng.normal(size=(6,)).astype(np.float32),
              "b": np.zeros((), np.float32)}
    center = {"w": rng.normal(size=(6,)).astype(np.float32),
              "b": np.full((), 0.3, np.float32)}
    xs = rng.normal(size=(8, 5, 6)).astype(np.float32)
    ys = rng.normal(size=(8, 5)).astype(np.float32)
    batch = (xs[0], ys[0])
    g_t = prox_grad_fn(_lsq_loss_t, 0.5)(_t(params), _t(center),
                                         _t(batch))
    g_j = jprox.prox_grad_fn(_lsq_loss_j, 0.5)(params, center, batch)
    for a, b in zip(jax.tree.leaves(_np(g_t)), jax.tree.leaves(g_j),
                    strict=True):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-5, atol=1e-6)
    p_t, loss_t = solve_prox(_lsq_loss_t, _t(params), _t(center),
                             (torch.from_numpy(xs), torch.from_numpy(ys)),
                             rho=0.5, lr=0.05, momentum=0.9)
    p_j, loss_j = jprox.solve_prox(_lsq_loss_j, params, center, (xs, ys),
                                   rho=0.5, lr=0.05, momentum=0.9)
    for a, b in zip(jax.tree.leaves(_np(p_t)), jax.tree.leaves(p_j),
                    strict=True):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(float(loss_t), float(loss_j), rtol=1e-5)


def test_flat_loss_helpers_match_the_reference():
    params = {"w": np.arange(6, dtype=np.float32).reshape(2, 3) / 7,
              "b": np.ones(3, np.float32)}
    x = np.linspace(-1, 1, 8, dtype=np.float32).reshape(4, 2)
    y = np.arange(12, dtype=np.float32).reshape(4, 3)

    def loss_t(p, x, y):
        return torch.sum((x @ p["w"] + p["b"] - y) ** 2)

    def loss_j(p, x, y):
        return jnp.sum((x @ p["w"] + p["b"] - y) ** 2)

    spec, flat0, fl = flatten_problem(_t(params), loss_t)
    jspec, jflat0, jfl = jflat.flatten_problem(params, loss_j)
    assert spec.dim == jspec.dim
    assert flat0.numpy().tobytes() == np.asarray(jflat0).tobytes()
    got = fl(flat0, torch.from_numpy(x), torch.from_numpy(y))
    np.testing.assert_allclose(float(got), float(jfl(jflat0, x, y)),
                               rtol=1e-6)
    again = flat_loss_fn(make_flat_spec(_t(params)), loss_t)
    assert float(again(flat0, torch.from_numpy(x),
                       torch.from_numpy(y))) == float(got)


def test_tree_algebra_matches_the_reference():
    a, b = _params(0), _params(1)
    ta, tb = _t(a), _t(b)
    ja, jb = (jax.tree.map(jnp.asarray, t) for t in (a, b))
    _bit_equal(ttree.tree_add(ta, tb), jtree.tree_add(ja, jb))
    _bit_equal(ttree.tree_sub(ta, tb), jtree.tree_sub(ja, jb))
    _bit_equal(ttree.tree_scale(ta, 0.3), jtree.tree_scale(ja, 0.3))
    _bit_equal(ttree.tree_axpy(1.7, ta, tb), jtree.tree_axpy(1.7, ja, jb))
    _bit_equal(ttree.tree_index(ttree.tree_stack([ta, tb]), 1), b)
    stacked = ttree.tree_stack([ta, tb, ta])
    _bit_equal(stacked, jtree.tree_stack([ja, jb, ja]))
    _bit_equal(ttree.tree_unstack(stacked, 3),
               jtree.tree_unstack(jtree.tree_stack([ja, jb, ja]), 3))
    _bit_equal(ttree.tree_ravel(ta), jtree.tree_ravel(ja))
    half = ttree.tree_cast(ta, torch.bfloat16)
    assert all(x.dtype == torch.bfloat16 for x in ttree.tree_leaves(half))
    assert ttree.tree_bytes(half) == jtree.tree_bytes(
        jtree.tree_cast(ja, jnp.bfloat16)) == 2 * ttree.tree_size(ta)
    assert ttree.tree_bytes(ta) == jtree.tree_bytes(ja)
    for fn in ("tree_dot",):
        np.testing.assert_allclose(float(getattr(ttree, fn)(ta, tb)),
                                   float(getattr(jtree, fn)(ja, jb)),
                                   rtol=1e-6)
    for fn in ("tree_sq_norm", "tree_norm"):
        np.testing.assert_allclose(float(getattr(ttree, fn)(ta)),
                                   float(getattr(jtree, fn)(ja)), rtol=1e-6)


# --- Lemma 1 and Theorem 2 on the port --------------------------------------


def _closed_loop(cfg, distances):
    """The controller driven by an exogenous bounded distance process
    (T, N): (events (T, N), deltas (T, N), final state)."""
    state = controller.init_controller(distances.shape[1], cfg,
                                       device="cpu")
    events, deltas = [], []
    for dist in torch.from_numpy(distances):
        ev = evaluate_trigger(dist, state.delta)
        state = controller.controller_step(state, ev, cfg)
        events.append(ev)
        deltas.append(state.delta)
    return torch.stack(events).numpy(), torch.stack(deltas).numpy(), state


@pytest.mark.parametrize("seed", range(8))
def test_lemma1_delta_bounded_for_any_bounded_distance_process(seed):
    rng = np.random.default_rng(seed)
    cfg = ControllerConfig(K=float(rng.uniform(0.05, 10.0)),
                           alpha=float(rng.uniform(0.05, 0.99)),
                           target_rate=float(rng.uniform(0.01, 1.0)),
                           delta0=float(rng.uniform(-5.0, 5.0)))
    dist_max = 3.0
    _, deltas, _ = _closed_loop(cfg, rng.uniform(
        0.0, dist_max, (400, 1)).astype(np.float32))
    lo, hi = controller.delta_bounds(cfg, dist_max + 1e-6)
    tol = 1e-4 * max(1.0, abs(lo), abs(hi))
    assert deltas.min() >= lo - tol and deltas.max() <= hi + tol


@pytest.mark.parametrize("seed", range(6))
def test_theorem2_rate_tracks_target(seed):
    rng = np.random.default_rng(seed)
    cfg = ControllerConfig(K=float(rng.uniform(0.1, 5.0)),
                           alpha=float(rng.uniform(0.2, 0.95)),
                           target_rate=float(rng.uniform(0.05, 0.95)))
    horizon, dist_max = 1500, 2.0
    events, _, state = _closed_loop(cfg, rng.uniform(
        0, dist_max, (horizon, 1)).astype(np.float32))
    lo, hi = controller.tracking_error_bounds(cfg, dist_max + 1e-6,
                                              horizon)
    rate = events.mean()
    assert lo - 1e-6 <= rate - cfg.target_rate <= hi + 1e-6
    assert float(controller.realized_rate(state)[0]) == pytest.approx(rate)


@pytest.mark.parametrize("kw", [dict(compact=False), dict(compact=True),
                                dict(compact=True,
                                     consensus_compress="int8")],
                         ids=["dense", "compact", "compact_int8"])
def test_lemma1_and_theorem2_hold_on_the_round(kw):
    """The FedBack round's own trigger process (least squares, N = 16,
    60 rounds): δ within Lemma 1's bounds and each client's realized
    rate within Theorem 2's envelope, δ₊ just above the largest distance
    the round measured."""
    n, rounds = 16, 60
    ctrl = ControllerConfig(K=0.5, alpha=0.9)
    cfg = FLConfig(algorithm="fedback", n_clients=n, participation=0.25,
                   rho=1.0, lr=0.1, momentum=0.0, epochs=1, batch_size=4,
                   controller=ctrl, **kw)
    data, params, loss = make_least_squares(n, 8, 5, device="cpu")
    spec = make_flat_spec(params)
    state = init_state(cfg, params, spec=spec, device="cpu")
    round_fn = make_round_fn(cfg, loss, data, spec=spec, device="cpu")
    dmax, deltas = 0.0, []
    for _ in range(rounds):
        state, m = round_fn(state)
        dmax = max(dmax, float(m.distances.max()))
        deltas.append(m.delta)
    deltas = torch.stack(deltas)
    target = ctrl._replace(target_rate=cfg.participation)
    lo, hi = controller.delta_bounds(target, dmax + 1e-6)
    assert float(deltas.min()) >= lo and float(deltas.max()) <= hi
    c1, c2 = controller.tracking_error_bounds(target, dmax + 1e-6, rounds)
    err = controller.realized_rate(state.ctrl) - cfg.participation
    assert float(err.min()) >= c1 - 1e-6 and float(err.max()) <= c2 + 1e-6
    assert int(state.ctrl.event_count.sum()) > 0

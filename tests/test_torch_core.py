"""The port's round algebra against the JAX package, module by module.

Same numpy inputs through both; tolerances:

* controller δ, queue ages, compact plans and the adaptive limit:
  bit-equal;
* the low-pass loads (controller L and the queue's demand EMA): within
  one ulp.  XLA's CPU backend contracts ``(1−α)·L + α·S`` into one FMA
  (``test_xla_contracts_the_low_pass_into_an_fma`` shows it), while
  torch rounds the product before the add;
* the local solve: rtol 1e-4 / atol 1e-6 — its matrix products sum in
  another order than XLA's.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import compact as jcompact
from repro.core import trigger as jtrigger
from repro.core import controller as jctrl
from repro.core.fedback import _local_solve as jax_local_solve
from repro.core.state import DeferQueue as JQueue
from repro.models.mlp import init_mlp as jax_init_mlp
from repro.models.mlp import make_loss_fn as jax_make_loss_fn
from repro.models.mlp import mlp_logits as jax_mlp_logits
from repro.utils.flatstate import make_flat_spec as jax_make_flat_spec
from repro_torch.convert import nest_params, params_from_numpy
from repro_torch.core import compact, controller, trigger
from repro_torch.core.fedback import _local_solve
from repro_torch.core.state import DeferQueue
from repro_torch.models import MLP, make_loss_fn
from repro_torch.utils import make_flat_spec

ULP = np.float32(2.0 ** -23)


def _t(a):
    return torch.from_numpy(np.array(a))


def _within_one_ulp(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    gap = np.abs(got - want)
    assert np.all(gap <= np.spacing(np.maximum(np.abs(got), np.abs(want)))
                  ), gap.max()


def _ctrl_inputs(seed, n):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=n).astype(np.float32),
            rng.random(n).astype(np.float32),
            rng.integers(0, 50, n).astype(np.int32),
            rng.random(n) < 0.4)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("filtered", [False, True])
def test_controller_step(seed, filtered):
    n = 97
    delta, load, count, events = _ctrl_inputs(seed, n)
    target = np.random.default_rng(seed).random(n).astype(np.float32) * 0.3
    kw = dict(K=2.0, alpha=0.9, use_filtered_error=filtered)
    jc = jctrl.ControllerConfig(target_rate=jnp.asarray(target), **kw)
    tc = controller.ControllerConfig(target_rate=_t(target), **kw)
    js = jctrl.ControllerState(jnp.asarray(delta), jnp.asarray(load),
                               jnp.asarray(5, jnp.int32), jnp.asarray(count))
    ts = controller.ControllerState(_t(delta), _t(load),
                                    torch.tensor(5, dtype=torch.int32),
                                    _t(count))
    want = jax.jit(lambda s, e: jctrl.controller_step(s, e, jc))(
        js, jnp.asarray(events))
    got = controller.controller_step(ts, _t(events), tc)
    _within_one_ulp(got.load.numpy(), want.load)
    if filtered:  # δ reads the new load, so it inherits the ulp
        np.testing.assert_allclose(got.delta.numpy(), np.asarray(want.delta),
                                   rtol=0, atol=4 * float(ULP))
    else:
        assert got.delta.numpy().tobytes() == \
            np.asarray(want.delta).tobytes()
    assert int(got.round) == int(want.round) == 6
    np.testing.assert_array_equal(got.event_count.numpy(),
                                  np.asarray(want.event_count))


def test_xla_contracts_the_low_pass_into_an_fma():
    """The reason for the one-ulp tolerance on the loads."""
    _, load, _, events = _ctrl_inputs(9, 4096)
    want = np.asarray(jax.jit(jctrl.demand_load_step, static_argnums=2)(
        jnp.asarray(load), jnp.asarray(events), 0.9))
    fma = (np.float64(np.float32(0.1)) * load.astype(np.float64)
           + np.float64(np.float32(0.9)) * events).astype(np.float32)
    np.testing.assert_array_equal(want, fma)
    got = controller.demand_load_step(_t(load), _t(events), 0.9).numpy()
    two_roundings = (np.float32(0.1) * load + np.float32(0.9)
                     * events.astype(np.float32)).astype(np.float32)
    np.testing.assert_array_equal(got, two_roundings)
    _within_one_ulp(got, want)


@pytest.mark.parametrize("n,cap,limit", [(16, 6, None), (100, 16, 12),
                                         (64, 20, 20), (33, 40, 5)])
@pytest.mark.parametrize("seed", [0, 1])
def test_compact_plan_and_queue(n, cap, limit, seed):
    rng = np.random.default_rng(seed + n)
    events = rng.random(n) < 0.5
    # Ties in priority exercise the low-index tie-break.
    prio = rng.integers(0, 6, n).astype(np.float32) / 3
    age = np.where(rng.random(n) < 0.3, rng.integers(1, 4, n), 0)
    age = age.astype(np.int32)
    qload = rng.random(n).astype(np.float32)
    cap = min(cap, n)
    want = jcompact.compact_plan(jnp.asarray(events), jnp.asarray(prio), cap,
                                 age=jnp.asarray(age), limit=limit)
    got = compact.compact_plan(_t(events), _t(prio), cap, age=_t(age),
                               limit=limit)
    for f in ("idx", "valid", "committed", "num_deferred", "demand",
              "num_demand", "limit"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)), err_msg=f)
    assert got.idx.dtype == torch.int32
    wq = jcompact.queue_update(JQueue(jnp.asarray(age), jnp.asarray(qload)),
                               want, alpha=0.9)
    gq = compact.queue_update(DeferQueue(_t(age), _t(qload)), got, alpha=0.9)
    np.testing.assert_array_equal(gq.age.numpy(), np.asarray(wq.age))
    _within_one_ulp(gq.load.numpy(), wq.load)


@pytest.mark.parametrize("n", [16, 33, 64, 100, 1000, 5000])
def test_adaptive_limit_bit_equal(n):
    rng = np.random.default_rng(n)
    for trial in range(40):
        qload = (rng.random(n) * rng.choice([1.0, 1e-3, 0.05], n)
                 ).astype(np.float32)
        want = jax.jit(jnp.sum)(jnp.asarray(qload))
        got = compact.sum_in_xla_cpu_order(_t(qload))
        assert got.numpy().tobytes() == np.asarray(want).tobytes(), trial
        hi = max(2, n // 3)
        assert int(compact.adaptive_limit(_t(qload), 1, hi)) == int(
            jcompact.adaptive_limit(jnp.asarray(qload), 1, hi))


def test_adaptive_limit_on_integer_sums():
    """Loads in complementary pairs (0.1 + 0.9, 0.01 + 0.99, ...) sum to
    an integer up to fp32 rounding, so the ceiling depends on the order
    of the adds: the port must land where XLA does, where a plain
    ``torch.sum`` often does not."""
    rng = np.random.default_rng(0)
    pairs = np.array([(0.1, 0.9), (0.01, 0.99), (0.09, 0.91), (0.19, 0.81),
                      (0.271, 0.729)], np.float32)
    plain_misses = 0
    for n in (16, 64, 100) * 40:
        q = pairs[rng.integers(0, len(pairs), n // 2)].reshape(-1)
        rng.shuffle(q)
        want = int(jcompact.adaptive_limit(jnp.asarray(q), 1, n))
        assert int(compact.adaptive_limit(_t(q), 1, n)) == want
        plain_misses += int(np.ceil(torch.from_numpy(q).sum().item())) != want
    assert plain_misses > 0  # the order matters on these inputs


def test_capacity_bounds_match():
    for n, rate, slack in [(100, 0.1, 1.5), (64, 0.25, 1.25), (16, 0.25, 1.5),
                           (10, 0.35, 1.0), (7, 1.0, 3.0)]:
        assert compact.capacity_bounds(n, rate, slack) == \
            jcompact.capacity_bounds(n, rate, slack)


def test_paper_mnist_capacity():
    # C = ⌈1.5·0.1·100⌉ = 16 slots (the fp64 product is 15.000000000000002),
    # floor ⌈0.1·100⌉ = 10.
    assert compact.capacity_bounds(100, 0.1, 1.5) == (10, 16)


@pytest.mark.parametrize("metric", ["l2", "linf", "cosine"])
def test_trigger_distances(metric):
    rng = np.random.default_rng(3)
    z = rng.normal(size=(21, 130)).astype(np.float32)
    w = rng.normal(size=130).astype(np.float32)
    want = np.asarray(jtrigger.trigger_distances(jnp.asarray(w),
                                                 jnp.asarray(z), metric))
    got = trigger.trigger_distances(_t(w), _t(z), metric).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6)
    delta = rng.normal(size=21).astype(np.float32) + float(np.median(got))
    np.testing.assert_array_equal(
        trigger.evaluate_trigger(_t(got), _t(delta)).numpy(),
        np.asarray(jtrigger.evaluate_trigger(jnp.asarray(got),
                                             jnp.asarray(delta))))


def _mlp_np(seed, n_in, hidden, n_out):
    params = jax.device_get(jax_init_mlp(jax.random.PRNGKey(seed), n_in,
                                         hidden, n_out))
    return jax.tree.map(np.asarray, params)


def test_flat_spec_layout_and_round_trip():
    p_np = _mlp_np(0, 32, 16, 4)
    jspec = jax_make_flat_spec(p_np)
    tparams = nest_params(params_from_numpy(p_np, device="cpu"))
    spec = make_flat_spec(tparams)
    assert spec.dim == jspec.dim == 596
    assert spec.offsets == jspec.offsets and spec.shapes == jspec.shapes
    assert spec.paths == (("fc1", "b"), ("fc1", "w"), ("fc2", "b"),
                          ("fc2", "w"))
    flat = spec.flatten(tparams)
    assert flat.numpy().tobytes() == np.asarray(jspec.flatten(p_np)).tobytes()
    back = spec.unflatten(flat)
    for k in ("fc1", "fc2"):
        for leaf in ("w", "b"):
            np.testing.assert_array_equal(back[k][leaf].numpy(),
                                          p_np[k][leaf])
    back["fc2"]["b"][0] = 123.0  # unflatten returns views
    assert float(flat[spec.offsets[2]]) == 123.0
    rows = torch.stack([flat, 2 * flat])
    stacked = spec.unflatten_stacked(rows)
    assert stacked["fc1"]["w"].shape == (2, 32, 16)
    assert torch.equal(spec.flatten_stacked(stacked), rows)


def test_data_makers_match():
    from repro.data import federated_arrays as jax_federated_arrays
    from repro.data import make_least_squares as jax_make_least_squares
    from repro.data import make_synthetic_mnist as jax_make_mnist
    from repro_torch.data import federated_arrays, make_least_squares, \
        make_synthetic_mnist

    jds, tds = jax_make_mnist(2000, 100), make_synthetic_mnist(2000, 100)
    for f in ("x_train", "y_train", "x_test", "y_test"):
        assert getattr(tds, f).tobytes() == getattr(jds, f).tobytes(), f
    jdata, jtest = jax_federated_arrays(jds, n_clients=20)
    tdata, ttest = federated_arrays(tds, n_clients=20, device="cpu")
    for a, b in ((tdata, jdata), (ttest, jtest)):
        for k in ("x", "y"):
            np.testing.assert_array_equal(a[k].numpy(), np.asarray(b[k]))
    jd, jp, _ = jax_make_least_squares(8, 4, 3, seed=2)
    td, tp, _ = make_least_squares(8, 4, 3, seed=2, device="cpu")
    np.testing.assert_array_equal(td["x"].numpy(), np.asarray(jd["x"]))
    np.testing.assert_array_equal(td["y"].numpy(), np.asarray(jd["y"]))
    assert tp["theta"].shape == jp["theta"].shape


def test_mlp_state_dict_keys():
    sd = params_from_numpy(_mlp_np(1, 784, 200, 10), device="cpu")
    model = MLP(device="cpu")
    model.load_state_dict(sd)
    assert list(sd) == ["fc1.b", "fc1.w", "fc2.b", "fc2.w"]
    assert model.fc1.w.shape == (784, 200)


@pytest.mark.parametrize("rho,momentum", [(0.01, 0.9), (1.0, 0.0)])
def test_local_solve_mlp(rho, momentum):
    rng = np.random.default_rng(4)
    c, n_pts, n_in, batch, steps = 5, 24, 32, 8, 6
    p_np = _mlp_np(2, n_in, 16, 4)
    jspec = jax_make_flat_spec(p_np)
    w0 = np.asarray(jspec.flatten(p_np))
    theta0 = (w0 + 0.01 * rng.normal(size=(c, w0.size))).astype(np.float32)
    center = (w0 + 0.01 * rng.normal(size=(c, w0.size))).astype(np.float32)
    x = rng.random((c, n_pts, n_in)).astype(np.float32)
    y = rng.integers(0, 4, (c, n_pts)).astype(np.int32)
    idx = np.stack([np.concatenate([rng.permutation(n_pts)
                                    for _ in range(2)]).reshape(steps, batch)
                    for _ in range(c)]).astype(np.int32)

    jloss = jax_make_loss_fn(jax_mlp_logits)

    def one(t0, cen, xx, yy, ii):
        th, loss = jax_local_solve(jloss, jspec.unflatten(t0),
                                   jspec.unflatten(cen), xx, yy, ii,
                                   rho=rho, lr=0.01, momentum=momentum)
        return jspec.flatten(th), loss

    want_th, want_loss = jax.jit(jax.vmap(one))(theta0, center, x, y, idx)
    spec = make_flat_spec(nest_params(params_from_numpy(p_np, device="cpu")))
    got_th, got_loss = _local_solve(make_loss_fn(), spec, _t(theta0),
                                    _t(center), _t(x), _t(y), _t(idx),
                                    rho=rho, lr=0.01, momentum=momentum)
    np.testing.assert_allclose(got_th.numpy(), np.asarray(want_th),
                               rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(got_loss.numpy(), np.asarray(want_loss),
                               rtol=1e-4, atol=1e-6)

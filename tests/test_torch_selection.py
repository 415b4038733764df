"""The port's selection strategies against the JAX package's, bit for
bit: the same key, state and distances give the same events, with and
without an eligibility mask (the stale-tolerant engine's), and the same
controller step.  Plus the reference's k-subset size grid and the
round-robin cycle."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import ControllerConfig as JCtrl
from repro.core import FLConfig as JFLConfig
from repro.core import init_state as jax_init_state
from repro.core import make_flat_spec as jax_make_flat_spec
from repro.core.selection import make_selection as jax_make_selection
from repro.core.selection import subset_size as jax_subset_size
from repro_torch.convert import state_from_numpy
from repro_torch.core import ControllerConfig
from repro_torch.core.selection import make_selection, subset_size

STRATEGIES = ["random", "bernoulli", "round_robin", "full", "fedback"]


def _states(n, round_, seed):
    """The JAX state (numpy leaves) and the port's, at round ``round_``
    with thresholds spread around the distances."""
    rng = np.random.default_rng(seed)
    params = {"w": np.zeros(3, np.float32)}
    js = jax.device_get(jax_init_state(JFLConfig(n_clients=n), params,
                                       spec=jax_make_flat_spec(params)))
    delta = rng.normal(size=n).astype(np.float32)
    js = js._replace(round=np.int32(round_),
                     ctrl=js.ctrl._replace(delta=delta))
    return js, state_from_numpy(js, device="cpu")


@pytest.mark.parametrize("name", STRATEGIES)
@pytest.mark.parametrize("n,rate", [(10, 0.3), (33, 0.1), (100, 0.1),
                                    (16, 0.25)])
@pytest.mark.parametrize("masked", [False, True])
def test_decide_and_measure_bit_equal(name, n, rate, masked):
    jsel = jax_make_selection(name, rate=rate,
                              controller=JCtrl(K=2.0, target_rate=rate))
    tsel = make_selection(name, rate=rate,
                          controller=ControllerConfig(K=2.0,
                                                      target_rate=rate))
    for trial in range(4):
        seed = 100 * n + trial
        js, ts = _states(n, round_=3 * trial + 1, seed=seed)
        rng = np.random.default_rng(seed + 1)
        dist = np.abs(rng.normal(size=n)).astype(np.float32)
        elig = rng.random(n) < 0.6 if masked else None
        jkey = jax.random.PRNGKey(seed)
        tkey = torch.from_numpy(np.asarray(jkey, np.int64))
        want = np.asarray(jsel.decide(
            jkey, js, jnp.asarray(dist), None,
            None if elig is None else jnp.asarray(elig)))
        got = tsel.decide(tkey, ts, torch.from_numpy(dist), None,
                          None if elig is None else torch.from_numpy(elig))
        assert got.dtype == torch.bool and got.shape == (n,)
        np.testing.assert_array_equal(got.numpy(), want, err_msg=str(trial))
        if not masked:
            jev, jctrl = jsel(jkey, js, jnp.asarray(dist))
            tev, tctrl = tsel(tkey, ts, torch.from_numpy(dist))
            np.testing.assert_array_equal(tev.numpy(), np.asarray(jev))
            assert tctrl.delta.numpy().tobytes() == np.asarray(
                jctrl.delta).tobytes()
            np.testing.assert_array_equal(tctrl.event_count.numpy(),
                                          np.asarray(jctrl.event_count))


@pytest.mark.parametrize("rate,n,expected", [
    (0.35, 10, 3), (0.55, 10, 5), (0.15, 10, 1), (0.1, 16, 1),
    (0.25, 10, 2), (0.45, 10, 4), (0.1, 5, 1), (0.29, 100, 29),
    (0.3, 10, 3), (0.5, 10, 5), (0.25, 16, 4), (1.0, 7, 7),
    (0.01, 8, 1), (0.75, 4, 3),
])
def test_subset_size_grid(rate, n, expected):
    """tests/test_baselines.py's grid: k = max(⌊L̄·N⌋, 1)."""
    assert subset_size(rate, n) == jax_subset_size(rate, n) == expected


@pytest.mark.parametrize("name,k", [("random", 3), ("round_robin", 3)])
def test_k_subset_strategies_draw_floor_cardinality(name, k):
    sel = make_selection(name, rate=0.35,
                         controller=ControllerConfig(target_rate=0.35))
    _, ts = _states(10, 0, 0)
    for seed in range(5):
        ev, _ = sel(torch.tensor([0, seed]), ts, torch.zeros(10))
        assert int(ev.sum()) == k


def test_round_robin_cycles_through_all_clients():
    sel = make_selection("round_robin", rate=0.2,
                         controller=ControllerConfig())
    _, ts = _states(10, 0, 0)
    seen = torch.zeros(10, dtype=torch.bool)
    fired = []
    for _ in range(5):
        ev, ctrl = sel(torch.tensor([0, 0]), ts, torch.zeros(10))
        seen |= ev
        fired.append(torch.nonzero(ev).flatten().tolist())
        ts = ts._replace(ctrl=ctrl, round=ts.round + 1)
    assert bool(seen.all())
    assert fired == [[0, 1], [2, 3], [4, 5], [6, 7], [8, 9]]


def test_ctrl_overrides_are_refused():
    """Runtime overrides are taken now (the sweeps are ported): FedBack's
    step with {"K": k} gives the bits of a controller configured with
    K = k, and an open-loop selection ignores them."""
    ctrl = ControllerConfig(K=2.0, alpha=0.9, target_rate=0.1)
    _, ts = _states(4, 0, 0)
    ts = ts._replace(ctrl=ts.ctrl._replace(load=torch.tensor(
        [0.0, 0.3, 0.7, 1.0])))
    ev = torch.tensor([True, False, True, False])
    got = make_selection("fedback", rate=0.1, controller=ctrl).measure(
        ts.ctrl, ev, {"K": torch.tensor(0.2), "target_rate":
                      torch.tensor(0.3)})
    want = make_selection("fedback", rate=0.1, controller=ctrl._replace(
        K=0.2, target_rate=0.3)).measure(ts.ctrl, ev)
    assert torch.equal(got.delta, want.delta)
    assert torch.equal(got.load, want.load)
    rnd = make_selection("random", rate=0.5, controller=ctrl)
    assert torch.equal(rnd.measure(ts.ctrl, ev, {"K": torch.tensor(9.0)}).delta,
                       rnd.measure(ts.ctrl, ev).delta)

"""The paper's baselines and the randomized selections against live JAX,
state-synced (tests/test_torch_round.py's harness and grades).

* FedADMM (dense, compact, compact with the fused commit), FedAvg and
  FedProx (dense and compact), vanilla ADMM, and FedBack with the
  bernoulli and round-robin selections: every round starts from the
  JAX state; events and ``committed`` equal, state at rtol 1e-4, and
  the AVG family's ω — a mean over the committed rows, with no solve
  after it — at rtol 1e-6 / atol 1e-7.
* A round in which no client fires keeps ω (the fallback of the
  participant mean).
* SCAFFOLD stepped from the JAX state through the converter, and the
  reference's two properties of it.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.baselines import init_scaffold as jax_init_scaffold
from repro.core.baselines import make_scaffold_round as \
    jax_make_scaffold_round
from repro.core.engine import participant_mean as jax_participant_mean
from repro.models.mlp import make_loss_fn as jax_make_loss_fn
from repro.models.mlp import mlp_logits as jax_mlp_logits
from repro_torch.convert import nest_params, params_from_numpy, \
    scaffold_state_from_numpy, scaffold_state_to_numpy
from repro_torch.core import FLConfig, baseline_config, init_scaffold, \
    make_scaffold_round
from repro_torch.core.engine import participant_mean
from repro_torch.models import make_loss_fn
from repro_torch.utils import make_flat_spec
from test_torch_round import MLP_BASE, N, _both, _mlp_problem, _run_synced

AVG_OMEGA_TOL = (1e-6, 1e-7)
CONFIGS = {
    "fedadmm_dense": dict(algorithm="fedadmm", compact=False),
    "fedadmm_compact": dict(algorithm="fedadmm", compact=True),
    "fedadmm_compact_fused": dict(algorithm="fedadmm", compact=True,
                                  fused_gss=True),
    "fedavg_dense": dict(algorithm="fedavg", rho=0.0, compact=False),
    "fedavg_compact": dict(algorithm="fedavg", rho=0.0, compact=True),
    "fedprox_dense": dict(algorithm="fedprox", mu=0.01, compact=False),
    "fedprox_compact": dict(algorithm="fedprox", mu=0.01, compact=True),
    "admm_dense": dict(algorithm="admm", compact=False),
    "admm_compact": dict(algorithm="admm", compact=True),
    "fedback_bernoulli_dense": dict(selection="bernoulli", compact=False),
    "fedback_bernoulli_compact": dict(selection="bernoulli", compact=True),
    "fedback_round_robin_dense": dict(selection="round_robin",
                                      compact=False),
    "fedback_round_robin_compact_fused": dict(
        selection="round_robin", compact=True, fused_gss=True),
}


def _mlp_run(cfg_kw, ctrl_kw=None, rounds=5, omega_tol=None):
    params, x, y = _mlp_problem()
    jcfg, tcfg = _both(dict(MLP_BASE, **cfg_kw),
                       ctrl_kw or dict(K=1.0, alpha=0.9))
    return jcfg, _run_synced(
        jcfg, tcfg, jax_make_loss_fn(jax_mlp_logits), make_loss_fn(),
        {"x": jnp.asarray(x), "y": jnp.asarray(y)}, {"x": x, "y": y},
        params, nest_params(params_from_numpy(params, device="cpu")),
        rounds=rounds, omega_tol=omega_tol)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_baseline_rounds_match_jax(name):
    kw = CONFIGS[name]
    avg = kw.get("algorithm") in ("fedavg", "fedprox")
    jcfg, seen = _mlp_run(kw, omega_tol=AVG_OMEGA_TOL if avg else None)
    assert seen["flipped_rounds"] == 0
    if jcfg.algorithm == "admm":
        assert seen["events"] == 5 * N
    else:
        assert 0 < seen["events"] < 5 * N


def test_round_with_no_event_keeps_omega():
    """FedAvg under the trigger with δ⁰ far above every distance: no
    client fires, and ω stays as it was, in both packages."""
    from repro_torch.core import ControllerConfig, init_state, make_round_fn

    jcfg, seen = _mlp_run(dict(algorithm="fedavg", rho=0.0,
                               selection="fedback"),
                          dict(K=0.0, alpha=0.9, delta0=1e9), rounds=2,
                          omega_tol=(0.0, 0.0))
    assert seen["events"] == 0
    params, x, y = _mlp_problem()
    tparams = nest_params(params_from_numpy(params, device="cpu"))
    spec = make_flat_spec(tparams)
    cfg = FLConfig(**dict(MLP_BASE, algorithm="fedavg", rho=0.0,
                          selection="fedback"),
                   controller=ControllerConfig(K=0.0, delta0=1e9))
    state = init_state(cfg, tparams, spec=spec, device="cpu")
    new, m = make_round_fn(cfg, make_loss_fn(), {"x": x, "y": y},
                           spec=spec, device="cpu")(state)
    assert int(m.num_events) == 0
    assert torch.equal(new.omega, state.omega)


@pytest.mark.parametrize("n,d,p", [(16, 37, 0.3), (5, 8, 0.0), (7, 3, 1.0)])
def test_participant_mean_matches_jax(n, d, p):
    rng = np.random.default_rng(n)
    z = rng.normal(size=(n, d)).astype(np.float32)
    w = rng.normal(size=d).astype(np.float32)
    ev = rng.random(n) < p
    want = np.asarray(jax_participant_mean(
        {"w": jnp.asarray(z)}, jnp.asarray(ev), {"w": jnp.asarray(w)})["w"])
    got = participant_mean(torch.from_numpy(z), torch.from_numpy(ev),
                           torch.from_numpy(w)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    if not ev.any():
        np.testing.assert_array_equal(got, w)


def test_fused_commit_is_refused_outside_the_admm_family():
    params, x, y = _mlp_problem()
    tparams = nest_params(params_from_numpy(params, device="cpu"))
    from repro_torch.core import make_round_fn
    cfg = FLConfig(**dict(MLP_BASE, algorithm="fedavg", compact=True,
                          fused_gss=True))
    with pytest.raises(ValueError, match="ADMM-family"):
        make_round_fn(cfg, make_loss_fn(), {"x": x, "y": y},
                      spec=make_flat_spec(tparams), device="cpu")


@pytest.mark.parametrize("name", ["fedback", "fedadmm", "admm", "fedavg",
                                  "fedprox"])
def test_baseline_presets_are_the_references(name):
    from repro.core.baselines import baseline_config as jax_baseline_config
    got, want = baseline_config(name, n_clients=8), \
        jax_baseline_config(name, n_clients=8)
    for f in ("algorithm", "n_clients", "participation", "rho", "mu",
              "selection"):
        assert getattr(got, f) == getattr(want, f), f
    assert got.selection_name() == want.selection_name()
    assert got.local_rho() == want.local_rho()
    with pytest.raises(ValueError):
        baseline_config("fedsgd")


# ----------------------------------------------------------------------
# SCAFFOLD
# ----------------------------------------------------------------------


def _ls_loss_jax(params, x, y):
    r = x @ params["theta"] - y
    return 0.5 * jnp.mean(r * r)


def _ls_loss(params, x, y):
    r = x @ params["theta"] - y
    return 0.5 * torch.mean(r * r)


@pytest.mark.parametrize("problem", ["mlp", "least_squares"])
def test_scaffold_rounds_match_jax(problem):
    """N = 4, 5 rounds, each started from the JAX state."""
    n = 4
    if problem == "mlp":
        params, x, y = _mlp_problem()
        x, y = x[:n], y[:n]
        jloss, tloss = jax_make_loss_fn(jax_mlp_logits), make_loss_fn()
        kw = dict(lr=0.05, momentum=0.9, epochs=2, batch_size=8)
    else:
        rng = np.random.default_rng(3)
        params = {"theta": np.zeros(6, np.float32)}
        x = rng.normal(size=(n, 10, 6)).astype(np.float32)
        y = rng.normal(size=(n, 10)).astype(np.float32)
        jloss, tloss = _ls_loss_jax, _ls_loss
        kw = dict(lr=0.1, momentum=0.0, epochs=3, batch_size=5)
    jcfg, tcfg = _both(dict(algorithm="fedavg", n_clients=n,
                            participation=0.5, seed=11, **kw), {})
    tparams = nest_params(params_from_numpy(params, device="cpu"))
    spec = make_flat_spec(tparams)
    jstate = jax_init_scaffold(jcfg, params)
    jround = jax_make_scaffold_round(jcfg, jloss, {"x": jnp.asarray(x),
                                                   "y": jnp.asarray(y)})
    tround = make_scaffold_round(tcfg, tloss, {"x": x, "y": y}, spec=spec,
                                 device="cpu")
    start = scaffold_state_to_numpy(init_scaffold(tcfg, tparams, spec=spec,
                                                  device="cpu"))
    first = scaffold_state_from_numpy(jax.device_get(jstate), spec,
                                      device="cpu")
    for a, b in zip(start, scaffold_state_to_numpy(first), strict=True):
        np.testing.assert_array_equal(a, b)
    fired = 0
    for r in range(5):
        before = jax.device_get(jstate)
        tnew, tm = tround(scaffold_state_from_numpy(before, spec,
                                                    device="cpu"))
        jstate, jm = jround(jstate)
        want = scaffold_state_to_numpy(scaffold_state_from_numpy(
            jax.device_get(jstate), spec, device="cpu"))
        got = scaffold_state_to_numpy(tnew)
        np.testing.assert_array_equal(tm["events"].numpy(),
                                      np.asarray(jm["events"]))
        assert int(tm["num_events"]) == int(jm["num_events"]) == 2
        fired += int(tm["num_events"])
        for f in ("c_server", "c_clients", "omega"):
            np.testing.assert_allclose(getattr(got, f), getattr(want, f),
                                       rtol=1e-4, atol=1e-6,
                                       err_msg=f"round {r} {f}")
        np.testing.assert_allclose(float(tm["train_loss"]),
                                   float(jm["train_loss"]), rtol=1e-4)
        np.testing.assert_array_equal(got.rng, want.rng)
        assert int(got.round) == r + 1
    assert fired == 10


def test_scaffold_converges_on_iid_quadratic():
    """tests/test_baselines.py's property, on the port."""
    rng = np.random.default_rng(0)
    d, n_pts, n = 4, 8, 4
    a = rng.normal(size=(n_pts, d)).astype(np.float32)
    theta_true = rng.normal(size=(d,)).astype(np.float32)
    b = (a @ theta_true).astype(np.float32)
    data = {"x": np.stack([a] * n), "y": np.stack([b] * n)}
    cfg = FLConfig(algorithm="fedavg", n_clients=n, participation=0.5,
                   lr=0.1, momentum=0.0, epochs=20, batch_size=n_pts)
    params0 = {"theta": torch.zeros(d)}
    spec = make_flat_spec(params0)
    state = init_scaffold(cfg, params0, spec=spec, device="cpu")
    round_fn = make_scaffold_round(cfg, _ls_loss, data, spec=spec,
                                   device="cpu")
    for _ in range(40):
        state, _ = round_fn(state)
    np.testing.assert_allclose(state.omega.numpy(), theta_true, atol=5e-2)


def test_scaffold_variates_change_only_for_participants():
    rng = np.random.default_rng(1)
    d, n_pts, n = 3, 6, 4
    data = {"x": rng.normal(size=(n, n_pts, d)).astype(np.float32),
            "y": rng.normal(size=(n, n_pts)).astype(np.float32)}
    cfg = FLConfig(algorithm="fedavg", n_clients=n, participation=0.25,
                   lr=0.05, momentum=0.0, epochs=4, batch_size=n_pts, seed=7)
    params0 = {"theta": torch.zeros(d)}
    spec = make_flat_spec(params0)
    state = init_scaffold(cfg, params0, spec=spec, device="cpu")
    prev = state.c_clients.clone()
    state2, m = make_scaffold_round(cfg, _ls_loss, data, spec=spec,
                                    device="cpu")(state)
    ev = m["events"].numpy()
    assert ev.sum() == 1
    new = state2.c_clients
    for i in range(n):
        if ev[i]:
            assert not torch.allclose(new[i], prev[i])
        else:
            assert torch.equal(new[i], prev[i])

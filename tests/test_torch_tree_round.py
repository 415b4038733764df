"""The tree client-state layout (``spec=None``) against live JAX.

* The state-synced harness of tests/test_torch_round.py on the tree
  layout — nested dicts of stacked (N, ...) leaves with the reference's
  keys — for the dense and compact forms of every algorithm of the
  round (fedback, fedadmm, admm, fedavg, fedprox) and the randomized
  selections: events equal off the 1e-5 margin, state at rtol 1e-4, the
  AVG family's ω at rtol 1e-6 / atol 1e-7.
* SCAFFOLD on the reference's own pytree state, stepped from the JAX
  state through the converter.
* The port's tree round against its own flat round from one state over
  10 free-running rounds: events equal, ω at rtol 1e-6 / atol 1e-7 (the
  reference's tests/test_flatstate.py property).
* The tree layout launches neither K2 nor K3 and refuses the fused
  commit, as the reference gates both on the flat layout.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.baselines import init_scaffold as jax_init_scaffold
from repro.core.baselines import make_scaffold_round as \
    jax_make_scaffold_round
from repro.models.mlp import make_loss_fn as jax_make_loss_fn
from repro.models.mlp import mlp_logits as jax_mlp_logits
from repro_torch.convert import flat_state, nest_params, params_from_numpy, \
    scaffold_state_from_numpy, scaffold_state_to_numpy
from repro_torch.core import ControllerConfig, FLConfig, init_scaffold, \
    init_state, make_round_fn, make_scaffold_round
from repro_torch.data import make_least_squares
from repro_torch.kernels import ops
from repro_torch.models import make_loss_fn
from repro_torch.utils import make_flat_spec
from test_torch_round import MLP_BASE, N, _assert_tree_close, _both, \
    _mlp_problem, _run_synced

AVG_OMEGA_TOL = (1e-6, 1e-7)
CONFIGS = {
    "fedback_dense": dict(),
    "fedback_compact": dict(compact=True),
    "fedadmm_dense": dict(algorithm="fedadmm"),
    "fedadmm_compact": dict(algorithm="fedadmm", compact=True),
    "admm_dense": dict(algorithm="admm"),
    "admm_compact": dict(algorithm="admm", compact=True),
    "fedavg_dense": dict(algorithm="fedavg", rho=0.0),
    "fedavg_compact": dict(algorithm="fedavg", rho=0.0, compact=True),
    "fedprox_dense": dict(algorithm="fedprox", mu=0.01),
    "fedprox_compact": dict(algorithm="fedprox", mu=0.01, compact=True),
    "fedback_bernoulli_dense": dict(selection="bernoulli"),
    "fedadmm_round_robin_compact": dict(algorithm="fedadmm",
                                        selection="round_robin",
                                        compact=True),
}


def _tparams(params):
    return nest_params(params_from_numpy(params, device="cpu"))


@pytest.mark.parametrize("name", list(CONFIGS))
def test_tree_rounds_match_jax(name):
    kw = CONFIGS[name]
    params, x, y = _mlp_problem()
    jcfg, tcfg = _both(dict(MLP_BASE, **kw), dict(K=1.0, alpha=0.9))
    avg = jcfg.algorithm in ("fedavg", "fedprox")
    seen = _run_synced(
        jcfg, tcfg, jax_make_loss_fn(jax_mlp_logits), make_loss_fn(),
        {"x": jnp.asarray(x), "y": jnp.asarray(y)}, {"x": x, "y": y},
        params, _tparams(params), rounds=4,
        omega_tol=AVG_OMEGA_TOL if avg else None, layout="tree")
    assert seen["flipped_rounds"] == 0
    if jcfg.algorithm == "admm":
        assert seen["events"] == 4 * N
    else:
        assert 0 < seen["events"] < 4 * N
    if jcfg.compact and jcfg.selection_name() == "fedback":
        assert seen["deferred"] > 0


def test_tree_state_holds_the_references_keys():
    params, _, _ = _mlp_problem()
    cfg = FLConfig(**dict(MLP_BASE, compact=True))
    state = init_state(cfg, _tparams(params), device="cpu")
    for f in ("theta", "lam", "z_prev"):
        tree = getattr(state, f)
        assert sorted(tree) == ["fc1", "fc2"]
        assert tree["fc1"]["w"].shape == (N,) + params["fc1"]["w"].shape
        assert tree["fc2"]["b"].shape == (N,) + params["fc2"]["b"].shape
    assert state.omega["fc1"]["w"].shape == params["fc1"]["w"].shape
    # θ, z_prev and ω are distinct buffers.
    ptrs = {getattr(state, f)["fc1"]["w"].data_ptr()
            for f in ("theta", "lam", "z_prev", "omega")}
    assert len(ptrs) == 4


@pytest.mark.parametrize("compact", [False, True])
def test_tree_round_launches_no_state_kernel(compact, monkeypatch):
    """The tree layout reaches K1 through K1c only; the dual algebra and
    the commit stay plain, as the reference gates K2 and K3 on flat."""
    calls = {"trigger_sq_norms_pytree": 0, "admm_update": 0, "fused_gss": 0}

    def spy(name):
        fn = getattr(ops, name)

        def wrapped(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return wrapped

    for name in calls:
        monkeypatch.setattr(ops, name, spy(name))
    params, x, y = _mlp_problem()
    cfg = FLConfig(**dict(MLP_BASE, compact=compact))
    round_fn = make_round_fn(cfg, make_loss_fn(), {"x": x, "y": y},
                             device="cpu")
    state = init_state(cfg, _tparams(params), device="cpu")
    for _ in range(2):
        state, _ = round_fn(state)
    assert calls == {"trigger_sq_norms_pytree": 2, "admm_update": 0,
                     "fused_gss": 0}


def test_tree_layout_refuses_the_fused_commit():
    params, x, y = _mlp_problem()
    cfg = FLConfig(**dict(MLP_BASE, compact=True, fused_gss=True))
    with pytest.raises(ValueError, match="flat"):
        make_round_fn(cfg, make_loss_fn(), {"x": x, "y": y}, device="cpu")


@pytest.mark.parametrize("problem", ["mlp", "least_squares"])
def test_tree_round_matches_flat_round(problem):
    """Ten free-running rounds of each layout from one initial state."""
    if problem == "mlp":
        params, x, y = _mlp_problem()
        params0, loss = _tparams(params), make_loss_fn()
        data = {"x": x, "y": y}
        cfg = FLConfig(**dict(MLP_BASE, compact=True))
    else:  # tests/test_flatstate.py's configuration
        data, params0, loss = make_least_squares(6, 8, 5, device="cpu")
        cfg = FLConfig(algorithm="fedback", n_clients=6, participation=0.5,
                       rho=1.0, lr=0.1, momentum=0.0, epochs=2, batch_size=4,
                       controller=ControllerConfig(K=0.2, alpha=0.9))
    spec = make_flat_spec(params0)
    runs = {}
    for layout, sp in (("tree", None), ("flat", spec)):
        state = init_state(cfg, params0, spec=sp, device="cpu")
        round_fn = make_round_fn(cfg, loss, data, spec=sp, device="cpu")
        events = []
        for _ in range(10):
            state, m = round_fn(state)
            events.append(m.events.tolist())
        runs[layout] = state, events
    (st_tree, ev_tree), (st_flat, ev_flat) = runs["tree"], runs["flat"]
    assert ev_tree == ev_flat
    assert 0 < sum(map(sum, ev_tree)) < 10 * cfg.n_clients
    np.testing.assert_allclose(st_flat.omega.numpy(),
                               spec.flatten(st_tree.omega).numpy(),
                               rtol=1e-6, atol=1e-7)
    as_flat = flat_state(st_tree, spec)
    for f in ("theta", "lam", "z_prev"):
        np.testing.assert_allclose(getattr(as_flat, f).numpy(),
                                   getattr(st_flat, f).numpy(), rtol=1e-5,
                                   atol=1e-6, err_msg=f)


def test_scaffold_tree_rounds_match_jax():
    """N = 4, 4 rounds on the reference's pytree state, each started
    from the JAX state."""
    n = 4
    params, x, y = _mlp_problem()
    x, y = x[:n], y[:n]
    jcfg, tcfg = _both(dict(algorithm="fedavg", n_clients=n,
                            participation=0.5, seed=11, lr=0.05,
                            momentum=0.9, epochs=2, batch_size=8), {})
    tparams = _tparams(params)
    jstate = jax_init_scaffold(jcfg, params)
    jround = jax_make_scaffold_round(jcfg, jax_make_loss_fn(jax_mlp_logits),
                                     {"x": jnp.asarray(x),
                                      "y": jnp.asarray(y)})
    tround = make_scaffold_round(tcfg, make_loss_fn(), {"x": x, "y": y},
                                 device="cpu")
    start = init_scaffold(tcfg, tparams, device="cpu")
    assert start.c_clients["fc1"]["w"].shape == (n,) + \
        params["fc1"]["w"].shape
    _assert_tree_close(scaffold_state_to_numpy(start)[:3],
                       jax.device_get(jstate)[:3], rtol=0, atol=0)
    fired = 0
    for r in range(4):
        before = jax.device_get(jstate)
        tnew, tm = tround(scaffold_state_from_numpy(before, device="cpu"))
        jstate, jm = jround(jstate)
        want = jax.device_get(jstate)
        got = scaffold_state_to_numpy(tnew)
        np.testing.assert_array_equal(tm["events"].numpy(),
                                      np.asarray(jm["events"]))
        fired += int(tm["num_events"])
        for f in ("c_server", "c_clients", "omega"):
            _assert_tree_close(getattr(got, f), getattr(want, f), rtol=1e-4,
                               atol=1e-6, err_msg=f"round {r} {f}")
        np.testing.assert_allclose(float(tm["train_loss"]),
                                   float(jm["train_loss"]), rtol=1e-4)
        np.testing.assert_array_equal(got.rng, np.asarray(want.rng))
    assert fired == 8


def test_tree_eval_fn_takes_the_tree_omega():
    from repro_torch.core import make_eval_fn
    from repro_torch.models import make_loss_and_acc_fn

    params, x, y = _mlp_problem()
    tparams = _tparams(params)
    cfg = FLConfig(**MLP_BASE)
    spec = make_flat_spec(tparams)
    laa = make_loss_and_acc_fn()
    xs, ys = torch.from_numpy(x[0]), torch.from_numpy(y[0])
    tree = make_eval_fn(laa, device="cpu")(
        init_state(cfg, tparams, device="cpu"), xs, ys)
    flat = make_eval_fn(laa, spec=spec, device="cpu")(
        init_state(cfg, tparams, spec=spec, device="cpu"), xs, ys)
    assert [float(v) for v in tree] == [float(v) for v in flat]

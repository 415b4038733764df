"""The client-sharded round (``mesh=``) against the reference's, and
against the port's own one-device round.

* State-synced against JAX: one subprocess (the reference needs
  ``--xla_force_host_platform_device_count`` before ``jax`` is imported)
  runs the reference's sharded round on forced host devices for each
  case below, five rounds each, and hands back the state before and
  after every round.  The port starts each round from the reference's
  state, cut into the same shards by ``convert.state_from_numpy(mesh=)``
  over a ``ClientMesh`` of P × ``cpu``, and must give the same events,
  ``committed``, event count, realized capacity and ``num_deferred``;
  the queue ages and event counts equal, δ and the loads within one ulp
  (XLA contracts δ + K·(L − L̄) into one FMA as it does the low-pass,
  ROADMAP D1, and with K = 0.2 the product is inexact); the
  state at rtol 1e-4 / atol 1e-6 and ω at rtol 1e-6 / atol 1e-7 (the
  consensus adds the shards' partial sums in shard order, the
  reference's all-reduce in its own).  The JAX side runs its Pallas
  kernels (K1b, K2b, K3) under ``shard_map`` in interpret mode.
* The port alone, as tests/test_sharded_engine.py::TestShardedEquivalence
  holds the reference: 8 shards against one device over 15 free-running
  rounds, events equal, ω at 1e-5.
"""
import json
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.convert import nest_params, params_from_numpy, \
    state_from_numpy, state_to_numpy
from repro_torch.core import ControllerConfig, FLConfig, init_state, \
    make_round_fn
from repro_torch.data import make_least_squares
from repro_torch.models import make_loss_fn
from repro_torch.sharding import make_client_mesh
from repro_torch.utils import make_flat_spec
from repro_torch.utils.pytree import tree_leaves

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N, ROUNDS = 8, 5
OMEGA_TOL = (1e-6, 1e-7)
LS = dict(algorithm="fedback", n_clients=N, participation=0.5, rho=1.0,
          lr=0.1, momentum=0.0, epochs=4, batch_size=8,
          capacity_slack=1.0, use_trigger_kernel=True, use_admm_kernel=True)
MLP = dict(LS, rho=0.01, lr=0.05, momentum=0.9, epochs=2, batch_size=6)
# name: (problem, layout, P, FLConfig keywords)
CASES = {
    "fedback_dense_flat": ("ls", "flat", 2, {}),
    "fedback_compact_fused_flat": ("ls", "flat", 2,
                                   dict(compact=True, fused_gss=True)),
    "fedback_compact_fused_flat_p4": ("ls", "flat", 4,
                                      dict(compact=True, fused_gss=True)),
    "fedback_tree_compact": ("mlp", "tree", 2, dict(compact=True)),
    "fedback_tree_dense": ("mlp", "tree", 2, {}),
    "fedadmm_random_compact": ("ls", "flat", 2,
                               dict(algorithm="fedadmm", compact=True)),
    "fedavg_dense": ("ls", "flat", 2, dict(algorithm="fedavg", rho=0.0)),
    "fedprox_compact": ("ls", "flat", 2,
                        dict(algorithm="fedprox", mu=0.1, compact=True)),
    "fedback_bernoulli_dense": ("ls", "flat", 2,
                                dict(selection="bernoulli")),
    "fedadmm_round_robin_compact": ("ls", "flat", 2,
                                    dict(algorithm="fedadmm",
                                         selection="round_robin",
                                         compact=True)),
}
CTRL = dict(K=0.2, alpha=0.9)

_JAX_SCRIPT = r"""
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import json, pickle, sys
import jax, jax.numpy as jnp, numpy as np
from repro.core import ControllerConfig, FLConfig, init_state, make_round_fn
from repro.core import make_flat_spec
from repro.data import make_least_squares
from repro.models.mlp import make_loss_fn, mlp_logits
from repro.sharding.clients import make_client_mesh

cases, ctrl, n, rounds, out_path = json.loads(sys.argv[1])
rng = np.random.default_rng(0)
mlp_params = {"fc1": {"w": (rng.normal(size=(6, 5)) * 0.4).astype(np.float32),
                      "b": np.zeros(5, np.float32)},
              "fc2": {"w": (rng.normal(size=(5, 3)) * 0.4).astype(np.float32),
                      "b": np.zeros(3, np.float32)}}
mlp_data = {"x": rng.random((n, 12, 6)).astype(np.float32),
            "y": rng.integers(0, 3, (n, 12)).astype(np.int32)}
ls_data, ls_params, ls_loss = make_least_squares(n, 8, 5)
problems = {"ls": (ls_data, ls_params, ls_loss),
            "mlp": ({k: jnp.asarray(v) for k, v in mlp_data.items()},
                    mlp_params, make_loss_fn(mlp_logits))}
out = {"mlp": (mlp_params, mlp_data), "runs": {}}
for name, (problem, layout, p, kw) in cases.items():
    data, params, loss = problems[problem]
    cfg = FLConfig(controller=ControllerConfig(**ctrl), **kw)
    spec = make_flat_spec(params) if layout == "flat" else None
    mesh = make_client_mesh(p)
    state = init_state(cfg, params, mesh=mesh, spec=spec)
    round_fn = make_round_fn(cfg, loss, data, mesh=mesh, spec=spec)
    steps = []
    for _ in range(rounds):
        before = jax.device_get(state)
        state, m = round_fn(state)
        steps.append((before, jax.device_get(state), jax.device_get(m)))
    out["runs"][name] = steps
with open(out_path, "wb") as f:
    pickle.dump(out, f)
"""


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The reference's sharded rounds of every case (one subprocess)."""
    path = tmp_path_factory.mktemp("sharded") / "runs.pkl"
    cases = {k: (pr, lay, p, dict(LS if pr == "ls" else MLP, **kw))
             for k, (pr, lay, p, kw) in CASES.items()}
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               JAX_PLATFORMS="cpu")
    out = subprocess.run(
        [sys.executable, "-c", _JAX_SCRIPT,
         json.dumps([cases, CTRL, N, ROUNDS, str(path)])], env=env,
        capture_output=True, text=True, timeout=600, cwd=REPO)
    assert out.returncode == 0, out.stderr[-3000:]
    with open(path, "rb") as f:  # written by the subprocess above
        return pickle.load(f)


def _problem(name, reference):
    if name == "ls":
        data, params, loss = make_least_squares(N, 8, 5, device="cpu")
        return data, params, loss
    params, data = reference["mlp"]
    return data, nest_params(params_from_numpy(params, device="cpu")), \
        make_loss_fn()


def _close(got, want, err_msg, rtol=1e-4, atol=1e-6):
    got, want = tree_leaves(got), tree_leaves(want)
    assert len(got) == len(want), err_msg
    for a, b in zip(got, want, strict=True):
        np.testing.assert_allclose(a, np.asarray(b), rtol=rtol, atol=atol,
                                   err_msg=err_msg)


def _margin(dist, delta):
    return np.abs(dist - delta) <= 1e-5 * np.maximum(1.0, np.abs(delta))


@pytest.mark.parametrize("case", list(CASES))
def test_sharded_round_matches_jax(case, reference):
    problem, layout, p, kw = CASES[case]
    cfg = FLConfig(controller=ControllerConfig(**CTRL),
                   **dict(LS if problem == "ls" else MLP, **kw))
    data, params, loss = _problem(problem, reference)
    spec = make_flat_spec(params) if layout == "flat" else None
    mesh = make_client_mesh(p, ["cpu"])
    round_fn = make_round_fn(cfg, loss, data, spec=spec, mesh=mesh)
    seen = {"events": 0, "deferred": 0}
    for r, (before, want, wm) in enumerate(reference["runs"][case]):
        shards = state_from_numpy(before, mesh=mesh)
        assert len(shards) == p and all(
            s.ctrl.delta.shape == (N // p,) for s in shards)
        new, m = round_fn(shards)
        assert len(new) == p
        got = state_to_numpy(new)  # also checks ω is one set of bits
        msg = f"{case} round {r}"
        dist, delta = np.asarray(wm.distances), np.asarray(before.ctrl.delta)
        np.testing.assert_allclose(m.distances.numpy(), dist, rtol=1e-6,
                                   atol=1e-7, err_msg=msg)
        off = ~_margin(dist, delta)
        ev = np.asarray(wm.events)
        np.testing.assert_array_equal(m.events.numpy()[off], ev[off],
                                      err_msg=msg)
        assert (m.events.numpy() == ev).all(), f"{msg}: a margin flip"
        seen["events"] += int(ev.sum())
        seen["deferred"] += int(wm.num_deferred)
        np.testing.assert_array_equal(m.committed.numpy(),
                                      np.asarray(wm.committed), err_msg=msg)
        for f in ("num_events", "num_deferred", "realized_capacity"):
            assert int(getattr(m, f)) == int(getattr(wm, f)), (msg, f)
        np.testing.assert_allclose(float(m.realized_slack),
                                   float(wm.realized_slack), rtol=1e-7)
        for a, b in ((got.ctrl.delta, want.ctrl.delta),
                     (got.ctrl.load, want.ctrl.load),
                     (got.queue.load, want.queue.load)):
            b = np.asarray(b)
            assert np.all(np.abs(a - b) <= np.spacing(np.maximum(
                np.abs(a), np.abs(b)))), msg
        np.testing.assert_array_equal(got.queue.age, want.queue.age)
        np.testing.assert_array_equal(got.ctrl.event_count,
                                      want.ctrl.event_count)
        for f in ("theta", "lam", "z_prev", "omega"):
            _close(getattr(got, f), getattr(want, f), f"{msg} {f}")
        _close(got.omega, want.omega, f"{msg} omega", *OMEGA_TOL)
        np.testing.assert_array_equal(got.rng, np.asarray(want.rng))
        assert int(got.round) == int(want.round) == r + 1
    assert seen["events"] > 0
    if cfg.compact and case != "fedadmm_round_robin_compact":
        assert seen["deferred"] > 0, case


def test_eight_shards_match_one_device():
    """tests/test_sharded_engine.py's property for the port: 8 shards of
    one client each against one device, 15 free-running rounds."""
    data, params, loss = make_least_squares(N, 8, 5, device="cpu")
    cfg = FLConfig(algorithm="fedback", n_clients=N, participation=0.5,
                   rho=1.0, lr=0.1, momentum=0.0, epochs=4, batch_size=8,
                   controller=ControllerConfig(K=0.2, alpha=0.9))
    mesh = make_client_mesh(8, ["cpu"])
    runs = {}
    for name, kw in (("single", dict(device="cpu")), ("sharded",
                                                      dict(mesh=mesh))):
        state = init_state(cfg, params, **kw)
        round_fn = make_round_fn(cfg, loss, data, **kw)
        events = []
        for _ in range(15):
            state, m = round_fn(state)
            events.append(m.events.to(torch.int32).tolist())
        runs[name] = (events, state)
    assert runs["single"][0] == runs["sharded"][0]
    assert runs["sharded"][0][0] == [1] * N
    shards = runs["sharded"][1]
    assert len(shards) == 8 and all(s.theta["theta"].shape == (1, 5)
                                    for s in shards)
    np.testing.assert_allclose(state_to_numpy(shards).omega["theta"],
                               runs["single"][1].omega["theta"].numpy(),
                               rtol=1e-5, atol=1e-5)

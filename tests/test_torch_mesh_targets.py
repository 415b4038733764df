"""The client-sharded round (``mesh=``) with a per-client target L̄.

The reference's controller takes an (N,) ``target_rate``, and its
sharded round reads the rows of it that match its sharded state.  The
port gives each shard its rows of the (N,) target (under
``max_staleness`` clamped by that shard's delays).  One subprocess runs
the reference's sharded round on 2 and 4 forced host devices with
L̄_i = linspace(0.05, 0.3, N), dense and compact, synchronous and
stale-tolerant, five rounds each; the port steps each round from the
reference's state (``convert.state_from_numpy(mesh=)`` over P × ``cpu``
shards) and is held as ``test_torch_async.check_sharded_case`` holds
the sharded stale round: events, ``committed`` and the counts equal,
the loads within one ulp and δ within one ulp of its operands (D1), the
state at rtol 1e-4 / atol 1e-6 and ω at rtol 1e-6 / atol 1e-7.
"""
import json
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.core import ControllerConfig, FLConfig, init_state, \
    make_round_fn
from repro_torch.convert import state_to_numpy
from repro_torch.data import make_least_squares
from repro_torch.sharding import make_client_mesh
from repro_torch.utils import make_flat_spec
from test_torch_async import MESH_LS, N_MESH, REPO, check_sharded_case

ROUNDS = 5
TARGETS = np.linspace(0.05, 0.3, N_MESH, dtype=np.float32).tolist()
CTRL = dict(K=0.5, alpha=0.9, target_rate=TARGETS)
SYNC = dict(MESH_LS, max_staleness=None)
CASES = {
    # name: (P, FLConfig keywords over MESH_LS)
    "dense_p2": (2, dict(max_staleness=None)),
    "dense_p4": (4, dict(max_staleness=None)),
    "compact_fused_p2": (2, dict(max_staleness=None, compact=True,
                                 fused_gss=True, capacity_slack=1.5)),
    "compact_fused_p4": (4, dict(max_staleness=None, compact=True,
                                 fused_gss=True, capacity_slack=1.5)),
    "compact_fused_s2_p2": (2, dict(compact=True, fused_gss=True,
                                    capacity_slack=1.5)),
    "dense_s2_p4": (4, {}),
}

SCRIPT = r"""
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import json, pickle, sys
import jax, jax.numpy as jnp, numpy as np
from repro.core import ControllerConfig, FLConfig, init_state, make_round_fn
from repro.core import make_flat_spec
from repro.data import make_least_squares
from repro.sharding.clients import make_client_mesh

cases, ctrl, n, rounds, out_path = json.loads(sys.argv[1])
ctrl["target_rate"] = jnp.asarray(ctrl["target_rate"], jnp.float32)
data, params, loss = make_least_squares(n, 8, 5)
spec = make_flat_spec(params)
out = {}
for name, (p, kw) in cases.items():
    cfg = FLConfig(controller=ControllerConfig(**ctrl), **kw)
    mesh = make_client_mesh(p)
    state = init_state(cfg, params, mesh=mesh, spec=spec)
    round_fn = make_round_fn(cfg, loss, data, mesh=mesh, spec=spec)
    steps = []
    for r in range(rounds):
        before = jax.device_get(state)
        state, m = round_fn(state)
        steps.append((before, jax.device_get(state), jax.device_get(m),
                      None))
    out[name] = steps
with open(out_path, "wb") as f:
    pickle.dump(out, f)
"""


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The reference's sharded rounds of every case (one subprocess)."""
    path = tmp_path_factory.mktemp("mesh_targets") / "runs.pkl"
    cases = {k: (p, dict(MESH_LS, **kw)) for k, (p, kw) in CASES.items()}
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               JAX_PLATFORMS="cpu")
    out = subprocess.run(
        [sys.executable, "-c", SCRIPT,
         json.dumps([cases, CTRL, N_MESH, ROUNDS, str(path)])], env=env,
        capture_output=True, text=True, timeout=600, cwd=REPO)
    assert out.returncode == 0, out.stderr[-3000:]
    with open(path, "rb") as f:  # written by the subprocess above
        return pickle.load(f)


@pytest.mark.parametrize("case", list(CASES))
def test_sharded_round_with_per_client_targets_matches_jax(case, reference):
    p, kw = CASES[case]
    steps = reference[case]
    seen = check_sharded_case(p, kw, steps, MESH_LS, ctrl=CTRL)
    assert seen["events"] > 0
    if kw.get("max_staleness", MESH_LS["max_staleness"]) is not None:
        assert seen["inflight"] > 0
    # The targets reached the controller per client: its integral law
    # moved δ by K·(L − L̄_i) with each client's own L̄_i.
    first_before, first_after, _, _ = steps[0]
    load = np.asarray(first_before.ctrl.load)
    step = np.asarray(first_after.ctrl.delta) - np.asarray(
        first_before.ctrl.delta)
    if kw.get("max_staleness", MESH_LS["max_staleness"]) is None:
        np.testing.assert_allclose(step, 0.5 * (load - np.asarray(TARGETS)),
                                   rtol=1e-6, atol=1e-7)
        assert len(set(step.tolist())) == N_MESH


def test_mesh_targets_equal_one_device():
    """Two shards with a per-client target against one device over ten
    free-running dense rounds (the compact plan's per-shard capacity
    defers other clients): the same events each round, δ bit-equal."""
    data, params, loss = make_least_squares(N_MESH, 8, 5, device="cpu")
    spec = make_flat_spec(params)
    ctrl = ControllerConfig(K=0.5, alpha=0.9, target_rate=torch.tensor(
        TARGETS, dtype=torch.float32))
    cfg = FLConfig(controller=ctrl, **SYNC)
    runs = {}
    for name, kw in (("one", dict(device="cpu")),
                     ("mesh", dict(mesh=make_client_mesh(2, ["cpu"])))):
        state = init_state(cfg, params, spec=spec, **kw)
        round_fn = make_round_fn(cfg, loss, data, spec=spec, **kw)
        events = []
        for _ in range(10):
            state, m = round_fn(state)
            events.append(m.events.tolist())
        runs[name] = (events, state_to_numpy(state).ctrl.delta)
    assert runs["one"][0] == runs["mesh"][0]
    np.testing.assert_array_equal(runs["one"][1], runs["mesh"][1])

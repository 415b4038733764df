"""The port's cross-pod round on a pod × data × model mesh
(``sharding/train.py``) against the JAX package's, on the CPU.

One subprocess forces 8 host devices before it imports ``jax`` and runs
the reference's (2, 2, 2) round of tests/test_distributed.py (granite
``.reduced(num_layers=2, d_model=128, vocab_size=512, remat=False)``
from its seed-0 init, K 0.05, α 0.9, L̄ 0.5, ρ 1e-3, lr 5e-3, 2 local
steps of 8 × 32 tokens, fsdp shardings, ``jax.jit`` with
``in_shardings`` / ``out_shardings``) for ten rounds, which fire both
pods and neither; then, from the same seed-0 init, 4 rounds each of
granite on (2, 2, 2) in tp and in fsdp_tp and of moonshot (the same
reduction, its 4 experts) on (2, 2, 1) in fsdp, the MoE on a data axis
of 2, jitted with its ``make_cross_pod_step``'s shardings.  It writes
every round's state and metrics to an npz, and the shardings of its
``make_cross_pod_step`` (built, not compiled) as JSON.

* State-synced: the port steps each round from the reference's state,
  carried across with ``convert.cross_pod_state_from_numpy`` and cut by
  the step's ``in_specs`` (``shard_tree``) on a CPU
  ``make_test_mesh((2, 2, 2), ("pod", "data", "model"))``, at
  tests/test_torch_crosspod.py's grades: events equal (off a 1e-5
  margin of δ, none seen), δ and the loads within one ulp, distances at
  rtol 1e-5, θ / λ / z_prev at rtol 1e-4 / atol 1e-6, ``train_loss`` at
  rtol 1e-5, the key and the round equal.
* The step's ``MeshArgs`` equal the reference's shardings' specs.
* The other modes' rounds, state-synced at the same grades, their
  ``MeshArgs`` the reference's.
* Free-running, the mesh round against the one-device round over 3
  rounds: at (2, 1, 2) bit for bit (one data shard: the same
  arithmetic but the distances' order of addition, which the events
  did not feel); at (2, 2, 2) the events equal and the state within
  rtol 1e-5 / atol 1e-7 (largest gap seen 3.0e-8).
* A leaf replicated over an axis counts once in the distances: the
  round that counts every replica is off the reference's.
* A pod that did not fire is not solved on the mesh.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro.core.controller import ControllerState as JaxControllerState
from repro.core.crosspod import CrossPodState as JaxCrossPodState
from repro_torch.configs import get_config
from repro_torch.convert import cross_pod_state_from_numpy, \
    cross_pod_state_to_numpy
from repro_torch.core.controller import ControllerConfig
from repro_torch.core.crosspod import CrossPodConfig, \
    init_cross_pod_state, make_cross_pod_round
from repro_torch.kernels import ops
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.launch.steps import make_cross_pod_step
from repro_torch.models import build_model
from repro_torch.sharding import train as mesh_train
from repro_torch.sharding.params import gather_tree, shard_tree
from repro_torch.sharding.train import cross_pod_batch_specs, \
    init_cross_pod_state_on_mesh, make_cross_pod_round_on_mesh
from repro_torch.utils.pytree import is_record, tree_leaves, tree_map
from torch_threads import _one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
AXES = ("pod", "data", "model")
ROUNDS, STEPS, B, S = 10, 2, 8, 32
STATE_TOL = dict(rtol=1e-4, atol=1e-6)
# the other modes' rounds: (tag, architecture, mode, mesh shape)
EXTRAS = [("tp", "granite-3-2b", "tp", (2, 2, 2)),
          ("fsdp_tp", "granite-3-2b", "fsdp_tp", (2, 2, 2)),
          ("moe", "moonshot-v1-16b-a3b", "fsdp", (2, 2, 1))]
EXTRA_ROUNDS = 4

_SCRIPT = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import json
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.configs import get_config
from repro.core.controller import ControllerConfig
from repro.core.crosspod import (CrossPodConfig, init_cross_pod_state,
                                 make_cross_pod_round)
from repro.launch.steps import make_cross_pod_step
from repro.models.api import build_model
from repro.sharding.actshard import activation_sharding
from repro.sharding.specs import param_specs, pod_stacked_specs

ROUNDS, STEPS, B, S = %d, %d, %d, %d
EXTRAS, EXTRA_ROUNDS = %r, %d
mesh = jax.sharding.Mesh(
    np.asarray(jax.devices()[:8]).reshape(2, 2, 2), ("pod", "data", "model"))
cfg = get_config("granite-3-2b").reduced(num_layers=2, d_model=128,
                                         vocab_size=512, remat=False)
model = build_model(cfg)
cp = CrossPodConfig(n_pods=2, rho=1e-3, lr=5e-3, local_steps=STEPS,
                    controller=ControllerConfig(K=0.05, alpha=0.9,
                                                target_rate=0.5))

def sharded_loss(params, batch):
    with activation_sharding(mesh, "data"):
        return model.loss(params, batch)

round_fn = make_cross_pod_round(cp, sharded_loss)
params0 = model.init(jax.random.PRNGKey(0))
state = init_cross_pod_state(cp, params0)
pspec = param_specs(jax.eval_shape(lambda: params0), mesh, mode="fsdp")
pod_pspec = pod_stacked_specs(pspec)
named = lambda t: jax.tree.map(lambda s: NamedSharding(mesh, s), t,
                               is_leaf=lambda x: isinstance(x, P))
state_sh = type(state)(
    theta=named(pod_pspec), lam=named(pod_pspec), z_prev=named(pod_pspec),
    ctrl=jax.tree.map(lambda _: NamedSharding(mesh, P()), state.ctrl),
    rng=NamedSharding(mesh, P()), round=NamedSharding(mesh, P()))
bsh = NamedSharding(mesh, P("pod", None, "data", None))
step = jax.jit(round_fn,
               in_shardings=(state_sh, {"tokens": bsh, "labels": bsh}),
               out_shardings=(state_sh, None))
out = {}

def put(prefix, tree):
    for path, x in jax.tree_util.tree_flatten_with_path(tree)[0]:
        key = prefix + "".join(
            "/" + str(getattr(p, "key", getattr(p, "name", None))) for p in path)
        out[key] = np.asarray(x)

rng = np.random.default_rng(0)
state = jax.device_put(state, state_sh)
put("s0", state)
for k in range(ROUNDS):
    toks = rng.integers(0, 512, (2, STEPS, B, S + 1))
    batch = {"tokens": jnp.asarray(toks[..., :-1], jnp.int32),
             "labels": jnp.asarray(toks[..., 1:], jnp.int32)}
    state, m = step(state, batch)
    put(f"s{k + 1}", state)
    put(f"m{k}", m)

def specs(tree):
    return jax.tree.map(lambda s: [list(e) if isinstance(e, tuple) else e
                                   for e in s.spec], tree,
                        is_leaf=lambda x: hasattr(x, "spec"))

_, in_sh, out_sh, _ = make_cross_pod_step(model, mesh, batch=2 * STEPS * B,
                                          seq=S)
printed = {"in_specs": specs(in_sh), "out_specs": specs(out_sh)}

# the other modes' rounds (EXTRAS: tag, architecture, mode, mesh shape)
for tag, arch, mode, shape in EXTRAS:
    xmesh = jax.sharding.Mesh(np.asarray(jax.devices()[:int(np.prod(
        shape))]).reshape(shape), ("pod", "data", "model"))
    xmodel = build_model(get_config(arch).reduced(
        num_layers=2, d_model=128, vocab_size=512, remat=False))

    def xloss(params, batch, xmesh=xmesh, xmodel=xmodel):
        with activation_sharding(xmesh, "data"):
            return xmodel.loss(params, batch)

    xparams = xmodel.init(jax.random.PRNGKey(0))
    xstate = init_cross_pod_state(cp, xparams)
    _, in_sh, out_sh, _ = make_cross_pod_step(
        xmodel, xmesh, batch=2 * STEPS * B, seq=S, mode=mode)
    printed[tag] = {"in_specs": specs(in_sh), "out_specs": specs(out_sh)}
    xstep = jax.jit(make_cross_pod_round(cp, xloss), in_shardings=in_sh,
                    out_shardings=out_sh)
    xstate = jax.device_put(xstate, in_sh[0])
    put(f"{tag}-s0", xstate)
    rng = np.random.default_rng(5)
    for k in range(EXTRA_ROUNDS):
        toks = rng.integers(0, 512, (2, STEPS, B, S + 1))
        batch = {"tokens": jnp.asarray(toks[..., :-1], jnp.int32),
                 "labels": jnp.asarray(toks[..., 1:], jnp.int32)}
        xstate, m = xstep(xstate, batch)
        put(f"{tag}-s{k + 1}", xstate)
        put(f"{tag}-m{k}", m)
np.savez(sys.argv[1], **out)
print(json.dumps(printed))
""" % (ROUNDS, STEPS, B, S, EXTRAS, EXTRA_ROUNDS)


@pytest.fixture(autouse=True)
def _counts_stay_zero():
    ops.reset_launch_counts()
    yield
    assert ops.launch_counts() == {k: 0 for k in ops.KERNELS}


def _nest(flat: dict, prefix: str) -> dict:
    """The npz's ``prefix/a/b`` entries as a nested dict."""
    out: dict = {}
    for key, v in flat.items():
        parts = key.split("/")
        if parts[0] != prefix:
            continue
        node = out
        for p in parts[1:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return out


@pytest.fixture(scope="module")
def _ran(tmp_path_factory):
    """The subprocess's arrays by key and its printed shardings."""
    path = tmp_path_factory.mktemp("crosspod_mesh") / "ref.npz"
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", _SCRIPT, str(path)],
                         env=env, capture_output=True, text=True,
                         timeout=400, cwd=REPO)
    assert out.returncode == 0, out.stderr[-3000:]
    with np.load(path) as f:
        flat = dict(f)
    path.unlink()
    return flat, json.loads(out.stdout.strip().splitlines()[-1])


def _rounds(flat, prefix, n, seed):
    """(state before, state after, metrics, batch) of each of ``n``
    rounds whose keys start with ``prefix``."""
    def state(r):
        t = _nest(flat, f"{prefix}s{r}")
        return JaxCrossPodState(theta=t["theta"], lam=t["lam"],
                                z_prev=t["z_prev"],
                                ctrl=JaxControllerState(**t["ctrl"]),
                                rng=t["rng"], round=t["round"])

    rng = np.random.default_rng(seed)
    rounds = []
    for r in range(n):
        toks = rng.integers(0, 512, (2, STEPS, B, S + 1))
        rounds.append((state(r), state(r + 1), _nest(flat, f"{prefix}m{r}"),
                       {"tokens": torch.from_numpy(toks[..., :-1]),
                        "labels": torch.from_numpy(toks[..., 1:])}))
    return rounds


@pytest.fixture(scope="module")
def reference(_ran):
    flat, printed = _ran
    return _rounds(flat, "", ROUNDS, 0), printed


def _setup():
    cfg = get_config("granite-3-2b").reduced(num_layers=2, d_model=128,
                                             vocab_size=512, remat=False)
    cp = CrossPodConfig(n_pods=2, rho=1e-3, lr=5e-3, local_steps=STEPS,
                        controller=ControllerConfig(K=0.05, alpha=0.9,
                                                    target_rate=0.5))
    return build_model(cfg), cp


def _step(shape=(2, 2, 2)):
    model, _ = _setup()
    mesh = make_test_mesh(shape, AXES)
    step, args = make_cross_pod_step(model, mesh, batch=2 * STEPS * B,
                                     seq=S, rho=1e-3, lr=5e-3)
    return model, mesh, args


def _within_ulp(got, want, *operands):
    got, want = np.asarray(got), np.asarray(want)
    scale = np.maximum.reduce([np.abs(got), np.abs(want)]
                              + [np.abs(np.asarray(o)) for o in operands])
    assert np.all(np.abs(got - want) <= np.spacing(scale)), (got, want)


def _listed(tree):
    """A spec tree (records as lists, tuple entries as lists), as the
    reference's JSON gives it."""
    if isinstance(tree, dict):
        return {k: _listed(v) for k, v in tree.items()}
    if is_record(tree):
        return [_listed(x) for x in tree]
    if tree is None:
        return None
    return [list(e) if isinstance(e, tuple) else e for e in tree]


def _mesh_round(model, cp, mesh):
    return make_cross_pod_round_on_mesh(cp, model, mesh)


def _sharded(before, args, mesh):
    return shard_tree(cross_pod_state_from_numpy(before, device="cpu"),
                      args.in_specs[0], mesh)


def test_the_steps_mesh_args_are_the_references_shardings(reference):
    _, want = reference
    _, _, args = _step()
    assert _listed(args.in_specs[0]) == want["in_specs"][0]
    assert _listed(args.in_specs[1]) == want["in_specs"][1]
    assert _listed(args.out_specs[0]) == want["out_specs"][0]
    assert args.out_specs[1] is None and want["out_specs"][1] is None


def test_rounds_match_the_references_mesh_round_state_synced(reference):
    rounds, _ = reference
    model, mesh, args = _step()
    _, cp = _setup()
    round_fn = _mesh_round(model, cp, mesh)
    fired, idle = _held_synced(rounds, round_fn, args, mesh)
    assert fired > 0 and idle > 0  # rounds that fire and that do not


def _held_synced(rounds, round_fn, args, mesh):
    """Each round stepped from the reference's state at the module
    note's grades → (the pods that fired, those that did not)."""
    fired = idle = 0
    for r, (before, want, wm, batch) in enumerate(rounds):
        state = _sharded(before, args, mesh)
        new, m = round_fn(state, shard_tree(batch, args.in_specs[1], mesh))
        got = cross_pod_state_to_numpy(gather_tree(new))
        msg = f"round {r}"
        dist, delta = wm["distances"], before.ctrl.delta
        np.testing.assert_allclose(m.distances.numpy(), dist, rtol=1e-5,
                                   atol=1e-7, err_msg=msg)
        margin = np.abs(dist - delta) <= 1e-5 * np.maximum(1.0, np.abs(delta))
        assert not margin.any() or r == 0, msg
        np.testing.assert_array_equal(m.events.numpy(), wm["events"],
                                      err_msg=msg)
        assert int(m.num_events) == int(wm["num_events"]), msg
        _within_ulp(m.delta.numpy(), wm["delta"], delta)
        _within_ulp(got.ctrl.delta, want.ctrl.delta, delta)
        _within_ulp(got.ctrl.load, want.ctrl.load)
        np.testing.assert_array_equal(got.ctrl.event_count,
                                      want.ctrl.event_count)
        for f in ("theta", "lam", "z_prev"):
            for g, w in zip(tree_leaves(getattr(got, f)),
                            tree_leaves(getattr(want, f)), strict=True):
                np.testing.assert_allclose(g, w, err_msg=msg, **STATE_TOL)
        np.testing.assert_allclose(float(m.train_loss),
                                   float(wm["train_loss"]), rtol=1e-5,
                                   err_msg=msg)
        np.testing.assert_array_equal(got.rng, want.rng)
        assert int(got.round) == int(want.round) == r + 1
        # every coordinate holds the same replica of the small state
        for b in new.blocks[1:]:
            first = new.blocks[0]
            assert all(torch.equal(x, y) for x, y in zip(
                [*b.ctrl, b.rng, b.round],
                [*first.ctrl, first.rng, first.round], strict=True))
        fired += int(wm["num_events"])
        idle += 2 - int(wm["num_events"])
    return fired, idle


@pytest.mark.parametrize("tag,arch,mode,shape", EXTRAS)
def test_other_modes_match_the_references_rounds_state_synced(
        _ran, tag, arch, mode, shape):
    """granite on (2, 2, 2) in tp and fsdp_tp, and moonshot (2 layers,
    its 4 experts) on (2, 2, 1) in fsdp — the MoE on a data axis of 2 —
    each round stepped from the reference's state at the grades above;
    the step's shardings the reference's."""
    flat, printed = _ran
    model = build_model(get_config(arch).reduced(
        num_layers=2, d_model=128, vocab_size=512, remat=False))
    _, cp = _setup()
    mesh = make_test_mesh(shape, AXES)
    _, args = make_cross_pod_step(model, mesh, batch=2 * STEPS * B, seq=S,
                                  rho=1e-3, lr=5e-3, mode=mode)
    want = printed[tag]
    assert _listed(args.in_specs[0]) == want["in_specs"][0]
    assert _listed(args.in_specs[1]) == want["in_specs"][1]
    assert _listed(args.out_specs[0]) == want["out_specs"][0]
    round_fn = make_cross_pod_round_on_mesh(cp, model, mesh, mode=mode)
    fired, _ = _held_synced(_rounds(flat, f"{tag}-", EXTRA_ROUNDS, 5),
                            round_fn, args, mesh)
    assert fired > 0


@pytest.mark.parametrize("shape", [(2, 1, 2), (2, 2, 2)])
def test_mesh_round_against_the_one_device_round(shape):
    model, cp = _setup()
    params0 = model.init(0, device="cpu")
    mesh = make_test_mesh(shape, AXES)
    one = init_cross_pod_state(cp, params0, device="cpu")
    on_mesh = init_cross_pod_state_on_mesh(cp, params0, mesh)
    round_one = make_cross_pod_round(cp, model.loss)
    round_mesh = _mesh_round(model, cp, mesh)
    rng = np.random.default_rng(1)
    for r in range(3):
        toks = torch.from_numpy(rng.integers(0, 512, (2, STEPS, B, S + 1)))
        batch = {"tokens": toks[..., :-1], "labels": toks[..., 1:]}
        one, m1 = round_one(one, batch)
        on_mesh, m2 = round_mesh(on_mesh, shard_tree(
            batch, cross_pod_batch_specs(batch), mesh))
        got = gather_tree(on_mesh)
        assert torch.equal(m1.events, m2.events), r
        torch.testing.assert_close(m2.distances, m1.distances, rtol=1e-6,
                                   atol=0)
        pairs = list(zip(tree_leaves(got), tree_leaves(one), strict=True))
        if shape[1] == 1:
            assert all(torch.equal(a, b) for a, b in pairs), r
            assert torch.equal(m2.train_loss, m1.train_loss)
        else:
            for a, b in pairs:
                torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-7)
            torch.testing.assert_close(m2.train_loss, m1.train_loss,
                                       rtol=1e-6, atol=0)


def test_replicated_leaves_count_once_in_the_distances(reference,
                                                       monkeypatch):
    """The norms are replicated over data and model and the embedding
    and head over data: counted on every replica, the distances of a
    round after the pods have moved apart are off the reference's far
    beyond its rtol 1e-5."""
    rounds, _ = reference
    model, mesh, args = _step()
    _, cp = _setup()
    before, _, wm, batch = rounds[3]
    counted = {}
    for name, owns in (("once", mesh_train._owns),
                       ("per replica", lambda *a: True)):
        monkeypatch.setattr(mesh_train, "_owns", owns)
        _, m = _mesh_round(model, cp, mesh)(
            _sharded(before, args, mesh),
            shard_tree(batch, args.in_specs[1], mesh))
        counted[name] = m.distances.numpy()
    np.testing.assert_allclose(counted["once"], wm["distances"], rtol=1e-5)
    gap = np.abs(counted["per replica"] / wm["distances"] - 1)
    assert (gap > 1e-2).all(), gap


def test_a_pod_that_did_not_fire_is_not_solved(monkeypatch):
    """δ set so that pod 0 fires and pod 1 does not: the loss runs
    local_steps times on each of pod 0's data shards only, pod 1's
    blocks keep their bits, and pod 0's z_prev is θ + λ."""
    model, cp = _setup()
    params0 = model.init(0, device="cpu")
    mesh = make_test_mesh((2, 2, 2), AXES)
    state = init_cross_pod_state_on_mesh(cp, params0, mesh)
    round_fn = _mesh_round(model, cp, mesh)
    rng = np.random.default_rng(2)

    def batch():
        toks = torch.from_numpy(rng.integers(0, 512, (2, STEPS, B, S + 1)))
        b = {"tokens": toks[..., :-1], "labels": toks[..., 1:]}
        return shard_tree(b, cross_pod_batch_specs(b), mesh)

    state, _ = round_fn(state, batch())  # both fire: the pods move apart
    for b in state.blocks:
        b.ctrl.delta.copy_(torch.tensor([0.0, 1e30]))
    before = tree_map(torch.clone, gather_tree(state))
    calls = []
    terms = mesh_train.loss_terms

    def counted(*a):
        calls.append(1)
        return terms(*a)

    monkeypatch.setattr(mesh_train, "loss_terms", counted)
    new, m = round_fn(state, batch())
    assert m.events.tolist() == [True, False]
    assert len(calls) == STEPS * mesh.shape["data"]
    got = gather_tree(new)
    for f in ("theta", "lam", "z_prev"):
        for g, b in zip(tree_leaves(getattr(got, f)),
                        tree_leaves(getattr(before, f)), strict=True):
            assert torch.equal(g[1], b[1])
            assert not torch.equal(g[0], b[0]) or f == "lam"
    for t, lm, z in zip(tree_leaves(got.theta), tree_leaves(got.lam),
                        tree_leaves(got.z_prev), strict=True):
        assert torch.equal(z[0], t[0] + lm[0])


def test_the_state_and_batch_must_be_cut_by_the_steps_specs():
    model, mesh, args = _step()
    _, cp = _setup()
    state = cross_pod_state_from_numpy(
        cross_pod_state_to_numpy(init_cross_pod_state(
            cp, model.init(0, device="cpu"), device="cpu")), device="cpu")
    round_fn = _mesh_round(model, cp, mesh)
    toks = torch.zeros((2, STEPS, B, S), dtype=torch.int64)
    batch = {"tokens": toks, "labels": toks}
    with pytest.raises(ValueError, match="in_specs"):
        round_fn(state, shard_tree(batch, args.in_specs[1], mesh))
    with pytest.raises(ValueError, match="cross_pod_batch_specs"):
        round_fn(shard_tree(state, args.in_specs[0], mesh), batch)
    tp_round = make_cross_pod_round_on_mesh(cp, model, mesh, mode="tp")
    with pytest.raises(ValueError, match="in_specs"):
        tp_round(shard_tree(state, args.in_specs[0], mesh),
                 shard_tree(batch, args.in_specs[1], mesh))
    with pytest.raises(ValueError, match="axes"):
        make_cross_pod_round_on_mesh(cp, model, make_test_mesh((2, 2)))

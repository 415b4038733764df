"""The port's cross-pod FedBack round (``core/crosspod.py``) against the
JAX package's ``make_cross_pod_round``, on the CPU.

The model is ``granite-3-2b`` ``.reduced()`` (2 layers, d_model 128,
vocab 512) from the reference's seed-0 init; the reference's round is
jitted on one CPU device; the batches are next-token pairs of 8 × 32
tokens a step, made with numpy from a seed, as the reference's
launcher makes them.  K = 0.05, α = 0.9, L̄ = 0.5, ρ = 1e-3, lr = 5e-3,
2 local steps.

* fp32, state-synced: ten rounds at P = 2 and P = 4, and six at P = 4
  with per-pod targets L̄ = (0.2, 0.45, 0.7, 0.95) (equal targets fire
  the pods together), each started from the reference's state (``convert.cross_pod_state_from_numpy``).
  Events and the event count equal (off a 1e-5 margin of δ, none seen),
  δ and the loads within one ulp of their operands (ROADMAP D1: XLA
  contracts the controller's products into FMAs), the event counts equal; the
  distances at rtol 1e-5 (a reduction); θ, λ and z_prev at rtol 1e-4 /
  atol 1e-6 (the solve grade: two SGD steps through autograd against
  ``jax.value_and_grad``); ``train_loss`` at rtol 1e-5; the key and the
  round equal.
* bf16: three state-synced rounds from the bf16 init.  XLA on the CPU
  keeps fp32 across a fused bf16 elementwise chain where torch rounds
  after each op, and the reference's Python scalars ρ, lr and the
  momentum are rounded to bf16 where torch multiplies in fp32; so each
  leaf's update (after − before) is held to 25% of the reference's
  update in norm, which a round that left the state unchanged (100%)
  or stepped it backwards (200%) fails; the loss at 1e-3.
* A 2-shard pod mesh gives one device's bits over 3 free-running
  rounds, at P = 2 and at P = 4 with the per-pod targets.
* A pod that did not fire is not solved: the loss runs local_steps
  times per firing pod, and the other pods' rows stay as they were.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_config as jax_get_config
from repro.core.controller import ControllerConfig as JaxControllerConfig
from repro.core.crosspod import CrossPodConfig as JaxCrossPodConfig
from repro.core.crosspod import init_cross_pod_state as jax_init_state
from repro.core.crosspod import make_cross_pod_round as jax_make_round
from repro.models.api import build_model as jax_build_model
from repro_torch.configs import get_config
from repro_torch.convert import cross_pod_state_from_numpy, \
    cross_pod_state_to_numpy
from repro_torch.core.controller import ControllerConfig
from repro_torch.core.crosspod import CrossPodConfig, \
    init_cross_pod_state, make_cross_pod_round
from repro_torch.kernels import ops
from repro_torch.models import build_model
from repro_torch.sharding import make_client_mesh
from repro_torch.utils.pytree import tree_leaves
from torch_threads import _one_torch_thread  # noqa: F401

ARCH = "granite-3-2b"
ROUNDS, STEPS, B, S = 10, 2, 8, 32
CP = dict(rho=1e-3, lr=5e-3, local_steps=STEPS)
CTRL = dict(K=0.05, alpha=0.9, target_rate=0.5)
STATE_TOL = dict(rtol=1e-4, atol=1e-6)


@pytest.fixture(autouse=True)
def _counts_stay_zero():
    ops.reset_launch_counts()
    yield
    assert ops.launch_counts() == {k: 0 for k in ops.KERNELS}


def _configs(p, dtype="float32", targets=None):
    """Both packages' model and round configs; ``targets`` a per-pod L̄."""
    jcfg = jax_get_config(ARCH).reduced(dtype=dtype)
    cfg = get_config(ARCH).reduced(dtype=dtype)
    jctrl, ctrl = dict(CTRL), dict(CTRL)
    if targets is not None:
        jctrl["target_rate"] = jnp.asarray(targets, jnp.float32)
        ctrl["target_rate"] = torch.tensor(targets, dtype=torch.float32)
    jcp = JaxCrossPodConfig(n_pods=p, controller=JaxControllerConfig(**jctrl),
                            **CP)
    cp = CrossPodConfig(n_pods=p, controller=ControllerConfig(**ctrl), **CP)
    return jcfg, cfg, jcp, cp


def _batches(p, rounds, vocab, seed=0):
    rng = np.random.default_rng(seed)
    for _ in range(rounds):
        toks = rng.integers(0, vocab, (p, STEPS, B, S + 1))
        yield ({"tokens": jnp.asarray(toks[..., :-1], jnp.int32),
                "labels": jnp.asarray(toks[..., 1:], jnp.int32)},
               {"tokens": torch.from_numpy(toks[..., :-1]),
                "labels": torch.from_numpy(toks[..., 1:])})


def _reference_run(p, rounds, dtype="float32", targets=None):
    """The reference's jitted rounds: per round (state before, state
    after, metrics, the port's batch), fetched to numpy."""
    jcfg, _, jcp, _ = _configs(p, dtype, targets)
    jmodel = jax_build_model(jcfg)
    round_fn = jax.jit(jax_make_round(jcp, jmodel.loss))
    state = jax_init_state(jcp, jax.jit(jmodel.init)(jax.random.PRNGKey(0)))
    steps = []
    for jb, tb in _batches(p, rounds, jcfg.vocab_size):
        before = jax.device_get(state)
        state, m = round_fn(state, jb)
        steps.append((before, jax.device_get(state), jax.device_get(m), tb))
    return steps


# Equal targets keep the pods' δ equal, and their distances fire them
# together; per-pod targets split them (rounds with some pods idle).
RUNS = {"p2": (2, ROUNDS, None), "p4": (4, ROUNDS, None),
        "p4_targets": (4, 6, (0.2, 0.45, 0.7, 0.95))}


@pytest.fixture(scope="module")
def reference():
    return {k: _reference_run(p, n, targets=t)
            for k, (p, n, t) in RUNS.items()}


def _within_ulp(got, want, *operands):
    """Within one ulp of the largest magnitude among the values and the
    operands they were computed from (D1: where δ + K·(L − L̄) cancels
    near 0, the FMA's gap is an ulp of the operands, not the result)."""
    got, want = np.asarray(got), np.asarray(want)
    scale = np.maximum.reduce([np.abs(got), np.abs(want)]
                              + [np.abs(np.asarray(o)) for o in operands])
    assert np.all(np.abs(got - want) <= np.spacing(scale)), (got, want)


@pytest.mark.parametrize("run", list(RUNS))
def test_rounds_match_jax_state_synced(run, reference):
    p, _, targets = RUNS[run]
    _, cfg, _, cp = _configs(p, targets=targets)
    round_fn = make_cross_pod_round(cp, build_model(cfg).loss)
    fired = idle = 0
    for r, (before, want, wm, batch) in enumerate(reference[run]):
        state = cross_pod_state_from_numpy(before, device="cpu")
        new, m = round_fn(state, batch)
        got = cross_pod_state_to_numpy(new)
        msg = f"P={p} round {r}"
        dist, delta = np.asarray(wm.distances), np.asarray(before.ctrl.delta)
        np.testing.assert_allclose(m.distances.numpy(), dist, rtol=1e-5,
                                   atol=1e-7, err_msg=msg)
        margin = np.abs(dist - delta) <= 1e-5 * np.maximum(1.0, np.abs(delta))
        assert not margin[1:].any() or r == 0, msg
        np.testing.assert_array_equal(m.events.numpy(), wm.events,
                                      err_msg=msg)
        assert int(m.num_events) == int(wm.num_events), msg
        _within_ulp(m.delta.numpy(), wm.delta, before.ctrl.delta)
        _within_ulp(got.ctrl.delta, want.ctrl.delta, before.ctrl.delta)
        _within_ulp(got.ctrl.load, want.ctrl.load)
        np.testing.assert_array_equal(got.ctrl.event_count,
                                      want.ctrl.event_count)
        for f in ("theta", "lam", "z_prev"):
            for g, w in zip(tree_leaves(getattr(got, f)),
                            jax.tree.leaves(getattr(want, f)), strict=True):
                np.testing.assert_allclose(g, np.asarray(w), err_msg=msg,
                                           **STATE_TOL)
        np.testing.assert_allclose(float(m.train_loss),
                                   float(wm.train_loss), rtol=1e-5,
                                   err_msg=msg)
        np.testing.assert_array_equal(got.rng, np.asarray(want.rng))
        assert int(got.round) == int(want.round) == r + 1
        fired += int(wm.num_events)
        idle += p - int(wm.num_events)
    assert fired > 0 and idle > 0  # both branches of the commit ran


BF16_ROUNDS, BF16_UPDATE_RTOL = 3, 0.25


def _update_error(before, after, want) -> float:
    """‖(after − before) − (want − before)‖ / ‖want − before‖ of one
    leaf, in fp32 (every bf16 value and difference of two is exact
    there); 0 for a leaf the reference left as it was and ``after``
    did too, inf where ``after`` moved it."""
    b = np.asarray(before, np.float32)
    du = np.asarray(after, np.float32) - np.asarray(want, np.float32)
    n = np.linalg.norm(np.asarray(want, np.float32) - b)
    err = np.linalg.norm(du)
    return err / n if n else (0.0 if err == 0 else np.inf)


def test_bf16_round_matches_jax():
    """Three state-synced bf16 rounds from the bf16 init, every one
    firing both pods: the events equal, each leaf's update of θ, λ and
    z_prev (after − before) within 25% of the reference's in norm, the
    loss at rtol 1e-3.  The updates differ (≤ 14% on the worst leaf,
    θ's and z's; λ's equal) because the two round each step's bf16
    arithmetic differently and a step moves most weights by an ulp or
    less.  The same check fails a round that leaves the state as it was
    (error 1) or steps it the wrong way (error 2): held below."""
    _, cfg, _, cp = _configs(2, "bfloat16")
    round_fn = make_cross_pod_round(cp, build_model(cfg).loss)
    steps = _reference_run(2, BF16_ROUNDS, dtype="bfloat16")
    for r, (before, want, wm, batch) in enumerate(steps):
        state = cross_pod_state_from_numpy(before, device="cpu")
        assert tree_leaves(state.theta)[0].dtype == torch.bfloat16
        new, m = round_fn(state, batch)
        assert np.asarray(wm.events).all(), r
        np.testing.assert_array_equal(m.events.numpy(), wm.events)
        got = cross_pod_state_to_numpy(new)
        moved = 0
        for f in ("theta", "lam", "z_prev"):
            for g, w, b in zip(tree_leaves(getattr(got, f)),
                               jax.tree.leaves(getattr(want, f)),
                               jax.tree.leaves(getattr(before, f)),
                               strict=True):
                assert _update_error(b, g, w) <= BF16_UPDATE_RTOL, (r, f)
                w32, b32 = np.asarray(w, np.float32), np.asarray(b, np.float32)
                if f == "theta" and np.any(w32 != b32):  # the check's power
                    moved += 1
                    assert _update_error(b, b, w) >= 1 - 1e-6
                    assert _update_error(b, 2 * b32 - w32, w) > 1.5
        # every weight matrix moves; the norms' scales (1) move by less
        # than half an ulp
        assert moved >= len(tree_leaves(got.theta)) - 3, r
        np.testing.assert_allclose(float(m.train_loss),
                                   float(wm.train_loss), rtol=1e-3)


@pytest.mark.parametrize("p,targets", [(2, None),
                                       (4, RUNS["p4_targets"][2])])
def test_two_shard_mesh_is_one_device_bit_for_bit(p, targets):
    _, cfg, _, cp = _configs(p, targets=targets)
    model = build_model(cfg)
    params0 = model.init(0, device="cpu")
    runs = {}
    mesh = make_client_mesh(2, ["cpu"])
    for name, kw in (("one", dict(device="cpu")), ("mesh", dict(mesh=mesh))):
        state = init_cross_pod_state(cp, params0, **kw)
        round_fn = make_cross_pod_round(cp, model.loss, mesh=kw.get("mesh"))
        metrics = []
        for _, batch in _batches(p, 3, cfg.vocab_size, seed=1):
            state, m = round_fn(state, batch)
            metrics.append(m)
        runs[name] = (cross_pod_state_to_numpy(state), metrics)
    shards = init_cross_pod_state(cp, params0, mesh=mesh)
    assert len(shards) == 2 and all(
        s.ctrl.delta.shape == (p // 2,) for s in shards)
    (one, m1), (sharded, m2) = runs["one"], runs["mesh"]
    for f in ("theta", "lam", "z_prev"):
        for a, b in zip(tree_leaves(getattr(one, f)),
                        tree_leaves(getattr(sharded, f)), strict=True):
            np.testing.assert_array_equal(a, b)
    for a, b in zip(m1, m2, strict=True):
        for f in a._fields:
            assert torch.equal(getattr(a, f), getattr(b, f)), f
    np.testing.assert_array_equal(one.ctrl.delta, sharded.ctrl.delta)


def test_pods_that_do_not_fire_are_not_solved(reference):
    """From the reference's state before a round in which some pods do
    not fire: the loss runs local_steps times per firing pod, the idle
    pods' θ, λ and z_prev rows keep their bits, and the round still
    agrees with the reference's (which solves every pod)."""
    p, _, targets = RUNS["p4_targets"]
    steps = reference["p4_targets"]
    r = next(i for i, (_, _, wm, _) in enumerate(steps)
             if 0 < int(wm.num_events) < p)
    before, want, wm, batch = steps[r]
    _, cfg, _, cp = _configs(p, targets=targets)
    model = build_model(cfg)
    calls = []

    def counted(params, micro):
        calls.append(1)
        return model.loss(params, micro)

    state = cross_pod_state_from_numpy(before, device="cpu")
    new, m = make_cross_pod_round(cp, counted)(state, batch)
    assert len(calls) == STEPS * int(wm.num_events)
    got = cross_pod_state_to_numpy(new)
    idle = ~np.asarray(wm.events)
    for f in ("theta", "lam", "z_prev"):
        for g, b in zip(tree_leaves(getattr(got, f)),
                        jax.tree.leaves(getattr(before, f)), strict=True):
            np.testing.assert_array_equal(g[idle], np.asarray(b)[idle])
    np.testing.assert_allclose(float(m.train_loss), float(wm.train_loss),
                               rtol=1e-5)


def test_state_round_trip(reference):
    before = reference["p2"][3][0]
    for kw in (dict(device="cpu"), dict(mesh=make_client_mesh(2, ["cpu"]))):
        back = cross_pod_state_to_numpy(cross_pod_state_from_numpy(before,
                                                                   **kw))
        for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(before),
                        strict=True):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_cross_pod_step_matches_its_abstract_arguments():
    """``launch.steps.make_cross_pod_step``: the abstract state and batch
    (meta tensors) have the shapes and dtypes of a real state and batch,
    and the step runs one round on them."""
    from repro_torch.launch.steps import make_cross_pod_step

    cfg = get_config(ARCH).reduced()
    model = build_model(cfg)
    step, (state_abs, batch_abs) = make_cross_pod_step(
        model, batch=2 * STEPS * 4, seq=16, n_pods=2, local_steps=STEPS)
    cp = CrossPodConfig(n_pods=2, local_steps=STEPS)
    state = init_cross_pod_state(
        cp, model.init(0, device="cpu"), device="cpu")
    for a, b in zip(tree_leaves(state_abs.theta), tree_leaves(state.theta),
                    strict=True):
        assert a.device.type == "meta"
        assert (a.shape, a.dtype) == (b.shape, b.dtype)
    assert state_abs.ctrl.delta.shape == state.ctrl.delta.shape
    assert tuple(batch_abs["tokens"].shape) == (2, STEPS, 4, 16)
    toks = torch.zeros(batch_abs["tokens"].shape, dtype=torch.int64)
    _, m = step(state, {"tokens": toks, "labels": toks})
    assert m.events.tolist() == [True, True]

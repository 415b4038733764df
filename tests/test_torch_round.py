"""The slice as a whole: port rounds against live JAX rounds, state-synced.

Every round starts from the JAX package's state (carried across with
``repro_torch.convert.state_from_numpy``), runs one port round on the
CPU, and is compared with the JAX round from the same state:

* events equal, except for clients whose distance lies within
  1e-5·max(1, |δ_i|) of their threshold (a sum taken in another order
  may fall on the other side); when the events agree everywhere, the
  committed set, the queue and the deferral count must be equal too,
  and the state is compared as below;
* δ and the queue ages bit-equal, the loads within one ulp (see
  tests/test_torch_core.py for the FMA XLA contracts there);
* θ, λ, z_prev and ω at rtol 1e-4 / atol 1e-6 (the local solve sums in
  another order); distances at rtol 1e-6;
* under compressed consensus, the EF residual ``comm`` by
  :func:`_assert_comm_close`: rows that sent nothing keep it bit for
  bit; the others within the solve's grade carried through δ = z − ω +
  e, 1e-4 of the largest |z| plus 1e-6, and one quantization step more
  where the two runs' δ fall on different codes (int8) or bf16 values;
  such flips are counted.

Three configurations: form A (compact, fused commit, trigger kernel),
form B (dense flat, trigger + ADMM kernels) on a small MLP, and the
least-squares golden-trace "sync" configuration of
tests/test_golden_trace.py, run against the live JAX run.  The JAX side
runs its Pallas kernels in interpret mode.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import ControllerConfig as JCtrl
from repro.core import FLConfig as JFLConfig
from repro.core import init_state as jax_init_state
from repro.core import make_flat_spec as jax_make_flat_spec
from repro.core import make_round_fn as jax_make_round_fn
from repro.data import make_least_squares as jax_make_least_squares
from repro.models.mlp import make_loss_fn as jax_make_loss_fn
from repro.models.mlp import mlp_logits as jax_mlp_logits
from repro_torch.convert import nest_params, params_from_numpy, \
    state_from_numpy, state_to_numpy
from repro_torch.core import ControllerConfig, FLConfig, make_round_fn
from repro_torch.data import make_least_squares
from repro_torch.models import make_loss_fn
from repro_torch.utils import make_flat_spec

N, N_PTS, N_IN, HIDDEN, N_OUT = 16, 24, 32, 16, 4


def _mlp_problem():
    rng = np.random.default_rng(0)
    params = {"fc1": {"w": rng.normal(size=(N_IN, HIDDEN)) * 0.25,
                      "b": np.zeros(HIDDEN)},
              "fc2": {"w": rng.normal(size=(HIDDEN, N_OUT)) * 0.35,
                      "b": np.zeros(N_OUT)}}
    params = {k: {kk: vv.astype(np.float32) for kk, vv in v.items()}
              for k, v in params.items()}
    x = rng.random((N, N_PTS, N_IN)).astype(np.float32)
    y = rng.integers(0, N_OUT, (N, N_PTS)).astype(np.int32)
    return params, x, y


def _both(cfg_kw, ctrl_kw):
    return (JFLConfig(controller=JCtrl(**ctrl_kw), **cfg_kw),
            FLConfig(controller=ControllerConfig(**ctrl_kw), **cfg_kw))


MLP_BASE = dict(algorithm="fedback", n_clients=N, participation=0.25,
                rho=0.01, lr=0.05, momentum=0.9, epochs=2, batch_size=8,
                capacity_slack=1.5, use_trigger_kernel=True,
                use_admm_kernel=True)
FORMS = {
    "A_compact_fused": dict(MLP_BASE, compact=True, fused_gss=True),
    "B_dense": dict(MLP_BASE, compact=False),
    "compact_unfused": dict(MLP_BASE, compact=True, fused_gss=False),
    # Vanilla consensus ADMM: FullSelection fires every client.
    "admm_full_dense": dict(MLP_BASE, algorithm="admm", compact=False),
}


def _margin_clients(dist, delta):
    return np.abs(dist - delta) <= 1e-5 * np.maximum(1.0, np.abs(delta))


def _assert_tree_close(got, want, **kw):
    """Leaf by leaf (sorted keys): a flat matrix or a tree layout dict."""
    got, want = jax.tree.leaves(got), jax.tree.leaves(want)
    assert len(got) == len(want)
    for a, b in zip(got, want, strict=True):
        assert a.shape == np.shape(b)
        np.testing.assert_allclose(a, np.asarray(b), **kw)


def _assert_update_close(got, want, before, tol, err_msg=""):
    """‖got − want‖ ≤ tol·‖want − before‖ over all leaves: the round's
    update agrees to ``tol`` of its norm."""
    def norm(*trees):
        return np.sqrt(sum(float(np.sum(np.square(
            np.asarray(a, np.float64) - np.asarray(b, np.float64))))
            for a, b in zip(*map(jax.tree.leaves, trees), strict=True)))
    update = norm(want, before)
    assert norm(got, want) <= tol * update, (err_msg, norm(got, want), update)


def _assert_comm_close(before, got, want, committed, mode, block,
                       err_msg=""):
    """The EF residual after one round from ``before`` (the module
    docstring's grade); returns the number of coordinates whose level-1
    code (int8) or bf16 value differs between the two runs."""
    from repro_torch.core.compress import ef_codes

    sent = np.ones(got.comm.shape[0], bool) if committed is None \
        else np.asarray(committed)
    np.testing.assert_array_equal(got.comm[~sent],
                                  np.asarray(before.comm)[~sent], err_msg)
    np.testing.assert_array_equal(np.asarray(want.comm)[~sent],
                                  np.asarray(before.comm)[~sent], err_msg)
    z_w = np.asarray(want.z_prev)
    def t(a):  # a copy: the reference's arrays are read-only
        return torch.tensor(np.asarray(a))

    (c_g, _), (c_w, step) = (
        (c["codes1"][0].numpy(), c["step1"][0].numpy()) for c in (
            ef_codes(t(z), t(before.omega), t(before.comm), mode=mode,
                     block=block) for z in (got.z_prev, z_w)))
    flips = c_g != c_w
    tol = 1e-4 * float(np.abs(z_w).max()) + 1e-6 + np.where(flips, step, 0.0)
    gap = np.abs(got.comm - np.asarray(want.comm))
    assert np.all(gap[sent] <= tol[sent]), (err_msg, float(gap.max()))
    return int(flips[sent].sum())


def _jax_ragged(spec):
    """The reference's ``RaggedSpec`` with the fields of the port's."""
    from repro.utils.ragged import RaggedBucket as JBucket
    from repro.utils.ragged import RaggedSpec as JRagged

    return JRagged(sizes=spec.sizes, offsets=spec.offsets, buckets=tuple(
        JBucket(capacity=b.capacity, members=b.members, padded=b.padded)
        for b in spec.buckets))


def _run_synced(jcfg, tcfg, jloss, tloss, jdata, tdata, jparams, tparams,
                rounds, omega_tol=None, layout="flat", update_tol=None,
                trace=None, ragged=None):
    """Step both packages from the JAX state for ``rounds`` rounds and
    compare as the module docstring says; ``omega_tol`` (rtol, atol)
    holds ω tighter as well.  ``layout="tree"`` runs both on the tree
    client-state layout (``spec=None``).  ``update_tol`` compares the
    state by :func:`_assert_update_close` instead of element by element
    (for models whose ReLU and max-pool kinks let one fp32 rounding
    route a gradient elsewhere).  ``trace`` (a (rounds, N) bool array)
    builds both rounds with ``arrivals_arg=True`` and hands round r
    row r.  ``ragged`` (the port's ``RaggedSpec``, with the data pooled)
    runs both on ragged clients, the reference with the same spec.
    Under ``max_staleness`` the in-flight and landed counts, the delays,
    countdowns and event ring must be equal too, and the parked
    payloads agree as the state does.  Returns counts of what the run
    saw."""
    jspec = tspec = None
    if layout == "flat":
        jspec = jax_make_flat_spec(jparams)
        tspec = make_flat_spec(tparams)
        assert jspec.dim == tspec.dim
    serve = trace is not None
    jstate = jax_init_state(jcfg, jparams, spec=jspec)
    jround = jax_make_round_fn(
        jcfg, jloss, jdata, spec=jspec, arrivals_arg=serve,
        ragged=None if ragged is None else _jax_ragged(ragged))
    tround = make_round_fn(tcfg, tloss, tdata, spec=tspec, device="cpu",
                           arrivals_arg=serve, ragged=ragged)
    seen = {"events": 0, "deferred": 0, "flipped_rounds": 0, "landed": 0,
            "inflight": 0, "code_flips": 0}
    for r in range(rounds):
        before = jax.device_get(jstate)
        arrivals = () if not serve else (np.asarray(trace[r], bool),)
        tnew, tm = tround(state_from_numpy(before, device="cpu"),
                          *map(torch.from_numpy, arrivals))
        jstate, jm = jround(jstate, *map(jnp.asarray, arrivals))
        want, wm = jax.device_get(jstate), jax.device_get(jm)
        got = state_to_numpy(tnew)
        dist, delta = np.asarray(wm.distances), np.asarray(before.ctrl.delta)
        np.testing.assert_allclose(tm.distances.numpy(), dist, rtol=1e-6,
                                   atol=1e-7, err_msg=f"round {r}")
        margin = _margin_clients(dist, delta)
        ev_t, ev_j = tm.events.numpy(), np.asarray(wm.events)
        np.testing.assert_array_equal(ev_t[~margin], ev_j[~margin],
                                      err_msg=f"round {r}")
        seen["events"] += int(ev_j.sum())
        seen["deferred"] += int(wm.num_deferred)
        seen["landed"] += int(wm.num_landed)
        seen["inflight"] += int(wm.num_inflight)
        if (ev_t != ev_j).any():  # a margin client fell the other way
            seen["flipped_rounds"] += 1
            continue
        np.testing.assert_array_equal(tm.committed.numpy(),
                                      np.asarray(wm.committed))
        for f in ("num_events", "num_deferred", "realized_capacity",
                  "num_inflight", "num_landed"):
            assert int(getattr(tm, f)) == int(getattr(wm, f)), (r, f)
        assert got.ctrl.delta.tobytes() == np.asarray(
            want.ctrl.delta).tobytes(), r
        for a, b in ((got.ctrl.load, want.ctrl.load),
                     (got.queue.load, want.queue.load)):
            b = np.asarray(b)
            assert np.all(np.abs(a - b) <= np.spacing(np.maximum(
                np.abs(a), np.abs(b)))), r
        np.testing.assert_array_equal(got.queue.age, np.asarray(
            want.queue.age))
        np.testing.assert_array_equal(got.ctrl.event_count, np.asarray(
            want.ctrl.event_count))
        for f in ("theta", "lam", "z_prev", "omega"):
            if update_tol is not None:
                _assert_update_close(getattr(got, f), getattr(want, f),
                                     getattr(before, f), update_tol,
                                     err_msg=f"round {r} {f}")
                continue
            _assert_tree_close(getattr(got, f), getattr(want, f), rtol=1e-4,
                               atol=1e-6, err_msg=f"round {r} {f}")
        if omega_tol is not None:
            _assert_tree_close(got.omega, want.omega, rtol=omega_tol[0],
                               atol=omega_tol[1], err_msg=f"round {r} omega")
        assert (got.inflight is None) == (want.inflight is None), r
        if want.inflight is not None:
            for f in ("delay", "ttl", "hist"):
                np.testing.assert_array_equal(
                    getattr(got.inflight, f),
                    np.asarray(getattr(want.inflight, f)),
                    err_msg=f"round {r} inflight.{f}")
            for f in ("theta", "lam", "z"):
                _assert_tree_close(getattr(got.inflight, f),
                                   getattr(want.inflight, f), rtol=1e-4,
                                   atol=1e-6, err_msg=f"round {r} parked {f}")
        assert (got.comm is None) == (want.comm is None), r
        if want.comm is not None:
            committed = (None if jcfg.algorithm in ("fedback", "fedadmm",
                                                    "admm")
                         else np.asarray(wm.committed))
            seen["code_flips"] += _assert_comm_close(
                before, got, want, committed, jcfg.consensus_compress,
                jcfg.compress_block, err_msg=f"round {r} comm")
        np.testing.assert_array_equal(got.rng, np.asarray(want.rng))
        assert int(got.round) == int(want.round) == r + 1
    return seen


@pytest.mark.parametrize("form", list(FORMS))
def test_mlp_rounds_match_jax(form):
    params, x, y = _mlp_problem()
    jcfg, tcfg = _both(FORMS[form], dict(K=1.0, alpha=0.9))
    seen = _run_synced(
        jcfg, tcfg, jax_make_loss_fn(jax_mlp_logits), make_loss_fn(),
        {"x": jnp.asarray(x), "y": jnp.asarray(y)},
        {"x": x, "y": y}, params,
        nest_params(params_from_numpy(params, device="cpu")), rounds=5)
    # The run exercised the trigger (and, compacted, the queue).
    if jcfg.algorithm == "admm":
        assert seen["events"] == 5 * N
    else:
        assert 0 < seen["events"] < 5 * N
    if jcfg.compact:
        assert seen["deferred"] > 0
    assert seen["flipped_rounds"] == 0


# The kernel ops each form of the round calls once per round.
OPS_PER_ROUND = {
    "A_compact_fused": dict(trigger_sq_norms_pytree=1, admm_update=0,
                            fused_gss=1),
    "B_dense": dict(trigger_sq_norms_pytree=1, admm_update=1, fused_gss=0),
    "compact_unfused": dict(trigger_sq_norms_pytree=1, admm_update=1,
                            fused_gss=0),
}


@pytest.mark.parametrize("form", list(OPS_PER_ROUND))
def test_round_goes_through_the_kernel_ops(form, monkeypatch):
    """The round reaches its kernels only through ``kernels.ops`` (which
    launches the kernel for a CUDA tensor), whatever the config's kernel
    flags say: here they are left at False."""
    from repro_torch.core import init_state
    from repro_torch.kernels import ops

    calls = dict.fromkeys(OPS_PER_ROUND[form], 0)

    def spy(name):
        fn = getattr(ops, name)

        def wrapped(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return wrapped

    for name in calls:
        monkeypatch.setattr(ops, name, spy(name))
    params, x, y = _mlp_problem()
    kw = dict(FORMS[form], use_trigger_kernel=False, use_admm_kernel=False)
    cfg = FLConfig(controller=ControllerConfig(K=1.0, alpha=0.9), **kw)
    tparams = nest_params(params_from_numpy(params, device="cpu"))
    spec = make_flat_spec(tparams)
    round_fn = make_round_fn(cfg, make_loss_fn(), {"x": x, "y": y},
                             spec=spec, device="cpu")
    state = init_state(cfg, tparams, spec=spec, device="cpu")
    for _ in range(2):
        state, _ = round_fn(state)
    assert calls == {k: 2 * v for k, v in OPS_PER_ROUND[form].items()}
    assert all(v == 0 for v in ops.launch_counts().values())


def test_state_round_trip():
    params, _, _ = _mlp_problem()
    jcfg, _ = _both(FORMS["A_compact_fused"], dict(K=1.0, alpha=0.9))
    want = jax.device_get(jax_init_state(jcfg, params,
                                         spec=jax_make_flat_spec(params)))
    got = state_to_numpy(state_from_numpy(want, device="cpu"))
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want),
                    strict=True):
        np.testing.assert_array_equal(a, np.asarray(b))
        assert a.dtype == np.asarray(b).dtype


def test_golden_sync_configuration_matches_jax():
    """tests/test_golden_trace.py::_run_trace("sync"): N=64 least squares,
    compact, slack 1.25, K=0.5, α=0.9 — 30 rounds, each state-synced."""
    kw = dict(algorithm="fedback", n_clients=64, participation=0.25,
              rho=1.0, lr=0.1, momentum=0.0, epochs=2, batch_size=4, seed=0,
              compact=True, capacity_slack=1.25)
    jcfg, tcfg = _both(kw, dict(K=0.5, alpha=0.9))
    jdata, jparams, jls = jax_make_least_squares(64, 8, 5)
    tdata, tparams, tls = make_least_squares(64, 8, 5, device="cpu")
    np.testing.assert_array_equal(tdata["x"].numpy(), np.asarray(jdata["x"]))
    np.testing.assert_array_equal(tdata["y"].numpy(), np.asarray(jdata["y"]))
    seen = _run_synced(jcfg, tcfg, jls, tls, jdata, tdata, jparams, tparams,
                       rounds=30)
    assert seen["events"] > 0 and seen["deferred"] > 0
    assert seen["flipped_rounds"] == 0

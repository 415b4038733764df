"""Compressed consensus (``repro_torch.core.compress``) against the live
JAX package.

* The quantizers: the int8 codes and scales and the bf16 round trip bit-
  equal to the reference's (jitted, as the round runs them), with the
  reference's round-trip bounds.
* The error-feedback aggregation, ``ef_consensus`` and
  ``ef_participant_mean``, against the reference's under ``jax.jit`` (its
  round is jitted: XLA's fusions decide the order of the column sum and
  which products become FMAs, ROADMAP D6): ω and the level-1 codes bit-
  equal; the residual bit-equal except in the last D mod 8 columns, which
  XLA's vectorised loop leaves uncontracted (``e + werr·(1/m)`` rounded
  twice), where it lies within two ulp of its column's largest value.
  The same under P = 2 and 4 client shards against the reference's
  ``mesh=`` on forced host devices (a subprocess).
* The invariants of tests/test_compress.py on the port: prefix
  conservation for both means, zero committed, ``"none"`` the exact
  uncompressed program, the tree layout refused, compressed ω tracking
  the fp32 ω.
* Whole rounds state-synced against JAX through
  tests/test_torch_round.py's harness (the residual by its
  ``_assert_comm_close``): the golden "int8" configuration of
  tests/test_golden_trace.py over 30 rounds, a bf16 dense, a FedAvg int8
  and a 2-shard int8 run over 10 — events identical in every round.
"""
import dataclasses
import json
import os
import pickle
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import compress as jc
from repro.data import make_least_squares as jax_make_least_squares
from repro_torch.convert import state_from_numpy, state_to_numpy
from repro_torch.core import ControllerConfig, FLConfig, init_state, \
    make_round_fn
from repro_torch.core import compress as tc
from repro_torch.data import make_least_squares
from repro_torch.sharding import make_client_mesh, shard_rows
from repro_torch.utils import make_flat_spec
from test_torch_round import _assert_comm_close, _both, _run_synced

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EF_SHAPES = [(64, 8, 256), (33, 1000, 64), (100, 2053, 256)]
MESH_SHAPES = [(64, 1000, 64), (100, 2053, 256)]


def _inputs(n, d, seed=0):
    rng = np.random.default_rng(seed)
    z = rng.standard_normal((n, d)).astype(np.float32)
    omega = (rng.standard_normal(d) * 0.5).astype(np.float32)
    resid = (rng.standard_normal((n, d)) * 0.01).astype(np.float32)
    mask = rng.random(n) < 0.4
    return z, omega, resid, mask


def _jax_ef(masked, z, omega, resid, mask, mode, block, mesh=None):
    if masked:
        fn = jax.jit(lambda *a: jc.ef_participant_mean(
            *a, mode=mode, block=block, mesh=mesh))
        return fn(z, mask, omega, resid, jnp.int32(mask.sum()))
    return jax.jit(lambda *a: jc.ef_consensus(
        *a, mode=mode, block=block, mesh=mesh))(z, omega, resid)


def _torch_ef(masked, z, omega, resid, mask, mode, block, mesh=None):
    t = torch.from_numpy
    zz, rr, mm = (t(z), t(resid), t(mask))
    if mesh is not None:
        zz, rr, mm = (list(shard_rows(x, mesh)) for x in (zz, rr, mm))
    if masked:
        out = tc.ef_participant_mean(
            zz, mm, t(omega), rr, torch.tensor(int(mask.sum()),
                                               dtype=torch.int32),
            mode=mode, block=block, mesh=mesh)
    else:
        out = tc.ef_consensus(zz, t(omega), rr, mode=mode, block=block,
                              mesh=mesh)
    omega_new, resid_new = out
    if mesh is not None:
        resid_new = torch.cat(resid_new)
    return omega_new.numpy(), resid_new.numpy()


def _tail(d):
    """The columns XLA's 8-wide loops leave uncontracted."""
    return np.arange(d) >= d - d % 8


def _assert_ef_equal(got, want, d, label):
    (w_t, e_t), (w_j, e_j) = got, (np.asarray(want[0]), np.asarray(want[1]))
    assert w_t.tobytes() == w_j.tobytes(), f"{label}: ω not bit-equal"
    tail = _tail(d)
    head_t, head_j = e_t[:, ~tail], e_j[:, ~tail]
    assert head_t.tobytes() == head_j.tobytes(), \
        f"{label}: residual differs off the tail columns"
    if tail.any():
        bound = 2 * np.spacing(np.abs(e_j[:, tail]).max(axis=0))
        assert np.all(np.abs(e_t[:, tail] - e_j[:, tail]) <= bound), label


# --- quantizers -----------------------------------------------------------


@pytest.mark.parametrize("seed", range(6))
def test_int8_quantize_bit_equal_and_bounded(seed):
    rng = np.random.default_rng(seed)
    n, d, block = (int(rng.integers(1, 12)), int(rng.integers(1, 300)),
                   int(rng.integers(1, 300)))
    x = (rng.standard_normal((n, d)) * 10.0 ** rng.uniform(-3, 3)).astype(
        np.float32)
    jcodes, jscales = jax.jit(lambda a: jc.int8_quantize(a, block=block))(x)
    codes, scales = tc.int8_quantize(torch.from_numpy(x), block=block)
    np.testing.assert_array_equal(codes.numpy(), np.asarray(jcodes))
    assert scales.numpy().tobytes() == np.asarray(jscales).tobytes()
    nb, b = tc.block_layout(d, block)
    assert codes.shape == (n, nb, b) and codes.dtype == torch.int8
    back = tc.int8_dequantize(codes, scales, d).numpy()
    pad = nb * b - d
    xb = np.pad(x, [(0, 0), (0, pad)]).reshape(n, nb, b)
    bound = (np.abs(xb).max(axis=-1, keepdims=True) / (2 * 127)
             * (1 + 1e-5) + 1e-7)
    err = np.pad(np.abs(back - x), [(0, 0), (0, pad)]).reshape(n, nb, b)
    assert (err <= bound).all()


@pytest.mark.parametrize("seed", range(4))
def test_bf16_round_trip_bit_equal_and_bounded(seed):
    x = np.random.default_rng(seed).standard_normal((5, 77)).astype(
        np.float32)
    back = tc.quantize_dequantize(torch.from_numpy(x), "bf16").numpy()
    want = np.asarray(jax.jit(lambda a: jc.quantize_dequantize(
        a, "bf16"))(x))
    assert back.tobytes() == want.tobytes()
    assert (np.abs(back - x) <= np.abs(x) * 2.0 ** -8 + 1e-30).all()


def test_zero_vector_is_exact_and_none_is_identity():
    z = torch.zeros(3, 40)
    codes, scales = tc.int8_quantize(z, block=16)
    assert not codes.any() and not scales.any()
    assert not tc.int8_dequantize(codes, scales, 40).any()
    x = torch.randn(2, 7)
    assert torch.equal(tc.quantize_dequantize(x, "none"), x)


@pytest.mark.parametrize("dim,block", [(16, 256), (300, 128), (5, 1),
                                       (159010, 256)])
def test_block_layout_and_modes_match_the_reference(dim, block):
    assert tc.block_layout(dim, block) == jc.block_layout(dim, block)
    assert tc.MODES == jc.MODES and tc.WIRE_BYTES == jc.WIRE_BYTES
    assert tc.INT8_CLIP == jc.INT8_CLIP
    with pytest.raises(ValueError, match="consensus_compress"):
        tc.check_mode("fp8")


@pytest.mark.parametrize("mode", ["none", "bf16", "int8"])
@pytest.mark.parametrize("world", [1, 2, 8])
def test_wire_bytes_model_matches_the_reference(mode, world):
    for dim in (64, 159010):
        assert tc.consensus_wire_bytes(dim, mode=mode, world_size=world) \
            == jc.consensus_wire_bytes(dim, mode=mode, world_size=world)


# --- the EF aggregation against the reference ----------------------------


@pytest.mark.parametrize("masked", [False, True],
                         ids=["consensus", "participant"])
@pytest.mark.parametrize("mode", ["int8", "bf16"])
@pytest.mark.parametrize("shape", EF_SHAPES, ids=lambda s: "x".join(map(
    str, s)))
def test_ef_aggregation_bit_equal_to_jax(shape, mode, masked):
    n, d, block = shape
    z, omega, resid, mask = _inputs(n, d)
    got = _torch_ef(masked, z, omega, resid, mask, mode, block)
    want = _jax_ef(masked, z, omega, resid, mask, mode, block)
    _assert_ef_equal(got, want, d, f"{shape} {mode}")
    if mode == "int8":  # the level-1 codes of the deltas
        delta = z - omega[None] + resid
        jcodes, _ = jax.jit(lambda a: jc.int8_quantize(a, block=block))(
            delta)
        codes, _ = tc.int8_quantize(torch.from_numpy(delta), block=block)
        np.testing.assert_array_equal(codes.numpy(), np.asarray(jcodes))


_MESH_EF_SCRIPT = r"""
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import json, pickle, sys
import jax, jax.numpy as jnp, numpy as np
from repro.core import compress as jc
from repro.core import ControllerConfig, FLConfig, init_state, \
    make_flat_spec, make_round_fn
from repro.data import make_least_squares
from repro.sharding.clients import make_client_mesh

shapes, cases, rounds, out_path = json.loads(sys.argv[1])
ef = {}
for p in (2, 4):
    mesh = make_client_mesh(p)
    for n, d, block in shapes:
        rng = np.random.default_rng(0)
        z = rng.standard_normal((n, d)).astype(np.float32)
        omega = (rng.standard_normal(d) * 0.5).astype(np.float32)
        resid = (rng.standard_normal((n, d)) * 0.01).astype(np.float32)
        mask = rng.random(n) < 0.4
        for mode in ("int8", "bf16"):
            c = jax.jit(lambda *a: jc.ef_consensus(
                *a, mode=mode, block=block, mesh=mesh))(z, omega, resid)
            m = jax.jit(lambda *a: jc.ef_participant_mean(
                *a, mode=mode, block=block, mesh=mesh))(
                    z, mask, omega, resid, jnp.int32(mask.sum()))
            ef[str((p, n, d, block, mode))] = jax.device_get((c, m))
data, params, loss = make_least_squares(64, 8, 5)
spec = make_flat_spec(params)
runs = {}
for name, (p, kw) in cases.items():
    cfg = FLConfig(controller=ControllerConfig(K=0.5, alpha=0.9), **kw)
    mesh = make_client_mesh(p)
    state = init_state(cfg, params, mesh=mesh, spec=spec)
    round_fn = make_round_fn(cfg, loss, data, mesh=mesh, spec=spec)
    steps = []
    for _ in range(rounds):
        before = jax.device_get(state)
        state, m = round_fn(state)
        steps.append((before, jax.device_get(state), jax.device_get(m)))
    runs[name] = steps
with open(out_path, "wb") as f:
    pickle.dump({"ef": ef, "runs": runs}, f)
"""

GOLDEN = dict(algorithm="fedback", n_clients=64, participation=0.25, rho=1.0,
              lr=0.1, momentum=0.0, epochs=2, batch_size=4, seed=0,
              compact=True, capacity_slack=1.25)
MESH_CASES = {"int8_p2": (2, dict(GOLDEN, consensus_compress="int8"))}
MESH_ROUNDS = 10


@pytest.fixture(scope="module")
def mesh_reference(tmp_path_factory):
    """The reference's sharded EF aggregations and 2-shard int8 rounds
    (one subprocess on 4 forced host devices)."""
    path = tmp_path_factory.mktemp("compress_mesh") / "ref.pkl"
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               JAX_PLATFORMS="cpu")
    out = subprocess.run(
        [sys.executable, "-c", _MESH_EF_SCRIPT,
         json.dumps([MESH_SHAPES, MESH_CASES, MESH_ROUNDS, str(path)])],
        env=env, capture_output=True, text=True, timeout=600, cwd=REPO)
    assert out.returncode == 0, out.stderr[-3000:]
    with open(path, "rb") as f:  # written by the subprocess above
        return pickle.load(f)


@pytest.mark.parametrize("masked", [False, True],
                         ids=["consensus", "participant"])
@pytest.mark.parametrize("mode", ["int8", "bf16"])
@pytest.mark.parametrize("shape", MESH_SHAPES, ids=lambda s: "x".join(map(
    str, s)))
@pytest.mark.parametrize("p", [2, 4])
def test_sharded_ef_aggregation_bit_equal_to_jax(p, shape, mode, masked,
                                                 mesh_reference):
    n, d, block = shape
    z, omega, resid, mask = _inputs(n, d)
    got = _torch_ef(masked, z, omega, resid, mask, mode, block,
                    mesh=make_client_mesh(p, ["cpu"]))
    want = mesh_reference["ef"][str((p, n, d, block, mode))][int(masked)]
    _assert_ef_equal(got, want, d, f"P={p} {shape} {mode}")


def test_sharded_ef_conserves_and_clips_the_wire():
    """Level 2 over 4 shards: codes clipped to ±⌊127/4⌋, and Σ e⁺ + the
    transmitted total equals Σ δ (the wire error folded back)."""
    n, d = 8, 12
    z, omega, resid, _ = _inputs(n, d, seed=3)
    resid[:] = 0
    mesh = make_client_mesh(4, ["cpu"])
    w_new, e_new = _torch_ef(False, z, omega, resid, np.zeros(n, bool), "int8", 4,
                             mesh=mesh)
    lhs = e_new.astype(np.float64).sum(0) + (w_new - omega).astype(
        np.float64) * n
    rhs = (z - omega[None]).astype(np.float64).sum(0)
    assert np.abs(lhs - rhs).max() < 2e-4


# --- invariants (tests/test_compress.py on the port) ----------------------


@pytest.mark.parametrize("mode", ["none", "bf16", "int8"])
@pytest.mark.parametrize("seed", range(3))
def test_consensus_prefix_conservation(mode, seed):
    rng = np.random.default_rng(seed)
    n, d = int(rng.integers(2, 12)), int(rng.integers(3, 40))
    omega = torch.zeros(d)
    resid = tc.init_residual(n, d, device="cpu")
    for r in range(5):
        z = torch.from_numpy(rng.standard_normal((n, d)).astype(np.float32))
        omega_new, resid_new = tc.ef_consensus(z, omega, resid, mode=mode,
                                               block=8)
        lhs = (resid_new.double().sum(0)
               + (omega_new - omega).double() * n)
        rhs = resid.double().sum(0) + (z - omega[None]).double().sum(0)
        torch.testing.assert_close(lhs, rhs, rtol=2e-4, atol=2e-4)
        omega, resid = omega_new, resid_new


@pytest.mark.parametrize("mode", ["bf16", "int8"])
@pytest.mark.parametrize("seed", range(3))
def test_participant_prefix_conservation(mode, seed):
    rng = np.random.default_rng(seed ^ 0xC0FFEE)
    n, d = int(rng.integers(2, 12)), int(rng.integers(3, 40))
    omega = torch.zeros(d)
    resid = tc.init_residual(n, d, device="cpu")
    for r in range(5):
        z = torch.from_numpy(rng.standard_normal((n, d)).astype(np.float32))
        mask = torch.from_numpy(rng.random(n) < 0.5)
        m = int(mask.sum())
        omega_new, resid_new = tc.ef_participant_mean(
            z, mask, omega, resid, torch.tensor(m, dtype=torch.int32),
            mode=mode, block=8)
        lhs = (resid_new.double().sum(0)
               + (omega_new - omega).double() * max(m, 1))
        rhs = (resid.double().sum(0)
               + (z - omega[None]).double()[mask].sum(0))
        torch.testing.assert_close(lhs, rhs, rtol=2e-4, atol=2e-4)
        assert torch.equal(resid_new[~mask], resid[~mask])
        omega, resid = omega_new, resid_new


def test_zero_committed_leaves_omega_and_residual():
    n, d = 6, 9
    z, omega, resid, _ = _inputs(n, d, seed=7)
    o2, r2 = tc.ef_participant_mean(
        torch.from_numpy(z), torch.zeros(n, dtype=torch.bool),
        torch.from_numpy(omega), torch.from_numpy(resid),
        torch.tensor(0, dtype=torch.int32), mode="int8")
    assert torch.equal(o2, torch.from_numpy(omega))
    assert torch.equal(r2, torch.from_numpy(resid))


def _variant_cfgs(n):
    base = FLConfig(algorithm="fedback", n_clients=n, participation=0.5,
                    rho=1.0, lr=0.1, momentum=0.0, epochs=1, batch_size=4,
                    seed=0, controller=ControllerConfig(K=0.5, alpha=0.9))
    compact = dict(compact=True, participation=0.25, capacity_slack=1.5)
    return {"dense": base,
            "compact": dataclasses.replace(base, **compact),
            "fused": dataclasses.replace(base, fused_gss=True, **compact),
            "staleness": dataclasses.replace(base, max_staleness=2,
                                             **compact),
            "serve": dataclasses.replace(base, **compact),
            "fedavg": dataclasses.replace(base, algorithm="fedavg",
                                          rho=0.0)}


def _run_variant(cfg, rounds=6, mesh=None, serve=False, mode=None):
    if mode is not None:
        cfg = dataclasses.replace(cfg, consensus_compress=mode)
    data, params, loss = make_least_squares(cfg.n_clients, 8, 5,
                                            device="cpu")
    spec = make_flat_spec(params)
    where = {"mesh": mesh} if mesh is not None else {"device": "cpu"}
    state = init_state(cfg, params, spec=spec, **where)
    round_fn = make_round_fn(cfg, loss, data, spec=spec, arrivals_arg=serve,
                             **where)
    rng = np.random.default_rng(123)
    events = []
    for _ in range(rounds):
        args = (torch.from_numpy(rng.random(cfg.n_clients) < 0.7),) \
            if serve else ()
        state, m = round_fn(state, *args)
        events.append(m.events.numpy())
    return np.stack(events), state_to_numpy(state)


@pytest.mark.parametrize("variant", ["dense", "compact", "fused",
                                     "staleness", "serve", "fedavg"])
@pytest.mark.parametrize("shards", [1, 2])
def test_none_is_the_uncompressed_round(variant, shards):
    cfg = _variant_cfgs(16)[variant]
    mesh = make_client_mesh(shards, ["cpu"]) if shards > 1 else None
    ev_a, st_a = _run_variant(cfg, mesh=mesh, serve=variant == "serve")
    ev_b, st_b = _run_variant(cfg, mesh=mesh, serve=variant == "serve",
                              mode="none")
    assert st_a.comm is None and st_b.comm is None
    np.testing.assert_array_equal(ev_a, ev_b)
    for a, b in zip(jax.tree.leaves(st_a), jax.tree.leaves(st_b),
                    strict=True):
        assert np.asarray(a).tobytes() == np.asarray(b).tobytes()


def test_tree_layout_refused():
    n = 8
    data, params, loss = make_least_squares(n, 8, 5, device="cpu")
    cfg = dataclasses.replace(_variant_cfgs(n)["dense"],
                              consensus_compress="int8")
    with pytest.raises(ValueError, match="flat"):
        init_state(cfg, params, device="cpu")
    spec = make_flat_spec(params)
    state = init_state(cfg, params, spec=spec, device="cpu")
    assert state.comm.shape == (n, spec.dim) and not state.comm.any()
    with pytest.raises(ValueError, match="flat"):
        make_round_fn(cfg, loss, data, device="cpu")
    shards = init_state(cfg, params, spec=spec,
                        mesh=make_client_mesh(2, ["cpu"]))
    assert [s.comm.shape for s in shards] == [(n // 2, spec.dim)] * 2


@pytest.mark.parametrize("mode", ["bf16", "int8"])
def test_compressed_tracks_fp32_omega(mode):
    cfg = _variant_cfgs(16)["compact"]
    _, ref = _run_variant(cfg, rounds=20)
    _, got = _run_variant(cfg, rounds=20, mode=mode)
    scale = max(float(np.abs(ref.omega).max()), 1e-6)
    drift = float(np.abs(got.omega - ref.omega).max()) / scale
    assert drift < 5e-2, f"{mode} ω drifted {drift:.3%} from fp32"
    assert np.abs(got.comm).max() > 0  # the feedback is live


# --- whole rounds, state-synced against JAX --------------------------------


def _ls_synced(kw, rounds, trace=None):
    jcfg, tcfg = _both(kw, dict(K=0.5, alpha=0.9))
    jdata, jparams, jls = jax_make_least_squares(64, 8, 5)
    tdata, tparams, tls = make_least_squares(64, 8, 5, device="cpu")
    return _run_synced(jcfg, tcfg, jls, tls, jdata, tdata, jparams, tparams,
                       rounds=rounds, trace=trace)


def test_golden_int8_configuration_matches_jax():
    """tests/test_golden_trace.py::_run_trace("int8"): N = 64 least
    squares, compact, slack 1.25, K = 0.5, α = 0.9, int8 — 30 rounds."""
    seen = _ls_synced(dict(GOLDEN, consensus_compress="int8"), 30)
    assert seen["events"] > 0 and seen["deferred"] > 0
    assert seen["flipped_rounds"] == 0 and seen["code_flips"] == 0


@pytest.mark.parametrize("name,kw", [
    ("bf16_dense", dict(GOLDEN, compact=False, consensus_compress="bf16")),
    ("fedavg_int8", dict(GOLDEN, algorithm="fedavg", rho=0.0,
                         compact=False, consensus_compress="int8")),
    ("fedprox_int8_compact", dict(GOLDEN, algorithm="fedprox", mu=0.1,
                                  consensus_compress="int8")),
    ("int8_staleness", dict(GOLDEN, max_staleness=2,
                            consensus_compress="int8")),
    ("int8_served_s2", dict(GOLDEN, max_staleness=2, fused_gss=True,
                            consensus_compress="int8")),
])
def test_compressed_round_matches_jax(name, kw):
    # the served case: an i.i.d. arrival trace, p = 0.5
    trace = (np.random.default_rng(5).random((10, 64)) < 0.5
             if name.endswith("served_s2") else None)
    seen = _ls_synced(kw, 10, trace=trace)
    assert seen["events"] > 0 and seen["flipped_rounds"] == 0
    assert seen["code_flips"] == 0


def test_sharded_int8_round_matches_jax(mesh_reference):
    """Two client shards, int8 (level 2 on the wire): each of the
    reference's 10 rounds stepped by the port from the same state —
    events, committed and counts equal, the state at rtol 1e-4, the
    residual by ``_assert_comm_close``."""
    p, kw = MESH_CASES["int8_p2"]
    cfg = FLConfig(controller=ControllerConfig(K=0.5, alpha=0.9), **kw)
    data, params, loss = make_least_squares(64, 8, 5, device="cpu")
    spec = make_flat_spec(params)
    mesh = make_client_mesh(p, ["cpu"])
    round_fn = make_round_fn(cfg, loss, data, spec=spec, mesh=mesh)
    events = 0
    for r, (before, want, wm) in enumerate(mesh_reference["runs"]["int8_p2"]):
        new, m = round_fn(state_from_numpy(before, mesh=mesh))
        got = state_to_numpy(new)
        for f in ("events", "committed"):
            np.testing.assert_array_equal(getattr(m, f).numpy(),
                                          getattr(wm, f), err_msg=f"{r} {f}")
        for f in ("num_events", "num_deferred", "realized_capacity"):
            assert int(getattr(m, f)) == int(getattr(wm, f)), (r, f)
        for f in ("theta", "lam", "z_prev", "omega"):
            np.testing.assert_allclose(getattr(got, f),
                                       np.asarray(getattr(want, f)),
                                       rtol=1e-4, atol=1e-6,
                                       err_msg=f"round {r} {f}")
        assert _assert_comm_close(before, got, want, None, "int8",
                                  cfg.compress_block, f"round {r}") == 0
        events += int(np.asarray(wm.events).sum())
    assert events > 0

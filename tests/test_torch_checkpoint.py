"""Checkpoints of the port (``repro_torch.checkpoint``) against the JAX
package's store.

* Twins of tests/test_checkpoint.py's ``TestStore`` and ``TestDtypes``
  on the port's states and trees of tensors, and of its park-buffer
  round trip (a stale-tolerant run resumed bit for bit).
* The ``__treedef__`` string equal to live JAX's ``str(tree_structure)``
  for the flat synchronous state, the flat ``max_staleness=2`` state,
  the tree layout, the flat int8 state (``comm``) and ``ScaffoldState``.
* Resume across packages, both ways: a checkpoint of the reference's
  run, loaded by the port, gives the reference's next round at the
  state-synced grades of tests/test_torch_round.py (events equal; the
  state at rtol 1e-4 / atol 1e-6; the EF residual by its
  ``_assert_comm_close``); a checkpoint of the port's run, loaded by
  ``repro.checkpoint.load_checkpoint``, gives the port's next round.
  For fp32 leaves, for θ saved in bf16 and resumed into fp32, and for
  an int8 run's residual.
* A resumed run of the port is bit-equal to the uninterrupted one; a
  client mesh's state saved at P = 2 resumes at P = 2 (bit for bit) and
  at P = 1.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import load_checkpoint as jax_load
from repro.checkpoint import save_checkpoint as jax_save
from repro.core import init_state as jax_init_state
from repro.core import make_flat_spec as jax_make_flat_spec
from repro.core import make_round_fn as jax_make_round_fn
from repro.core.baselines import init_scaffold as jax_init_scaffold
from repro.data import make_least_squares as jax_make_least_squares
from repro_torch import prng
from repro_torch.checkpoint import latest_checkpoint, load_checkpoint, \
    save_checkpoint
from repro_torch.checkpoint.store import treedef_str
from repro_torch.convert import state_from_numpy, state_to_numpy
from repro_torch.core import FLConfig, init_scaffold, init_state, \
    make_round_fn
from repro_torch.data import make_least_squares
from repro_torch.models import init_mlp
from repro_torch.sharding import make_client_mesh
from repro_torch.utils import make_flat_spec
from test_torch_round import _assert_comm_close, _both

N_LS = 16
LS = dict(algorithm="fedback", n_clients=N_LS, participation=0.25, rho=1.0,
          lr=0.1, momentum=0.0, epochs=2, batch_size=4, seed=0,
          compact=True, capacity_slack=1.5)
CTRL = dict(K=0.5, alpha=0.9)


def _state():
    cfg = FLConfig(algorithm="fedback", n_clients=5, participation=0.2)
    params = init_mlp(prng.PRNGKey(0, device="cpu"), 16, 8, 4,
                      device="cpu")
    return cfg, init_state(cfg, params, device="cpu")


def _leaves(tree):
    return jax.tree.leaves(tree)


def _bits(x):
    """(dtype, shape, bytes) of a tensor (bf16 through its int16 view) or
    an array."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        raw = x.view(torch.int16) if x.dtype == torch.bfloat16 else x
        return str(x.dtype), tuple(x.shape), raw.numpy().tobytes()
    x = np.asarray(x)
    return str(x.dtype), x.shape, x.tobytes()


def _bytes_equal(a, b):
    return _bits(a) == _bits(b)


def _assert_state_equal(a, b):
    """Two states (a port state or shard list, or numpy leaves) hold the
    same bits, leaf by leaf, in the reference's form."""
    def host(s):
        return state_to_numpy(s) if any(isinstance(x, torch.Tensor)
                                        for x in _leaves(s)) else s
    la, lb = _leaves(host(a)), _leaves(host(b))
    assert len(la) == len(lb)
    for x, y in zip(la, lb, strict=True):
        x, y = np.asarray(x), np.asarray(y)
        assert x.dtype == y.dtype and x.tobytes() == y.tobytes()


class TestStore:
    def test_roundtrip_flstate(self, tmp_path):
        _, state = _state()
        path = save_checkpoint(str(tmp_path), 3, state)
        assert path.endswith("ckpt_00000003.npz")
        restored = load_checkpoint(path, state)
        assert type(restored) is type(state)
        for a, b in zip(_leaves(state), _leaves(restored), strict=True):
            assert _bytes_equal(a, b)

    def test_latest_discovery(self, tmp_path):
        _, state = _state()
        save_checkpoint(str(tmp_path), 1, state)
        p5 = save_checkpoint(str(tmp_path), 5, state)
        save_checkpoint(str(tmp_path), 2, state)
        assert latest_checkpoint(str(tmp_path)) == p5
        assert latest_checkpoint(str(tmp_path), prefix="other") is None

    def test_missing_dir(self, tmp_path):
        assert latest_checkpoint(str(tmp_path / "nonexistent")) is None

    def test_shape_mismatch_raises(self, tmp_path):
        cfg, state = _state()
        path = save_checkpoint(str(tmp_path), 0, state)
        bad = state._replace(omega=init_mlp(prng.PRNGKey(1, device="cpu"),
                                            16, 9, 4, device="cpu"))
        with pytest.raises(ValueError, match="shape mismatch"):
            load_checkpoint(path, bad)

    def test_missing_leaf_raises(self, tmp_path):
        path = save_checkpoint(str(tmp_path), 0, {"a": torch.zeros(2)})
        with pytest.raises(KeyError, match="missing leaf"):
            # the treedef sidecar is checked first: drop it from the file
            with np.load(path) as zf:
                entries = {k: zf[k] for k in zf.files
                           if k != "__treedef__"}
            np.savez(path, **entries)
            load_checkpoint(path, {"b": torch.zeros(2)})

    def test_leaves_come_back_on_the_template_device_and_numpy_stays(
            self, tmp_path):
        tree = {"t": torch.arange(3, dtype=torch.int32),
                "a": np.arange(4, dtype=np.float32)}
        path = save_checkpoint(str(tmp_path), 0, tree)
        out = load_checkpoint(path, tree)
        assert isinstance(out["t"], torch.Tensor) and torch.equal(
            out["t"], tree["t"])
        assert isinstance(out["a"], np.ndarray)
        np.testing.assert_array_equal(out["a"], tree["a"])


class TestDtypes:
    def _mixed_tree(self):
        rng = np.random.default_rng(0)
        return {
            "theta_bf16": torch.from_numpy(rng.normal(size=(4, 3)).astype(
                np.float32)).to(torch.bfloat16),
            "omega_f32": torch.from_numpy(rng.normal(size=(3,)).astype(
                np.float32)),
            "age_i32": torch.tensor([0, 2, 5, 1], dtype=torch.int32),
            "mask_bool": torch.tensor([True, False, True]),
            "count_u32": np.asarray([7, 9], np.uint32),
        }

    def test_bf16_and_mixed_dtype_roundtrip_exact(self, tmp_path):
        tree = self._mixed_tree()
        path = save_checkpoint(str(tmp_path), 0, tree)
        restored = load_checkpoint(path, tree)
        for key in tree:
            assert _bytes_equal(tree[key], restored[key]), key

    def test_bf16_checkpoint_resumes_into_f32_template(self, tmp_path):
        tree = {"w": torch.tensor([1.5, -2.25, 0.125],
                                  dtype=torch.bfloat16)}
        path = save_checkpoint(str(tmp_path), 0, tree)
        restored = load_checkpoint(path, {"w": torch.zeros(3)})
        assert restored["w"].dtype == torch.float32
        assert restored["w"].tolist() == [1.5, -2.25, 0.125]

    def test_f32_checkpoint_resumes_into_bf16_template(self, tmp_path):
        path = save_checkpoint(str(tmp_path), 0,
                               {"w": torch.tensor([1.5, -2.25])})
        restored = load_checkpoint(
            path, {"w": torch.zeros(2, dtype=torch.bfloat16)})
        assert restored["w"].dtype == torch.bfloat16
        assert restored["w"].float().tolist() == [1.5, -2.25]

    def test_matching_signedness_int_cast_is_allowed(self, tmp_path):
        path = save_checkpoint(str(tmp_path), 0, {
            "age": torch.tensor([1, 2, 3], dtype=torch.int32)})
        restored = load_checkpoint(path, {"age": torch.zeros(
            3, dtype=torch.int64)})
        assert restored["age"].tolist() == [1, 2, 3]

    @pytest.mark.parametrize("stored,template", [
        (torch.float32, torch.int32),  # float row into a queue age
        (torch.int32, torch.float32),  # int counter into a weight row
        (torch.int32, torch.uint8),  # signedness flip
        (torch.bool, torch.int32),  # mask into a counter
    ])
    def test_incompatible_kind_is_rejected_loudly(self, tmp_path, stored,
                                                  template):
        path = save_checkpoint(str(tmp_path), 0,
                               {"leaf": torch.zeros(2, dtype=stored)})
        with pytest.raises(ValueError, match="incompatible dtype"):
            load_checkpoint(path, {"leaf": torch.zeros(2, dtype=template)})

    def test_bf16_into_int_template_is_rejected(self, tmp_path):
        path = save_checkpoint(str(tmp_path), 0, {
            "leaf": torch.zeros(2, dtype=torch.bfloat16)})
        with pytest.raises(ValueError, match="incompatible dtype"):
            load_checkpoint(path, {"leaf": torch.zeros(2,
                                                       dtype=torch.int32)})

    def test_treedef_mismatch_names_both_structures(self, tmp_path):
        path = save_checkpoint(str(tmp_path), 0, {"a": torch.zeros(2),
                                                  "b": torch.ones(2)})
        with pytest.raises(ValueError,
                           match="checkpoint structure mismatch") as e:
            load_checkpoint(path, {"a": torch.zeros(2), "c": torch.ones(2)})
        assert "'b'" in str(e.value) and "'c'" in str(e.value)

    def test_bf16_flstate_roundtrip(self, tmp_path):
        _, state = _state()
        state = state._replace(theta={k: {kk: v.to(torch.bfloat16)
                                          for kk, v in d.items()}
                                      for k, d in state.theta.items()})
        path = save_checkpoint(str(tmp_path), 1, state)
        restored = load_checkpoint(path, state)
        for a, b in zip(_leaves(state), _leaves(restored), strict=True):
            assert _bytes_equal(a, b)

    def test_the_key_is_written_as_uint32_words(self, tmp_path):
        _, state = _state()
        path = save_checkpoint(str(tmp_path), 0, state)
        with np.load(path) as zf:
            assert zf["a:rng"].dtype == np.uint32
            assert zf["a:round"].dtype == np.int32
            assert zf["a:ctrl/a:event_count"].dtype == np.int32
        restored = load_checkpoint(path, state)
        assert restored.rng.dtype == torch.int64
        assert torch.equal(restored.rng, state.rng)


def _ls(kw, n=N_LS):
    jcfg, tcfg = _both(dict(kw, n_clients=n), CTRL)
    jdata, jparams, jls = jax_make_least_squares(n, 8, 5)
    tdata, tparams, tls = make_least_squares(n, 8, 5, device="cpu")
    return jcfg, tcfg, (jdata, jparams, jls), (tdata, tparams, tls)


def _run(round_fn, state, rounds):
    for _ in range(rounds):
        state, _ = round_fn(state)
    return state


def test_async_park_buffers_roundtrip(tmp_path):
    """max_staleness = 2: three rounds, save, load into a fresh template,
    two more — bit-equal to five uninterrupted rounds."""
    _, tcfg, _, (data, params, loss) = _ls(dict(LS, max_staleness=2))
    spec = make_flat_spec(params)
    fn = make_round_fn(tcfg, loss, data, spec=spec, device="cpu")
    state = _run(fn, init_state(tcfg, params, spec=spec, device="cpu"), 3)
    assert int(state.inflight.ttl.count_nonzero()) > 0
    path = save_checkpoint(str(tmp_path), 3, state)
    snapshot = state_to_numpy(state)
    template = init_state(tcfg, params, spec=spec, device="cpu")
    resumed = load_checkpoint(path, template)
    _assert_state_equal(state_to_numpy(resumed), snapshot)
    a = _run(fn, resumed, 2)
    b = _run(fn, state_from_numpy(snapshot, device="cpu"), 2)
    _assert_state_equal(a, b)


def test_residual_checkpoint_roundtrip(tmp_path):
    """tests/test_compress.py::test_residual_checkpoint_roundtrip."""
    _, tcfg, _, (data, params, loss) = _ls(dict(
        LS, compact=False, consensus_compress="int8"), n=8)
    spec = make_flat_spec(params)
    state = _run(make_round_fn(tcfg, loss, data, spec=spec, device="cpu"),
                 init_state(tcfg, params, spec=spec, device="cpu"), 3)
    assert state.comm.abs().max() > 0  # EF is live
    path = save_checkpoint(str(tmp_path), 3, state)
    restored = load_checkpoint(path, init_state(tcfg, params, spec=spec,
                                                device="cpu"))
    assert restored.comm.dtype == torch.float32
    assert torch.equal(restored.comm, state.comm)


TREEDEF_CASES = {
    "flat_sync": (dict(LS), "flat"),
    "flat_s2": (dict(LS, max_staleness=2), "flat"),
    "tree": (dict(LS), "tree"),
    "tree_s2": (dict(LS, max_staleness=2), "tree"),
    "flat_int8": (dict(LS, consensus_compress="int8"), "flat"),
    "flat_bf16_s2": (dict(LS, consensus_compress="bf16", max_staleness=2),
                     "flat"),
}


@pytest.mark.parametrize("case", list(TREEDEF_CASES))
def test_treedef_string_equals_jax(case, tmp_path):
    kw, layout = TREEDEF_CASES[case]
    jcfg, tcfg, (_, jparams, _), (_, tparams, _) = _ls(kw)
    jspec = jax_make_flat_spec(jparams) if layout == "flat" else None
    tspec = make_flat_spec(tparams) if layout == "flat" else None
    jstate = jax_init_state(jcfg, jparams, spec=jspec)
    tstate = init_state(tcfg, tparams, spec=tspec, device="cpu")
    want = str(jax.tree_util.tree_structure(jstate))
    assert treedef_str(tstate) == want
    # ... and the file's keys are the reference's.
    keys = {"/".join(_part(p) for p in path) for path, _ in
            jax.tree_util.tree_flatten_with_path(jstate)[0]}
    with np.load(save_checkpoint(str(tmp_path), 0, tstate)) as zf:
        assert set(zf.files) - {"__treedef__", "__dtypes__"} == keys


def _part(p):
    if isinstance(p, jax.tree_util.DictKey):
        return f"d:{p.key}"
    if isinstance(p, jax.tree_util.SequenceKey):
        return f"s:{p.idx}"
    return f"a:{p.name}"


def test_treedef_string_of_scaffold_equals_jax(tmp_path):
    jcfg, tcfg, (_, jparams, _), (_, tparams, _) = _ls(dict(
        LS, algorithm="scaffold", compact=False))
    jstate = jax_init_scaffold(jcfg, jparams)
    tstate = init_scaffold(tcfg, tparams, device="cpu")
    assert treedef_str(tstate) == str(jax.tree_util.tree_structure(jstate))
    # the reference loads the port's SCAFFOLD checkpoint
    path = save_checkpoint(str(tmp_path), 0, tstate)
    loaded = jax_load(path, jstate)
    for a, b in zip(_leaves(loaded), _leaves(jax.device_get(jstate)),
                    strict=True):
        assert np.asarray(a).tobytes() == np.asarray(b).tobytes()
    back = load_checkpoint(jax_save(str(tmp_path), 1, jstate), tstate)
    for a, b in zip(_leaves(back), _leaves(tstate), strict=True):
        assert _bytes_equal(a, b)


def _bf16_theta(state, torch_side):
    if torch_side:
        return state._replace(theta=state.theta.to(torch.bfloat16))
    return state._replace(theta=state.theta.astype(jnp.bfloat16))


def _check_round(tag, before, tm, tnew, jm, jnew, cfg):
    """The port's round against the reference's from one state."""
    got, want = state_to_numpy(tnew), jax.device_get(jnew)
    np.testing.assert_array_equal(tm.events.numpy(), np.asarray(jm.events),
                                  err_msg=tag)
    np.testing.assert_array_equal(tm.committed.numpy(),
                                  np.asarray(jm.committed), err_msg=tag)
    for f in ("theta", "lam", "z_prev", "omega"):
        np.testing.assert_allclose(getattr(got, f),
                                   np.asarray(getattr(want, f)), rtol=1e-4,
                                   atol=1e-6, err_msg=f"{tag} {f}")
    assert got.ctrl.delta.tobytes() == np.asarray(want.ctrl.delta).tobytes()
    np.testing.assert_array_equal(got.rng, np.asarray(want.rng))
    if want.comm is not None:
        committed = None if cfg.algorithm == "fedback" else np.asarray(
            jm.committed)
        assert _assert_comm_close(before, got, want, committed,
                                  cfg.consensus_compress,
                                  cfg.compress_block, tag) == 0
    assert int(np.asarray(jm.num_events)) > 0


RESUME_CASES = {
    "fp32": (dict(LS), False),
    "bf16_theta": (dict(LS), True),
    "int8": (dict(LS, consensus_compress="int8"), False),
    "int8_fedavg_s2": (dict(LS, algorithm="fedavg", rho=0.0,
                            consensus_compress="int8", max_staleness=2),
                       False),
}


@pytest.mark.parametrize("case", list(RESUME_CASES))
def test_jax_checkpoint_resumes_in_the_port(case, tmp_path):
    kw, bf16 = RESUME_CASES[case]
    jcfg, tcfg, (jdata, jparams, jls), (tdata, tparams, tls) = _ls(kw)
    jspec, tspec = jax_make_flat_spec(jparams), make_flat_spec(tparams)
    jround = jax_make_round_fn(jcfg, jls, jdata, spec=jspec)
    jstate = _run(jround, jax_init_state(jcfg, jparams, spec=jspec), 3)
    saved = _bf16_theta(jstate, False) if bf16 else jstate
    path = jax_save(str(tmp_path), 3, saved)
    # Both resume from the file into their fp32 templates.
    jtemplate = jax_init_state(jcfg, jparams, spec=jspec)
    jresumed = jax.tree.map(jnp.asarray, jax_load(path, jtemplate))
    resumed = load_checkpoint(path, init_state(tcfg, tparams, spec=tspec,
                                               device="cpu"))
    _assert_state_equal(state_to_numpy(resumed), jax.device_get(jresumed))
    before = jax.device_get(jresumed)
    tnew, tm = make_round_fn(tcfg, tls, tdata, spec=tspec,
                             device="cpu")(resumed)
    jnew, jm = jround(jresumed)
    _check_round(case, before, tm, tnew, jm, jnew, tcfg)


@pytest.mark.parametrize("case", list(RESUME_CASES))
def test_port_checkpoint_resumes_in_jax(case, tmp_path):
    kw, bf16 = RESUME_CASES[case]
    jcfg, tcfg, (jdata, jparams, jls), (tdata, tparams, tls) = _ls(kw)
    jspec, tspec = jax_make_flat_spec(jparams), make_flat_spec(tparams)
    tround = make_round_fn(tcfg, tls, tdata, spec=tspec, device="cpu")
    tstate = _run(tround, init_state(tcfg, tparams, spec=tspec,
                                     device="cpu"), 3)
    saved = _bf16_theta(tstate, True) if bf16 else tstate
    path = save_checkpoint(str(tmp_path), 3, saved)
    jresumed = jax.tree.map(jnp.asarray, jax_load(
        path, jax_init_state(jcfg, jparams, spec=jspec)))
    resumed = load_checkpoint(path, init_state(tcfg, tparams, spec=tspec,
                                               device="cpu"))
    _assert_state_equal(state_to_numpy(resumed), jax.device_get(jresumed))
    if bf16:  # the file's θ is θ rounded to bf16
        torch.testing.assert_close(resumed.theta, tstate.theta.to(
            torch.bfloat16).float(), rtol=0, atol=0)
    before = jax.device_get(jresumed)
    tnew, tm = tround(resumed)
    jnew, jm = jax_make_round_fn(jcfg, jls, jdata, spec=jspec)(jresumed)
    _check_round(case, before, tm, tnew, jm, jnew, tcfg)


@pytest.mark.parametrize("kw", [dict(LS), dict(LS, fused_gss=True,
                                               consensus_compress="int8")],
                         ids=["compact", "fused_int8"])
def test_resumed_run_is_bit_equal_to_the_uninterrupted_one(kw, tmp_path):
    _, tcfg, _, (data, params, loss) = _ls(kw)
    spec = make_flat_spec(params)
    fn = make_round_fn(tcfg, loss, data, spec=spec, device="cpu")
    state = _run(fn, init_state(tcfg, params, spec=spec, device="cpu"), 4)
    path = save_checkpoint(str(tmp_path), 4, state)
    snapshot = state_to_numpy(state)  # the fused round writes in place
    a = _run(fn, state_from_numpy(snapshot, device="cpu"), 3)
    b = _run(fn, load_checkpoint(path, init_state(tcfg, params, spec=spec,
                                                  device="cpu")), 3)
    _assert_state_equal(a, b)


@pytest.mark.parametrize("mode", ["none", "int8"])
def test_mesh_state_resumes_at_p2_and_p1(mode, tmp_path):
    """Saved from 2 client shards: the file is the unsharded state; it
    resumes into 2 shards (the next rounds bit-equal to the
    uninterrupted sharded run) and into one device."""
    _, tcfg, _, (data, params, loss) = _ls(dict(
        LS, fused_gss=True, consensus_compress=mode))
    spec = make_flat_spec(params)
    mesh = make_client_mesh(2, ["cpu"])
    fn2 = make_round_fn(tcfg, loss, data, spec=spec, mesh=mesh)
    shards = _run(fn2, init_state(tcfg, params, spec=spec, mesh=mesh), 3)
    path = save_checkpoint(str(tmp_path), 3, shards)
    snapshot = state_to_numpy(shards)
    resumed2 = load_checkpoint(path, init_state(tcfg, params, spec=spec,
                                                mesh=mesh))
    assert isinstance(resumed2, tuple) and len(resumed2) == 2
    assert resumed2[0].theta.shape == (N_LS // 2, spec.dim)
    _assert_state_equal(state_to_numpy(resumed2), snapshot)
    a = _run(fn2, resumed2, 2)
    b = _run(fn2, state_from_numpy(snapshot, mesh=mesh), 2)
    _assert_state_equal(a, b)
    resumed1 = load_checkpoint(path, init_state(tcfg, params, spec=spec,
                                                device="cpu"))
    _assert_state_equal(state_to_numpy(resumed1), snapshot)
    fn1 = make_round_fn(tcfg, loss, data, spec=spec, device="cpu")
    after, m = fn1(resumed1)
    assert int(after.round) == 4 and torch.isfinite(after.omega).all()

"""The port's host-offloaded state (``repro_torch.core.hoststate``): twins
of every test in tests/test_hoststate.py, and of the host-backend
checkpoint cases of tests/test_checkpoint.py.

The contract is the reference's: with the same config the host backend
gives the device backend's bits — events, ω, θ, λ, z_prev, the EF
residual, the park buffers and every ``RoundMetrics`` field, the train
loss included (the field the reference's own host backend misses by an
ulp under jax 0.9).  Here the port's host backend is held against the
port's device backend bit for bit, and the port's device backend
against the JAX package's device backend state-synced
(``tests/test_torch_round.py::_run_synced``: events equal off a 1e-5
margin, the state at rtol 1e-4 / atol 1e-6), never against JAX's host
backend's metrics.  Checkpoints of a host state resume on either
backend and in either package.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.checkpoint import load_checkpoint as jax_load
from repro.checkpoint import save_checkpoint as jax_save
from repro.core import ControllerConfig as JCtrl
from repro.core import FLConfig as JFLConfig
from repro.core import host_state_from_tree as jax_host_state_from_tree
from repro.core import init_state as jax_init_state
from repro.core import make_flat_spec as jax_make_flat_spec
from repro.core import make_round_fn as jax_make_round_fn
from repro.data import make_least_squares as jax_make_least_squares
from repro_torch.checkpoint import load_checkpoint, save_checkpoint
from repro_torch.convert import host_state_from_numpy, state_to_numpy
from repro_torch.core import ControllerConfig, FLConfig, HostState, \
    host_state_from_tree, host_state_to_device, init_state, make_round_fn, \
    pool_data, run_rounds
from repro_torch.data import make_least_squares
from repro_torch.launch.sweep import make_sweep_fn
from repro_torch.sharding import make_client_mesh
from repro_torch.utils import make_flat_spec
from test_torch_round import _run_synced

N = 12
POINTS = 6
DIM = 4
BASE = dict(algorithm="fedback", n_clients=N, participation=0.5, rho=1.0,
            lr=0.1, momentum=0.0, epochs=2, batch_size=3, compact=True)
CTRL = dict(K=0.2, alpha=0.9)
# The state-synced leg against the reference takes K = 0.5: at K = 0.2
# XLA's contracted δ + K·(L − L̄) lands one ulp off (ROADMAP D1), and
# ``_run_synced`` holds δ bit for bit.
SYNC_CTRL = dict(K=0.5, alpha=0.9)


def _cfg(ctrl=CTRL, **kw):
    return FLConfig(**{**BASE, **kw}, controller=ControllerConfig(**ctrl))


def _jcfg(ctrl=CTRL, **kw):
    return JFLConfig(**{**BASE, **kw}, controller=JCtrl(**ctrl))


def _sizes(kind):
    return [POINTS] * N if kind == "uniform" else [2 + (i % 4)
                                                   for i in range(N)]


def _problem(ragged_kind="none"):
    data, params0, ls = make_least_squares(N, POINTS, DIM, device="cpu")
    spec = make_flat_spec(params0)
    if ragged_kind == "none":
        return data, params0, ls, spec, None
    sizes = _sizes(ragged_kind)
    pooled, rspec = pool_data(
        [data["x"][i][:s] for i, s in enumerate(sizes)],
        [data["y"][i][:s] for i, s in enumerate(sizes)], device="cpu")
    return pooled, params0, ls, spec, rspec


def _run(cfg, data, params0, ls, spec, rspec, rounds=5):
    state = init_state(cfg, params0, spec=spec, device="cpu")
    round_fn = make_round_fn(cfg, ls, data, spec=spec, ragged=rspec,
                             device="cpu")
    history = []
    for _ in range(rounds):
        state, m = round_fn(state)
        history.append(m)
    return state, history, round_fn


def _leaves(state):
    """Every leaf of a device or host state, by field path, as numpy."""
    s = state_to_numpy(state)
    out = {}
    for f in ("theta", "lam", "z_prev", "omega", "comm", "rng", "round"):
        if getattr(s, f) is not None:
            out[f] = getattr(s, f)
    for group in ("ctrl", "queue", "inflight"):
        part = getattr(s, group)
        if part is not None:
            out.update({f"{group}.{k}": v for k, v in part._asdict().items()})
    return out


def _assert_bitexact(dev_st, host_st):
    a, b = _leaves(dev_st), _leaves(host_st)
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].tobytes() == b[k].tobytes(), k


def _assert_metrics_bitexact(dev_hist, host_hist):
    for r, (a, b) in enumerate(zip(dev_hist, host_hist, strict=True)):
        for f in a._fields:
            x, y = getattr(a, f), getattr(b, f)
            assert x.dtype == y.dtype and torch.equal(x, y), (r, f)


def _parity(cfg, ragged_kind="none", rounds=5):
    data, params0, ls, spec, rspec = _problem(ragged_kind)
    dev_st, dev_h, _ = _run(cfg, data, params0, ls, spec, rspec, rounds)
    host_st, host_h, fn = _run(dataclasses.replace(cfg, state_backend="host"),
                               data, params0, ls, spec, rspec, rounds)
    assert isinstance(host_st, HostState)
    _assert_metrics_bitexact(dev_h, host_h)
    _assert_bitexact(dev_st, host_st)
    return host_st, fn


def _jax_problem(ragged_kind):
    jdata, jparams, jls = jax_make_least_squares(N, POINTS, DIM)
    tdata, tparams, tls = make_least_squares(N, POINTS, DIM, device="cpu")
    if ragged_kind == "none":
        return jdata, jparams, jls, tdata, tparams, tls, None
    sizes = _sizes(ragged_kind)
    tdata, rspec = pool_data(
        [tdata["x"][i][:s] for i, s in enumerate(sizes)],
        [tdata["y"][i][:s] for i, s in enumerate(sizes)], device="cpu")
    jdata = {k: v.numpy() for k, v in tdata.items()}
    return jdata, jparams, jls, tdata, tparams, tls, rspec


class TestHostParity:
    """Host backend ≡ device backend, bit for bit; the device backend
    state-synced against the reference's."""

    @pytest.mark.parametrize("sync", ["sync", "async"])
    @pytest.mark.parametrize("ragged_kind", ["uniform", "masked"])
    @pytest.mark.parametrize("fused", [False, True])
    def test_parity_matrix(self, sync, ragged_kind, fused):
        kw = dict(max_staleness=2 if sync == "async" else None,
                  fused_gss=fused)
        _parity(_cfg(**kw), ragged_kind)
        jdata, jparams, jls, tdata, tparams, tls, rspec = _jax_problem(
            ragged_kind)
        seen = _run_synced(_jcfg(SYNC_CTRL, **kw), _cfg(SYNC_CTRL, **kw), jls,
                           tls, jdata, tdata, jparams, tparams, 3,
                           ragged=rspec)
        assert seen["flipped_rounds"] == 0

    def test_parity_rectangular_data(self):
        """The (N, n, ...) data: the slots' rows gathered on the device."""
        _parity(_cfg())

    def test_parity_compressed_consensus(self):
        """The EF residual goes up and comes back each round."""
        st, _ = _parity(_cfg(consensus_compress="int8"))
        assert float(st.comm.abs().max()) > 0

    def test_parity_fedavg(self):
        """Outside the ADMM family: the participants' mean, λ stays 0."""
        st, _ = _parity(_cfg(algorithm="fedavg", rho=0.0))
        assert not bool(st.lam.any())

    def test_tiling_never_changes_bits(self):
        """``stream_tiles`` is the copy granularity only."""
        data, params0, ls, spec, _ = _problem()
        states = [_run(_cfg(state_backend="host", stream_tiles=t), data,
                       params0, ls, spec, None)[0] for t in (1, 4)]
        _assert_bitexact(*states)

    def test_metrics_match_device(self):
        """Every metric the trace consumers read, the train loss
        included, bit for bit over 4 rounds (the reference's own host
        backend misses ``train_loss`` by an ulp; the port does not)."""
        data, params0, ls, spec, _ = _problem()
        _, dev_h, _ = _run(_cfg(), data, params0, ls, spec, None, 4)
        _, host_h, _ = _run(_cfg(state_backend="host"), data, params0, ls,
                            spec, None, 4)
        _assert_metrics_bitexact(dev_h, host_h)
        assert all(float(m.train_loss) > 0 for m in host_h)

    def test_run_rounds_compatible(self):
        data, params0, ls, spec, _ = _problem()
        cfg = _cfg(state_backend="host")
        state = init_state(cfg, params0, spec=spec, device="cpu")
        round_fn = make_round_fn(cfg, ls, data, spec=spec, device="cpu")
        state, hist = run_rounds(round_fn, state, 3)
        assert isinstance(state, HostState)
        assert tuple(hist.num_events.shape) == (3,)


class TestHostDispatch:
    def test_init_returns_host_state(self):
        _, params0, _, spec, _ = _problem()
        st = init_state(_cfg(state_backend="host", max_staleness=2,
                             consensus_compress="int8"), params0, spec=spec,
                        device="cpu")
        assert isinstance(st, HostState)
        for m in (st.theta, st.lam, st.z_prev, st.comm, st.inflight.theta,
                  st.inflight.lam, st.inflight.z):
            assert m.device.type == "cpu" and m.shape == (N, spec.dim)
        assert st.distances is None  # computed by the first round

    def test_unknown_backend_rejected(self):
        data, params0, ls, spec, _ = _problem()
        with pytest.raises(ValueError, match="unknown state_backend"):
            init_state(_cfg(state_backend="tpu"), params0, spec=spec,
                       device="cpu")
        with pytest.raises(ValueError, match="unknown state_backend"):
            make_round_fn(_cfg(state_backend="tpu"), ls, data, spec=spec,
                          device="cpu")

    def test_host_needs_flat_and_compact(self):
        data, params0, ls, spec, _ = _problem()
        with pytest.raises(ValueError, match="flat"):
            init_state(_cfg(state_backend="host"), params0, device="cpu")
        with pytest.raises(ValueError, match="compact"):
            init_state(_cfg(state_backend="host", compact=False), params0,
                       spec=spec, device="cpu")
        with pytest.raises(ValueError, match="compact"):
            make_round_fn(_cfg(state_backend="host", compact=False), ls,
                          data, spec=spec, device="cpu")
        with pytest.raises(ValueError, match="flat"):
            make_round_fn(_cfg(state_backend="host"), ls, data,
                          device="cpu")

    def test_host_rejects_mesh(self):
        data, params0, ls, spec, _ = _problem()
        mesh = make_client_mesh(1, ["cpu"])
        with pytest.raises(ValueError, match="single-host"):
            make_round_fn(_cfg(state_backend="host"), ls, data, spec=spec,
                          mesh=mesh)
        with pytest.raises(ValueError, match="single-host"):
            init_state(_cfg(state_backend="host"), params0, spec=spec,
                       mesh=mesh)

    def test_host_rejects_runtime_args(self):
        """No controller overrides or arrival masks, so no sweep."""
        data, _, ls, spec, _ = _problem()
        for kw in (dict(ctrl_arg=True), dict(arrivals_arg=True)):
            with pytest.raises(ValueError, match="runtime args"):
                make_round_fn(_cfg(state_backend="host"), ls, data,
                              spec=spec, device="cpu", **kw)
        with pytest.raises(ValueError, match="runtime args"):
            make_sweep_fn(_cfg(state_backend="host"), ls, data, rounds=2,
                          spec=spec, device="cpu")


class TestStreamingBytes:
    def test_measured_bytes_match_plan_model(self):
        data, params0, ls, spec, _ = _problem()
        _, _, fn = _run(_cfg(state_backend="host"), data, params0, ls, spec,
                        None, rounds=5)
        planned, stats = fn.planned_bytes, fn.stats
        assert stats["rounds"] == 5
        assert stats["h2d_row_bytes"] == 5 * planned["row_stream_h2d"]
        assert stats["d2h_row_bytes"] == 5 * planned["row_stream_d2h"]
        # One full-width pass a round, plus the first round's trigger.
        assert stats["h2d_full_bytes"] == 6 * planned["server_pass_h2d"]
        assert stats["d2h_full_bytes"] == 5 * planned["server_pass_d2h"]
        assert stats["d2h_plan_bytes"] == 5 * planned["plan_d2h"]
        assert (planned["row_stream_h2d"] + planned["row_stream_d2h"]
                <= planned["row_stream_budget"])

    def test_persistent_device_bytes_are_o_n_not_o_nd(self):
        data, params0, ls, spec, _ = _problem()
        st, _, fn = _run(_cfg(state_backend="host", consensus_compress="int8",
                              max_staleness=2), data, params0, ls, spec,
                         None, rounds=3)
        n, d = N, spec.dim
        assert fn.stats["d2h_full_bytes"] == 3 * fn.planned_bytes[
            "server_pass_d2h"] > 0
        # θ, λ, z_prev, comm and the three park buffers on the host.
        assert st.host_state_bytes() == 7 * n * d * 4
        # ω, the distances and the (N,) vectors: below one (N, D) matrix.
        assert st.device_state_bytes() < n * d * 4 + 64 * n

    @pytest.mark.cuda
    def test_live_device_memory_stays_o_cd(self):
        if not torch.cuda.is_available():
            pytest.skip("needs a CUDA device")
        data, params0, ls, spec, _ = _problem()
        cfg = _cfg(state_backend="host")
        data = {k: v.cuda() for k, v in data.items()}
        # One device round first: the process's one-time allocations
        # (cuBLAS's workspace) are not the round's state.
        make_round_fn(_cfg(), ls, data, spec=spec)(init_state(
            _cfg(), params0, spec=spec))
        torch.cuda.synchronize()
        baseline = torch.cuda.memory_allocated()
        st = init_state(cfg, params0, spec=spec)
        fn = make_round_fn(cfg, ls, data, spec=spec)
        for _ in range(3):
            st, _ = fn(st)
        torch.cuda.synchronize()
        live = torch.cuda.memory_allocated() - baseline
        cap = fn.static_info["capacity"]
        bound = (8 * cap * spec.dim * 4 + st.device_state_bytes()
                 + sum(v.numel() * v.element_size() for v in data.values())
                 + (1 << 20))
        assert live <= bound, (live, bound)


class TestHostStateContainer:
    def test_checkpoint_tree_leaves_stay_on_the_host(self):
        _, params0, _, spec, _ = _problem()
        st = init_state(_cfg(state_backend="host", consensus_compress="int8"),
                        params0, spec=spec, device="cpu")
        tree = st.to_checkpoint_tree()
        for f in ("theta", "lam", "z_prev", "comm"):
            assert getattr(tree, f) is getattr(st, f), f

    def test_fused_flag_validation_mirrors_device(self):
        data, _, ls, spec, _ = _problem()
        with pytest.raises(ValueError, match="fused_gss"):
            make_round_fn(_cfg(state_backend="host", algorithm="fedavg",
                               rho=0.0, fused_gss=True), ls, data,
                          spec=spec, device="cpu")

    def test_to_device_and_back(self):
        """``host_state_to_device`` gives the device backend's state (the
        next rounds bit-equal), ``host_state_from_tree`` the way back."""
        data, params0, ls, spec, _ = _problem()
        cfg = _cfg(max_staleness=2)
        hcfg = dataclasses.replace(cfg, state_backend="host")
        host, _, hfn = _run(hcfg, data, params0, ls, spec, None, 2)
        dev = host_state_to_device(host)
        back = host_state_from_tree(dev, hcfg, spec=spec, device="cpu")
        dfn = make_round_fn(cfg, ls, data, spec=spec, device="cpu")
        a, b = dev, back
        for _ in range(2):
            a, _ = dfn(a)
            b, _ = hfn(b)
        _assert_bitexact(a, b)


# --- checkpoints (twins of tests/test_checkpoint.py's host cases) --------

CK = dict(n_clients=10, epochs=1, consensus_compress="int8")


def _ck_problem():
    data, params0, ls = make_least_squares(CK["n_clients"], 6, 4,
                                           device="cpu")
    return data, params0, ls, make_flat_spec(params0)


def _steps(cfg, state, rounds):
    data, _, ls, spec = _ck_problem()
    fn = make_round_fn(cfg, ls, data, spec=spec, device="cpu")
    for _ in range(rounds):
        state, _ = fn(state)
    return state


class TestHostCheckpoint:
    def test_host_roundtrip_resumes_bitexact(self, tmp_path):
        _, params0, _, spec = _ck_problem()
        cfg = _cfg(state_backend="host", **CK)
        st = _steps(cfg, init_state(cfg, params0, spec=spec, device="cpu"), 2)
        path = save_checkpoint(str(tmp_path), 2, st)
        loaded = load_checkpoint(path, init_state(cfg, params0, spec=spec,
                                                  device="cpu"))
        assert isinstance(loaded, HostState) and loaded.distances is None
        _assert_bitexact(loaded, st)
        _assert_bitexact(_steps(cfg, loaded, 2), _steps(cfg, st, 2))

    def test_resume_device_checkpoint_on_host(self, tmp_path):
        _, params0, _, spec = _ck_problem()
        dev_cfg = _cfg(**CK)
        host_cfg = dataclasses.replace(dev_cfg, state_backend="host")
        dev_st = _steps(dev_cfg, init_state(dev_cfg, params0, spec=spec,
                                            device="cpu"), 2)
        path = save_checkpoint(str(tmp_path), 2, dev_st)
        loaded = load_checkpoint(path, init_state(host_cfg, params0,
                                                  spec=spec, device="cpu"))
        host_final = _steps(host_cfg, loaded, 2)
        _assert_bitexact(_steps(dev_cfg, dev_st, 2), host_final)

    def test_resume_host_checkpoint_on_device(self, tmp_path):
        _, params0, _, spec = _ck_problem()
        dev_cfg = _cfg(**CK)
        host_cfg = dataclasses.replace(dev_cfg, state_backend="host")
        host_st = _steps(host_cfg, init_state(host_cfg, params0, spec=spec,
                                              device="cpu"), 2)
        path = save_checkpoint(str(tmp_path), 2, host_st.to_checkpoint_tree())
        loaded = load_checkpoint(path, init_state(dev_cfg, params0,
                                                  spec=spec, device="cpu"))
        dev_final = _steps(dev_cfg, loaded, 2)
        _assert_bitexact(dev_final, _steps(host_cfg, host_st, 2))

    def test_async_park_buffers_roundtrip(self, tmp_path):
        _, params0, _, spec = _ck_problem()
        cfg = _cfg(state_backend="host", max_staleness=2, **CK)
        st = _steps(cfg, init_state(cfg, params0, spec=spec, device="cpu"), 3)
        assert int(st.inflight.ttl.count_nonzero()) > 0
        path = save_checkpoint(str(tmp_path), 3, st)
        resumed = load_checkpoint(path, st)
        _assert_bitexact(_steps(cfg, resumed, 2), _steps(cfg, st, 2))

    @pytest.mark.parametrize("staleness", [None, 2])
    def test_checkpoints_cross_the_packages(self, staleness, tmp_path):
        """A host checkpoint of the port loads in the JAX package (its
        treedef string and every leaf), and the JAX package's host
        checkpoint and its ``HostState`` load in the port, each leaf
        bit for bit."""
        kw = dict(CK, max_staleness=staleness, state_backend="host")
        data, params0, ls, spec = _ck_problem()
        jcfg = _jcfg(**kw)
        jdata, jparams, jls = jax_make_least_squares(CK["n_clients"], 6, 4)
        jspec = jax_make_flat_spec(jparams)
        jst = jax_init_state(jcfg, jparams, spec=jspec)
        jround = jax_make_round_fn(jcfg, jls, jdata, spec=jspec)
        for _ in range(2):
            jst, _ = jround(jst)
        jtree = jax.device_get(jst.to_checkpoint_tree())
        # the reference's checkpoint → the port's HostState
        jpath = jax_save(str(tmp_path / "jax"), 2, jtree)
        cfg = _cfg(**kw)
        mine = load_checkpoint(jpath, init_state(cfg, params0, spec=spec,
                                                 device="cpu"))
        ref = _leaves(host_state_from_numpy(jst, device="cpu"))
        for got in (_leaves(mine), ref):
            for k, v in got.items():
                want = np.asarray(_jax_leaf(jtree, k))
                assert v.tobytes() == want.astype(v.dtype).tobytes(), k
        # the port's checkpoint → the reference's host state
        st = _steps(cfg, init_state(cfg, params0, spec=spec, device="cpu"),
                    2)
        path = save_checkpoint(str(tmp_path / "port"), 2, st)
        template = jax_init_state(jcfg, jparams, spec=jspec)
        back = jax_load(path, template.to_checkpoint_tree())
        jhost = jax_host_state_from_tree(back, jcfg, spec=jspec)
        for k, v in _leaves(st).items():
            want = np.asarray(_jax_leaf(jhost.to_checkpoint_tree(), k))
            assert v.tobytes() == want.astype(v.dtype).tobytes(), k


def _jax_leaf(tree, path):
    node = tree
    for part in path.split("."):
        node = getattr(node, part)
    return node

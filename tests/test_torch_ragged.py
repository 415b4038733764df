"""Ragged clients (``utils/ragged.py``, ``make_round_fn(ragged=)``,
``data.federated_pooled``) of the port against the reference's.

* The CSR codec: specs, bucket plans, padding, ``permute``,
  ``pool_rows`` and ``pool_data`` equal to ``repro.utils.ragged``'s, and
  conservation (Σnᵢ pooled rows, none dropped) as a property.
* ``engine.masked_batch_loss`` and ``fedback._masked_local_solve``
  against the reference's: a padded client, a step of all padding that
  leaves θ, the momentum and the loss alone, and a client whose size is
  its bucket's capacity, which gives the plain solve's bits.
* A uniform pool gives the port's rectangular round bit for bit (events
  and ω): flat and tree, dense and compact, and with
  ``max_staleness=2``; and the all-ones serve step gives the ragged
  round's bits (the reference's tests/test_serve.py ragged leg).
* State-synced against live JAX (tests/test_torch_round.py's
  ``_run_synced(ragged=)``): the golden "ragged" configuration of
  tests/test_golden_trace.py over 30 rounds; non-uniform dense and
  compact (fused and unfused) rounds on both layouts and under
  staleness, 10 rounds; the bursty serve trace on a ragged pool; an MLP
  pooled round and a CNN pooled round at N = 8 (the CNN held by the
  update-norm ratio, 1e-3, as tests/test_torch_cifar.py holds CF-A).
* The client mesh: the port's sharded ragged round from the states the
  reference's sharded ragged round wrote on 2 and 4 forced host
  devices (one subprocess), dense and compact, flat and tree, on a pool
  reordered by ``balanced_permutation``.
* ``federated_pooled`` bit-equal to the reference's on synthetic MNIST
  (label shards) and CIFAR (Dirichlet), and the paper workloads' pools.
"""
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
from hypothesis import given, settings, strategies as st

from repro.core.engine import masked_batch_loss as jax_masked_batch_loss
from repro.core.fedback import _epoch_indices as jax_epoch_indices
from repro.core.fedback import _local_solve as jax_local_solve
from repro.core.fedback import _masked_local_solve as jax_masked_solve
from repro.data import federated_pooled as jax_federated_pooled
from repro.data import make_synthetic_cifar as jax_make_cifar
from repro.data import make_synthetic_mnist as jax_make_mnist
from repro.models.mlp import cnn_logits as jax_cnn_logits
from repro.models.mlp import init_cnn as jax_init_cnn
from repro.models.mlp import make_loss_fn as jax_make_loss_fn
from repro.models.mlp import mlp_logits as jax_mlp_logits
from repro.sharding.clients import balanced_permutation as \
    jax_balanced_permutation
from repro.utils import ragged as jax_ragged
from repro_torch.configs import paper_cifar, paper_mnist
from repro_torch.convert import nest_params, params_from_numpy, \
    state_from_numpy, state_to_numpy
from repro_torch.core import ControllerConfig, FLConfig, init_state, \
    make_round_fn, run_rounds
from repro_torch.core.engine import masked_batch_loss
from repro_torch.core.fedback import _local_solve, _masked_local_solve
from repro_torch.core.schedule import TraceConfig, make_trace, run_trace, \
    sync_trace
from repro_torch.data import federated_pooled, make_least_squares, \
    make_synthetic_cifar, make_synthetic_mnist
from repro_torch.models import cnn_logits, make_loss_fn
from repro_torch.sharding import balanced_permutation, make_client_mesh
from repro_torch.utils import make_flat_spec
from repro_torch.utils.pytree import tree_leaves
from repro_torch.utils.ragged import make_ragged_spec, pool_data, pool_rows
from test_torch_round import _both, _mlp_problem, _run_synced, \
    jax_make_least_squares

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _same_spec(got, want):
    assert got.sizes == want.sizes and got.offsets == want.offsets
    assert [(b.capacity, b.members, b.padded) for b in got.buckets] == \
        [(b.capacity, b.members, b.padded) for b in want.buckets]
    for f in ("n_clients", "total", "max_size", "min_size", "uniform",
              "padding", "buffer_rows"):
        assert getattr(got, f) == getattr(want, f), f


# --- the CSR codec ---------------------------------------------------------

SIZES = [[3, 5, 2], [4, 4, 4], [8, 3], [3, 9, 4, 9, 5, 17, 3, 12],
         [6] * 10, [1], list(range(1, 30))]


@pytest.mark.parametrize("max_buckets", [1, 3, 4])
@pytest.mark.parametrize("sizes", SIZES, ids=str)
def test_spec_equals_reference(sizes, max_buckets):
    got = make_ragged_spec(sizes, max_buckets=max_buckets)
    want = jax_ragged.make_ragged_spec(sizes, max_buckets=max_buckets)
    _same_spec(got, want)
    assert [got.client_slice(i) for i in range(got.n_clients)] == \
        [want.client_slice(i) for i in range(want.n_clients)]
    assert hash(got) == hash(make_ragged_spec(sizes,
                                              max_buckets=max_buckets))
    assert max(o + got.max_size for o in got.offsets) <= got.buffer_rows
    members = sorted(i for b in got.buckets for i in b.members)
    assert members == list(range(len(sizes)))
    np.testing.assert_array_equal(got.offsets_array(device="cpu").numpy(),
                                  np.asarray(want.offsets_array()))
    np.testing.assert_array_equal(got.sizes_array(device="cpu").numpy(),
                                  np.asarray(want.sizes_array()))
    assert got.offsets_array(device="cpu").dtype == torch.int32


def test_spec_refuses_what_the_reference_refuses():
    for bad, kw in (([], {}), ([3, 0, 2], {}), ([3], {"max_buckets": 0})):
        with pytest.raises(ValueError):
            make_ragged_spec(bad, **kw)
        with pytest.raises(ValueError):
            jax_ragged.make_ragged_spec(bad, **kw)
    with pytest.raises(ValueError, match="disagree"):
        pool_data([np.zeros((2, 3))], [np.zeros(3)], device="cpu")


@pytest.mark.parametrize("shards", [2, 4])
def test_permute_and_balanced_permutation_equal_reference(shards):
    sizes = np.random.default_rng(0).integers(1, 100, size=32)
    perm = balanced_permutation(sizes, shards)
    np.testing.assert_array_equal(perm, jax_balanced_permutation(sizes,
                                                                 shards))
    spec = make_ragged_spec(sizes)
    _same_spec(spec.permute(perm),
               jax_ragged.make_ragged_spec(sizes).permute(perm))
    loads = sizes[perm].reshape(shards, -1).sum(axis=1)
    assert loads.max() - loads.min() <= int(sizes.max())


def test_pool_rows_and_pool_data_equal_reference():
    rng = np.random.default_rng(0)
    xs = [rng.normal(size=(s, 3, 2)).astype(np.float32) for s in (2, 7, 4)]
    ys = [rng.integers(0, 9, s).astype(np.int32) for s in (2, 7, 4)]
    got, spec = pool_rows(xs)
    want, jspec = jax_ragged.pool_rows(xs)
    assert got.tobytes() == want.tobytes() and got.dtype == want.dtype
    _same_spec(spec, jspec)
    assert spec.padding == 3 and not got[spec.total:].any()
    for a, b in zip(xs, spec.split(got), strict=True):
        np.testing.assert_array_equal(a, b)
    data, spec = pool_data(xs, ys, max_buckets=2, device="cpu")
    jdata, jspec = jax_ragged.pool_data(xs, ys, max_buckets=2)
    _same_spec(spec, jspec)
    for k in ("x", "y"):
        assert data[k].device.type == "cpu"
        np.testing.assert_array_equal(data[k].numpy(), np.asarray(jdata[k]))


@settings(max_examples=10, deadline=None)
@given(n=st.integers(1, 12), seed=st.integers(0, 5))
def test_property_conservation(n, seed):
    """Σnᵢ pooled rows, every example once, in client order; the spec
    is the reference's."""
    rng = np.random.default_rng(seed)
    sizes = rng.integers(1, 20, size=n)
    xs = [rng.normal(size=(s, 2)).astype(np.float32) for s in sizes]
    pooled, spec = pool_rows(xs)
    assert spec.total == int(sizes.sum())
    assert pooled.shape[0] == spec.buffer_rows
    np.testing.assert_array_equal(pooled[:spec.total], np.concatenate(xs))
    _same_spec(spec, jax_ragged.make_ragged_spec(sizes))


# --- the masked loss and the masked solve ----------------------------------

def _ls_torch(p, xb, yb):
    r = xb @ p["theta"] - yb
    return 0.5 * torch.mean(r * r)


def _ls_jax(p, xb, yb):
    r = xb @ p["theta"] - yb
    return 0.5 * jnp.mean(r * r)


def test_masked_batch_loss_equals_reference():
    params, x, y = _mlp_problem()
    xb, yb = x[0, :8], y[0, :8]
    tparams = nest_params(params_from_numpy(params, device="cpu"))
    for w in (np.ones(8), np.r_[np.ones(5), np.zeros(3)], np.zeros(8)):
        w = w.astype(np.float32)
        got = masked_batch_loss(make_loss_fn(), tparams, torch.from_numpy(xb),
                                torch.from_numpy(yb), torch.from_numpy(w))
        want = jax_masked_batch_loss(jax_make_loss_fn(jax_mlp_logits),
                                     params, jnp.asarray(xb),
                                     jnp.asarray(yb), jnp.asarray(w))
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    assert float(got) == 0.0


def _solve_both(x, y, offset, size, idx, *, rho=0.5, lr=0.1, momentum=0.9):
    """The port's masked solve of one client (a batch of one) and the
    reference's, from θ⁰ = 0 with center 0.3."""
    dim = x.shape[1]
    got, g_loss = _masked_local_solve(
        _ls_torch, None, {"theta": torch.zeros((1, dim))},
        {"theta": torch.full((1, dim), 0.3)}, torch.from_numpy(x),
        torch.from_numpy(y), torch.tensor([offset]), torch.tensor([size]),
        torch.tensor(np.asarray(idx))[None], rho=rho, lr=lr,
        momentum=momentum)
    want, w_loss = jax_masked_solve(
        _ls_jax, {"theta": jnp.zeros((dim,))}, {"theta": jnp.full((dim,),
                                                                  0.3)},
        jnp.asarray(x), jnp.asarray(y), jnp.asarray(offset),
        jnp.asarray(size), jnp.asarray(idx), rho=rho, lr=lr,
        momentum=momentum)
    return (got["theta"][0].numpy(), float(g_loss[0]),
            np.asarray(want["theta"]), float(w_loss))


@pytest.mark.parametrize("batch", [4, 5])
@pytest.mark.parametrize("size", [3, 9, 12])
def test_masked_solve_equals_reference(size, batch):
    """A client of ``size`` rows at offset 7 of a 40-row pool, in a
    bucket of capacity 12: the reference's solve at rtol 1e-6; at size
    = capacity the port's plain solve on the same rows bit for bit."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(40, 5)).astype(np.float32)
    y = rng.normal(size=(40,)).astype(np.float32)
    idx = np.asarray(jax_epoch_indices(jax.random.PRNGKey(9), 12, batch, 2))
    got, g_loss, want, w_loss = _solve_both(x, y, 7, size, idx)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(g_loss, w_loss, rtol=1e-6)
    if size == 12:
        plain, p_loss = _local_solve(
            _ls_torch, None, {"theta": torch.zeros((1, 5))},
            {"theta": torch.full((1, 5), 0.3)},
            torch.from_numpy(x[7:19])[None], torch.from_numpy(y[7:19])[None],
            torch.tensor(idx)[None], rho=0.5, lr=0.1, momentum=0.9)
        assert plain["theta"][0].numpy().tobytes() == got.tobytes()
        assert float(p_loss[0]) == g_loss
        jplain, _ = jax_local_solve(_ls_jax, {"theta": jnp.zeros((5,))},
                                    {"theta": jnp.full((5,), 0.3)},
                                    jnp.asarray(x), jnp.asarray(y), 7 + idx,
                                    rho=0.5, lr=0.1, momentum=0.9)
        np.testing.assert_array_equal(np.asarray(jplain["theta"]), want)


def test_masked_solve_ignores_rows_past_the_clients_slice():
    """Rows beyond the client's slice (its neighbour's) cannot move it."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(20, 4)).astype(np.float32)
    y = rng.normal(size=(20,)).astype(np.float32)
    x2, y2 = x.copy(), y.copy()
    x2[6:] *= 100.0
    y2[6:] *= 100.0
    idx = np.asarray(jax_epoch_indices(jax.random.PRNGKey(0), 12, 4, 2))
    a = _solve_both(x, y, 0, 6, idx)
    b = _solve_both(x2, y2, 0, 6, idx)
    assert a[0].tobytes() == b[0].tobytes() and a[1] == b[1]


def test_all_padding_steps_are_skipped():
    """A step whose batch is all padding moves neither θ nor the
    momentum and is not averaged into the loss: two steps (the second
    all padding) equal one, bit for bit, in a batch of two clients
    where the other client's second step is live."""
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.normal(size=(8, 3)).astype(np.float32))
    y = torch.from_numpy(rng.normal(size=(8,)).astype(np.float32))
    theta0 = {"theta": torch.ones((2, 3))}
    center = {"theta": torch.zeros((2, 3))}
    kw = dict(rho=1.0, lr=0.1, momentum=0.9)
    offsets, sizes = torch.tensor([0, 2]), torch.tensor([2, 6])
    two, l_two = _masked_local_solve(
        _ls_torch, None, theta0, center, x, y, offsets, sizes,
        torch.tensor([[[0, 1], [5, 3]], [[0, 1], [5, 3]]]), **kw)
    one, l_one = _masked_local_solve(
        _ls_torch, None, theta0, center, x, y, offsets, sizes,
        torch.tensor([[[0, 1]], [[0, 1]]]), **kw)
    assert torch.equal(two["theta"][0], one["theta"][0])
    assert float(l_two[0]) == float(l_one[0])
    assert not torch.equal(two["theta"][1], one["theta"][1])
    # and the reference agrees on the skipped client
    want, w_loss = jax_masked_solve(
        _ls_jax, {"theta": jnp.ones((3,))}, {"theta": jnp.zeros((3,))},
        jnp.asarray(x.numpy()), jnp.asarray(y.numpy()), jnp.asarray(0),
        jnp.asarray(2), jnp.asarray([[0, 1], [5, 3]]), **kw)
    np.testing.assert_allclose(two["theta"][0].numpy(),
                               np.asarray(want["theta"]), rtol=1e-6)
    np.testing.assert_allclose(float(l_two[0]), float(w_loss), rtol=1e-6)


# --- a uniform pool is the rectangular round -------------------------------

N_UNI, UNI_ROUNDS = 16, 8


def _ls_cfg(n, **kw):
    base = dict(algorithm="fedback", n_clients=n, participation=0.3,
                rho=1.0, lr=0.1, momentum=0.0, epochs=2, batch_size=4,
                capacity_slack=1.5, controller=ControllerConfig(K=0.5,
                                                                alpha=0.9))
    base.update(kw)
    return FLConfig(**base)


def _omega_bytes(state):
    return b"".join(t.numpy().tobytes() for t in tree_leaves(state.omega))


@pytest.mark.parametrize("kw", [
    dict(layout="flat"), dict(layout="tree"),
    dict(layout="flat", compact=True), dict(layout="tree", compact=True),
    dict(layout="flat", compact=True, fused_gss=True),
    dict(layout="flat", compact=True, fused_gss=True, max_staleness=2),
    dict(layout="tree", max_staleness=2),
], ids=lambda kw: "-".join(f"{k}={v}" for k, v in kw.items()))
def test_uniform_pool_is_the_rectangular_round(kw):
    kw = dict(kw)
    layout = kw.pop("layout")
    data, p0, ls = make_least_squares(N_UNI, 8, 5, device="cpu")
    pooled, rspec = pool_data(list(data["x"]), list(data["y"]),
                              device="cpu")
    assert rspec.uniform and rspec.padding == 0
    spec = make_flat_spec(p0) if layout == "flat" else None
    cfg = _ls_cfg(N_UNI, **kw)
    rect = make_round_fn(cfg, ls, data, spec=spec, device="cpu")
    rag = make_round_fn(cfg, ls, pooled, spec=spec, device="cpu",
                        ragged=rspec)
    s_rect, h_rect = run_rounds(rect, init_state(cfg, p0, spec=spec,
                                                 device="cpu"), UNI_ROUNDS)
    s_rag, h_rag = run_rounds(rag, init_state(cfg, p0, spec=spec,
                                              device="cpu"), UNI_ROUNDS)
    assert torch.equal(h_rect.events, h_rag.events)
    assert _omega_bytes(s_rect) == _omega_bytes(s_rag)
    assert 0 < int(h_rag.num_events.sum()) < N_UNI * UNI_ROUNDS


def _serve_pool(n, n_points=8):
    """tests/test_serve.py::_problem(ragged=True): sizes n_points − 2·(i
    mod 3), at least 2."""
    data, p0, ls = make_least_squares(n, n_points, 5, device="cpu")
    sizes = [max(n_points - 2 * (i % 3), 2) for i in range(n)]
    pooled, rspec = pool_data([data["x"][i][:s] for i, s in enumerate(sizes)],
                              [data["y"][i][:s] for i, s in enumerate(sizes)],
                              device="cpu")
    return pooled, rspec, p0, ls


def test_all_ones_serve_step_is_the_ragged_round():
    """tests/test_serve.py::test_compact_ragged: the serve step over the
    all-ones trace gives the synchronous ragged round's bits."""
    pooled, rspec, p0, ls = _serve_pool(12)
    assert not rspec.uniform
    cfg = _ls_cfg(12, participation=0.25, compact=True, rho=1.0,
                  controller=ControllerConfig(K=0.2, alpha=0.9))
    spec = make_flat_spec(p0)
    serve_fn = make_round_fn(cfg, ls, pooled, spec=spec, device="cpu",
                             ragged=rspec, arrivals_arg=True)
    sync_fn = make_round_fn(cfg, ls, pooled, spec=spec, device="cpu",
                            ragged=rspec)
    s_serve, m_serve = run_trace(serve_fn, init_state(cfg, p0, spec=spec,
                                                      device="cpu"),
                                 sync_trace(12, 10))
    s_sync, m_sync = run_rounds(sync_fn, init_state(cfg, p0, spec=spec,
                                                    device="cpu"), 10)
    assert torch.equal(m_serve.events, m_sync.events)
    assert _omega_bytes(s_serve) == _omega_bytes(s_sync)


# --- state-synced against live JAX -----------------------------------------

def _pooled_both(jdata, sizes):
    """The port's pool and spec of the first sizes[i] rows of client i
    of the reference's rectangular data, and the same pool as jnp."""
    xs = [np.asarray(jdata["x"][i])[:s] for i, s in enumerate(sizes)]
    ys = [np.asarray(jdata["y"][i])[:s] for i, s in enumerate(sizes)]
    pooled, rspec = pool_data(xs, ys, device="cpu")
    return {k: jnp.asarray(v.numpy()) for k, v in pooled.items()}, pooled, \
        rspec


def test_golden_ragged_configuration_matches_jax():
    """tests/test_golden_trace.py::_run_trace("ragged"): N = 64 least
    squares, 16 points, Dirichlet(3) sizes clipped to [4, 16], compact,
    slack 1.25, K = 0.5, α = 0.9 — 30 rounds, each state-synced."""
    n = 64
    kw = dict(algorithm="fedback", n_clients=n, participation=0.25,
              rho=1.0, lr=0.1, momentum=0.0, epochs=2, batch_size=4, seed=0,
              compact=True, capacity_slack=1.25)
    jcfg, tcfg = _both(kw, dict(K=0.5, alpha=0.9))
    jdata, jparams, jls = jax_make_least_squares(n, 16, 5)
    _, tparams, tls = make_least_squares(n, 16, 5, device="cpu")
    rng = np.random.default_rng(42)
    props = rng.dirichlet(np.full(n, 3.0))
    sizes = np.clip((props * n * 16 * 0.75).astype(int), 4, 16)
    jpool, tpool, rspec = _pooled_both(jdata, sizes)
    assert not rspec.uniform and all(b.padded for b in rspec.buckets)
    seen = _run_synced(jcfg, tcfg, jls, tls, jpool, tpool, jparams, tparams,
                       rounds=30, ragged=rspec)
    assert seen["events"] > 0 and seen["deferred"] > 0
    assert seen["flipped_rounds"] == 0


N_NU = 16
NON_UNIFORM = {
    "dense_flat": ("flat", {}),
    "dense_tree": ("tree", {}),
    "compact_flat": ("flat", dict(compact=True)),
    "compact_fused_flat": ("flat", dict(compact=True, fused_gss=True)),
    "compact_tree": ("tree", dict(compact=True)),
    "compact_fused_flat_s2": ("flat", dict(compact=True, fused_gss=True,
                                           max_staleness=2)),
    "dense_tree_s2": ("tree", dict(max_staleness=2)),
    "fedavg_dense_flat": ("flat", dict(algorithm="fedavg", rho=0.0)),
}


@pytest.mark.parametrize("case", list(NON_UNIFORM))
def test_non_uniform_rounds_match_jax(case):
    """Sizes 4–12 of 12 points (tests/test_ragged.py::TestNonUniform), 4
    padded buckets, 10 rounds state-synced."""
    layout, extra = NON_UNIFORM[case]
    kw = dict(dict(algorithm="fedback", n_clients=N_NU, participation=0.3,
                   rho=1.0, lr=0.1, momentum=0.0, epochs=2, batch_size=4,
                   capacity_slack=1.5), **extra)
    jcfg, tcfg = _both(kw, dict(K=0.5, alpha=0.9))
    jdata, jparams, jls = jax_make_least_squares(N_NU, 12, 5)
    _, tparams, tls = make_least_squares(N_NU, 12, 5, device="cpu")
    sizes = np.random.default_rng(3).integers(4, 13, size=N_NU)
    jpool, tpool, rspec = _pooled_both(jdata, sizes)
    assert sum(b.padded for b in rspec.buckets) >= 3
    seen = _run_synced(jcfg, tcfg, jls, tls, jpool, tpool, jparams, tparams,
                       rounds=10, layout=layout, ragged=rspec)
    assert seen["events"] > 0 and seen["flipped_rounds"] == 0
    if extra.get("compact"):
        assert seen["deferred"] > 0
    if extra.get("max_staleness"):
        assert seen["landed"] > 0


def test_bursty_serve_trace_on_a_ragged_pool_matches_jax():
    """The serve step (``arrivals_arg``) over a bursty trace on the
    serve tests' ragged pool, 12 ticks state-synced."""
    n = 24
    kw = dict(algorithm="fedback", n_clients=n, participation=0.25,
              rho=1.0, lr=0.1, momentum=0.0, epochs=2, batch_size=4,
              compact=True, capacity_slack=1.25)
    jcfg, tcfg = _both(kw, dict(K=0.5, alpha=0.9))
    jdata, jparams, jls = jax_make_least_squares(n, 8, 5)
    _, tparams, tls = make_least_squares(n, 8, 5, device="cpu")
    sizes = [max(8 - 2 * (i % 3), 2) for i in range(n)]
    jpool, tpool, rspec = _pooled_both(jdata, sizes)
    trace = make_trace(TraceConfig(kind="bursty", n_clients=n, ticks=12,
                                   rate=0.25, seed=0, burst_every=5,
                                   burst_len=2, burst_rate=0.9))
    seen = _run_synced(jcfg, tcfg, jls, tls, jpool, tpool, jparams, tparams,
                       rounds=12, ragged=rspec, trace=trace)
    assert seen["events"] > 0 and seen["deferred"] > 0
    assert seen["flipped_rounds"] == 0


@pytest.mark.parametrize("compact", [False, True])
def test_mlp_pooled_round_matches_jax(compact):
    """The paper MLP's loss on ragged clients at N = 8 (sizes 9–24 of
    24 points), FedBack dense or compact + fused, 4 rounds."""
    params, x, y = _mlp_problem()
    n = 8
    kw = dict(algorithm="fedback", n_clients=n, participation=0.25,
              rho=0.01, lr=0.05, momentum=0.9, epochs=2, batch_size=8,
              capacity_slack=1.5, compact=compact, fused_gss=compact)
    jcfg, tcfg = _both(kw, dict(K=1.0, alpha=0.9))
    sizes = [24, 9, 17, 12, 24, 20, 11, 15]
    jpool, tpool, rspec = _pooled_both({"x": x[:n], "y": y[:n]}, sizes)
    seen = _run_synced(
        jcfg, tcfg, jax_make_loss_fn(jax_mlp_logits), make_loss_fn(), jpool,
        tpool, params, nest_params(params_from_numpy(params, device="cpu")),
        rounds=4, ragged=rspec)
    assert seen["events"] > 0 and seen["flipped_rounds"] == 0


def test_cnn_pooled_round_matches_jax():
    """RC's configuration at N = 8: the CIFAR CNN, the Dirichlet split
    of 480 synthetic images kept whole, compact + fused, 2 rounds held
    by the update-norm ratio (1e-3)."""
    n = 8
    jds, tds = jax_make_cifar(480, 64), make_synthetic_cifar(480, 64)
    kw = dict(paper_cifar.RAGGED_FORMS["RC"].kw, n_clients=n)
    from repro.configs import paper_cifar as jax_paper_cifar
    jcfg, tcfg = jax_paper_cifar.fl_config(**kw), paper_cifar.fl_config(**kw)
    jdata, _, jrag, _ = jax_federated_pooled(jds, n_clients=n, beta=0.5)
    tdata, _, trag, _ = federated_pooled(tds, n_clients=n, beta=0.5,
                                         device="cpu")
    _same_spec(trag, jrag)
    assert not trag.uniform
    jparams = jax.device_get(jax_init_cnn(jax.random.PRNGKey(0)))
    seen = _run_synced(
        jcfg, tcfg, jax_make_loss_fn(jax_cnn_logits),
        make_loss_fn(cnn_logits), jdata, tdata, jparams,
        nest_params(params_from_numpy(jparams, device="cpu")), rounds=2,
        update_tol=1e-3, ragged=trag)
    assert seen["events"] > 0 and seen["flipped_rounds"] == 0


# --- federated_pooled and the paper workloads -------------------------------

@pytest.mark.parametrize("which", ["mnist", "cifar"])
def test_federated_pooled_equals_reference(which):
    if which == "mnist":
        jds, tds = jax_make_mnist(1200, 100), make_synthetic_mnist(1200, 100)
        kw = dict(n_clients=10, scheme="label_shard")
    else:
        jds, tds = jax_make_cifar(480, 64), make_synthetic_cifar(480, 64)
        kw = dict(n_clients=8, scheme="dirichlet", beta=0.5)
    got, gtest, spec, stats = federated_pooled(tds, device="cpu", **kw)
    want, wtest, jspec, jstats = jax_federated_pooled(jds, **kw)
    _same_spec(spec, jspec)
    assert spec.total == len(tds.y_train) and stats.dropped == 0
    np.testing.assert_array_equal(stats.sizes, jstats.sizes)
    for a, b in ((got, want), (gtest, wtest)):
        for k in ("x", "y"):
            assert a[k].numpy().tobytes() == np.asarray(b[k]).tobytes(), k


@pytest.mark.parametrize("shards", [1, 2])
def test_paper_mnist_pooled_workload(shards):
    """12,000 examples pooled over 100 clients of 114–123, 4 padded
    buckets; with 2 shards reordered so each holds about half."""
    data, _, _, _, rspec = paper_mnist.pooled_workload(device="cpu",
                                                       shards=shards)
    assert rspec.total == 12000 and data["x"].shape == (12002, 784)
    assert (rspec.min_size, rspec.max_size) == (114, 123)
    assert [(b.capacity, len(b.members)) for b in rspec.buckets] == \
        [(115, 10), (119, 13), (121, 44), (123, 33)]
    assert all(b.padded for b in rspec.buckets)
    if shards == 2:
        assert abs(sum(rspec.sizes[:50]) - sum(rspec.sizes[50:])) <= 123
    assert set(paper_mnist.RAGGED_FORMS) == {"RA", "RB", "RS"}
    assert paper_mnist.RAGGED_FORMS["RS"].shards == 2


# --- the client mesh -------------------------------------------------------

N_MESH, MESH_ROUNDS = 8, 5
MESH_SIZES = [7, 3, 8, 5, 2, 8, 6, 4]
MESH_BASE = dict(algorithm="fedback", n_clients=N_MESH, participation=0.5,
                 rho=1.0, lr=0.1, momentum=0.0, epochs=2, batch_size=4,
                 capacity_slack=1.0, use_trigger_kernel=True,
                 use_admm_kernel=True)
MESH_CASES = {
    # name: (layout, P, FLConfig keywords)
    "dense_flat_p2": ("flat", 2, {}),
    "dense_flat_p4": ("flat", 4, {}),
    "compact_fused_flat_p2": ("flat", 2, dict(compact=True, fused_gss=True)),
    "compact_fused_flat_p4": ("flat", 4, dict(compact=True, fused_gss=True)),
    "compact_tree_p2": ("tree", 2, dict(compact=True)),
    "dense_tree_p2": ("tree", 2, {}),
}
MESH_CTRL = dict(K=0.2, alpha=0.9)

_MESH_SCRIPT = r"""
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import json, pickle, sys
import jax, numpy as np
from repro.core import ControllerConfig, FLConfig, init_state, make_round_fn
from repro.core import make_flat_spec
from repro.data import make_least_squares
from repro.sharding.clients import balanced_permutation, make_client_mesh
from repro.utils.ragged import pool_data

cases, ctrl, n, sizes, rounds, out_path = json.loads(sys.argv[1])
data, params, loss = make_least_squares(n, 8, 5)
out = {}
for name, (layout, p, kw) in cases.items():
    perm = balanced_permutation(sizes, p)
    pooled, rspec = pool_data(
        [np.asarray(data["x"][i])[:sizes[i]] for i in perm],
        [np.asarray(data["y"][i])[:sizes[i]] for i in perm])
    cfg = FLConfig(controller=ControllerConfig(**ctrl), **kw)
    spec = make_flat_spec(params) if layout == "flat" else None
    mesh = make_client_mesh(p)
    state = init_state(cfg, params, mesh=mesh, spec=spec)
    round_fn = make_round_fn(cfg, loss, pooled, mesh=mesh, spec=spec,
                             ragged=rspec)
    steps = []
    for _ in range(rounds):
        before = jax.device_get(state)
        state, m = round_fn(state)
        steps.append((before, jax.device_get(state), jax.device_get(m)))
    out[name] = (perm.tolist(), steps)
with open(out_path, "wb") as f:
    pickle.dump(out, f)
"""


@pytest.fixture(scope="module")
def mesh_reference(tmp_path_factory):
    """The reference's sharded ragged rounds of every case (one
    subprocess on 4 forced host devices)."""
    path = tmp_path_factory.mktemp("ragged_mesh") / "runs.pkl"
    cases = {k: (lay, p, dict(MESH_BASE, **kw))
             for k, (lay, p, kw) in MESH_CASES.items()}
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               JAX_PLATFORMS="cpu")
    out = subprocess.run(
        [sys.executable, "-c", _MESH_SCRIPT,
         json.dumps([cases, MESH_CTRL, N_MESH, MESH_SIZES, MESH_ROUNDS,
                     str(path)])],
        env=env, capture_output=True, text=True, timeout=600, cwd=REPO)
    assert out.returncode == 0, out.stderr[-3000:]
    with open(path, "rb") as f:  # written by the subprocess above
        return pickle.load(f)


@pytest.mark.parametrize("case", list(MESH_CASES))
def test_sharded_ragged_round_matches_jax(case, mesh_reference):
    """The port's sharded ragged round from each of the reference's
    states: events, ``committed`` and the counts equal, δ and the loads
    within one ulp (D1), the state at rtol 1e-4 / atol 1e-6 and ω at
    rtol 1e-6 / atol 1e-7 (the shards' partial sums in shard order)."""
    layout, p, kw = MESH_CASES[case]
    perm, steps = mesh_reference[case]
    np.testing.assert_array_equal(balanced_permutation(MESH_SIZES, p), perm)
    cfg = FLConfig(controller=ControllerConfig(**MESH_CTRL),
                   **dict(MESH_BASE, **kw))
    data, params, loss = make_least_squares(N_MESH, 8, 5, device="cpu")
    pooled, rspec = pool_data(
        [data["x"][i][:MESH_SIZES[i]] for i in perm],
        [data["y"][i][:MESH_SIZES[i]] for i in perm], device="cpu")
    assert sum(b.padded for b in rspec.buckets) >= 2
    spec = make_flat_spec(params) if layout == "flat" else None
    mesh = make_client_mesh(p, ["cpu"])
    round_fn = make_round_fn(cfg, loss, pooled, spec=spec, mesh=mesh,
                             ragged=rspec)
    events = 0
    for r, (before, want, wm) in enumerate(steps):
        new, m = round_fn(state_from_numpy(before, mesh=mesh))
        got = state_to_numpy(new)
        msg = f"{case} round {r}"
        np.testing.assert_allclose(m.distances.numpy(), wm.distances,
                                   rtol=1e-6, atol=1e-7, err_msg=msg)
        np.testing.assert_array_equal(m.events.numpy(), wm.events,
                                      err_msg=msg)
        np.testing.assert_array_equal(m.committed.numpy(), wm.committed,
                                      err_msg=msg)
        for f in ("num_events", "num_deferred", "realized_capacity"):
            assert int(getattr(m, f)) == int(getattr(wm, f)), (msg, f)
        d_ulp = np.spacing(np.maximum.reduce([
            np.abs(got.ctrl.delta), np.abs(np.asarray(want.ctrl.delta)),
            np.abs(np.asarray(before.ctrl.delta))]))
        assert np.all(np.abs(got.ctrl.delta - np.asarray(want.ctrl.delta))
                      <= d_ulp), msg
        for a, b in ((got.ctrl.load, want.ctrl.load),
                     (got.queue.load, want.queue.load)):
            b = np.asarray(b)
            assert np.all(np.abs(a - b) <= np.spacing(np.maximum(
                np.abs(a), np.abs(b)))), msg
        np.testing.assert_array_equal(got.queue.age, want.queue.age)
        for f in ("theta", "lam", "z_prev", "omega"):
            for a, b in zip(jax.tree.leaves(getattr(got, f)),
                            jax.tree.leaves(getattr(want, f)), strict=True):
                np.testing.assert_allclose(a, np.asarray(b), rtol=1e-4,
                                           atol=1e-6, err_msg=f"{msg} {f}")
        for a, b in zip(jax.tree.leaves(got.omega),
                        jax.tree.leaves(want.omega), strict=True):
            np.testing.assert_allclose(a, np.asarray(b), rtol=1e-6,
                                       atol=1e-7, err_msg=f"{msg} omega")
        np.testing.assert_array_equal(got.rng, np.asarray(want.rng))
        events += int(wm.num_events)
    assert events > 0


def test_sharded_dense_ragged_round_equals_one_device():
    """Dense ragged rounds on 4 CPU shards and on one device, free
    running: the same events and ω within 1e-5 (each shard solves its
    own members of every bucket, reading global rows of its copy of the
    pool)."""
    data, p0, ls = make_least_squares(N_MESH, 8, 5, device="cpu")
    pooled, rspec = pool_data(
        [data["x"][i][:s] for i, s in enumerate(MESH_SIZES)],
        [data["y"][i][:s] for i, s in enumerate(MESH_SIZES)], device="cpu")
    assert sum(b.padded for b in rspec.buckets) >= 2
    cfg = FLConfig(controller=ControllerConfig(K=1.0, alpha=0.9),
                   **dict(MESH_BASE, participation=0.25))
    spec = make_flat_spec(p0)
    mesh = make_client_mesh(4, ["cpu"])
    sharded = make_round_fn(cfg, ls, pooled, spec=spec, mesh=mesh,
                            ragged=rspec)
    single = make_round_fn(cfg, ls, pooled, spec=spec, device="cpu",
                           ragged=rspec)
    shards = init_state(cfg, p0, spec=spec, mesh=mesh)
    state = init_state(cfg, p0, spec=spec, device="cpu")
    events = 0
    for _ in range(8):
        shards, ms = sharded(shards)
        state, m = single(state)
        assert torch.equal(ms.events, m.events)
        events += int(m.num_events)
    assert 0 < events < 8 * N_MESH
    torch.testing.assert_close(shards[0].omega, state.omega, rtol=1e-5,
                               atol=1e-7)


def test_ragged_round_refuses_a_mismatched_spec():
    pooled, rspec, p0, ls = _serve_pool(12)
    spec = make_flat_spec(p0)
    with pytest.raises(ValueError, match="12 clients"):
        make_round_fn(_ls_cfg(8), ls, pooled, spec=spec, device="cpu",
                      ragged=rspec)
    short = {k: v[:-1] for k, v in pooled.items()}
    with pytest.raises(ValueError, match="rows"):
        make_round_fn(_ls_cfg(12), ls, short, spec=spec, device="cpu",
                      ragged=rspec)

"""The client mesh of the port against the reference's, piece by piece.

* ``ClientMesh`` / ``make_client_mesh``: CUDA by default (raising
  without a card), repeated devices, shard i on device i mod their
  count; ``check_divisible``; ``shard_rows`` / ``unshard_rows`` (blocks
  that own their storage) and ``replicate_data``.
* ``capacity_for`` / ``capacity_bounds`` with ``n_shards`` and
  ``balanced_permutation``: equal to the reference's.
* The commit limit's sum over a shard's n_local loads: bit-equal to
  ``jnp.sum`` at the local counts of the sharded rounds.
* K1b and K2b: the port's plain versions (what runs on CPU tensors)
  against the reference's ``trigger_sq_norms_sharded`` /
  ``admm_update_sharded`` in interpret mode on 2 and 4 forced host
  devices (a subprocess: the device count is set before ``jax`` is
  imported) — K2b bit-exact, K1b at rtol 1e-6 — and each shard's rows
  against the unsharded kernel's; K1c's ``mesh=`` path likewise.
* The draws over all clients (random, bernoulli, round robin) under a
  mesh give every client its unsharded event.
* ``convert.state_from_numpy(mesh=)`` / ``state_to_numpy`` round trip,
  and a shard list whose replicas differ is refused.
"""
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import compact as jcompact
from repro.core import init_state as jax_init_state
from repro.core import FLConfig as JFLConfig
from repro.sharding import clients as jclients
from repro_torch import prng
from repro_torch.convert import state_from_numpy, state_to_numpy
from repro_torch.core import ControllerConfig, FLConfig, compact, \
    init_state, make_round_fn
from repro_torch.core.selection import make_selection
from repro_torch.data import make_least_squares
from repro_torch.kernels import ops
from repro_torch.sharding import ClientMesh, balanced_permutation, \
    check_divisible, make_client_mesh, replicate_data, shard_rows, \
    unshard_rows

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N, D = 8, 300
KERNEL_SHAPES = [(2, 8, 300), (4, 8, 300), (2, 12, 1030), (4, 12, 1030)]

_JAX_SCRIPT = r"""
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import json, sys
import jax, jax.numpy as jnp, numpy as np
from repro.kernels import ops
from repro.kernels.admm_update import admm_update_sharded
from repro.kernels.trigger_norms import trigger_sq_norms_sharded
from repro.sharding.clients import make_client_mesh
from jax.sharding import NamedSharding, PartitionSpec as P

out = []
for p, n, d in json.loads(sys.argv[1]):
    rng = np.random.default_rng(p * 1000 + n + d)
    z, th, la = (rng.normal(size=(n, d)).astype(np.float32) for _ in range(3))
    w = rng.normal(size=(d,)).astype(np.float32)
    mesh = make_client_mesh(p)
    put = lambda x: jax.device_put(x, NamedSharding(mesh, P("clients")))
    sq = trigger_sq_norms_sharded(put(z), jnp.asarray(w), mesh,
                                  interpret=True)
    res = {"z": z.tolist(), "w": w.tolist(), "theta": th.tolist(),
           "lam": la.tolist(), "sq": np.asarray(sq).tolist()}
    for with_z in (True, False):
        outs = admm_update_sharded(put(th), put(la), jnp.asarray(w), mesh,
                                   interpret=True, with_z=with_z)
        res[f"admm_{with_z}"] = [np.asarray(o).tolist() for o in outs]
    tree = {"a": z[:, :d // 3].reshape(n, -1, 1), "b": z[:, d // 3:]}
    wt = {"a": w[:d // 3].reshape(-1, 1), "b": w[d // 3:]}
    res["tree_sq"] = np.asarray(ops.trigger_sq_norms_pytree(
        jax.tree.map(put, tree), jax.tree.map(jnp.asarray, wt), mesh=mesh,
        interpret=True)).tolist()
    out.append(res)
print("RESULT:" + json.dumps(out))
"""


@pytest.fixture(scope="module")
def jax_kernels():
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", _JAX_SCRIPT,
                          json.dumps(KERNEL_SHAPES)], env=env,
                         capture_output=True, text=True, timeout=300,
                         cwd=REPO)
    assert out.returncode == 0, out.stderr[-3000:]
    line = [x for x in out.stdout.splitlines() if x.startswith("RESULT:")]
    return json.loads(line[-1][len("RESULT:"):])


def _f32(x):
    return torch.tensor(np.asarray(x, np.float32))


def _cpu_mesh(p):
    return make_client_mesh(p, ["cpu"])


def test_make_client_mesh_needs_a_card_unless_told():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible")
    with pytest.raises(RuntimeError, match="CUDA"):
        make_client_mesh(2)


def test_make_client_mesh_repeats_devices():
    mesh = make_client_mesh(4, ["cpu"])
    assert mesh == ClientMesh((torch.device("cpu"),) * 4)
    assert mesh.size == 4
    two = make_client_mesh(3, ["cpu", "meta"])
    assert [d.type for d in two.devices] == ["cpu", "meta", "cpu"]
    with pytest.raises(ValueError):
        make_client_mesh(0, ["cpu"])


@pytest.mark.parametrize("n,p", [(8, 2), (8, 3), (100, 4), (100, 3),
                                 (7, 7)])
def test_check_divisible(n, p):
    mesh = _cpu_mesh(p)
    if n % p:
        with pytest.raises(ValueError, match="divisible"):
            check_divisible(n, mesh)
        with pytest.raises(ValueError):
            jclients.check_divisible(n, _FakeMesh(p))
    else:
        check_divisible(n, mesh)
        jclients.check_divisible(n, _FakeMesh(p))


class _FakeMesh:
    """What the reference's ``check_divisible`` reads of a mesh."""

    def __init__(self, p):
        self.shape = {"clients": p}


def test_shard_rows_blocks_own_their_storage():
    x = torch.arange(24.0).reshape(8, 3)
    tree = {"a": x, "b": {"c": torch.arange(8)}}
    shards = shard_rows(tree, _cpu_mesh(4))
    assert len(shards) == 4
    for i, s in enumerate(shards):
        torch.testing.assert_close(s["a"], x[2 * i:2 * i + 2])
        assert s["a"].untyped_storage().data_ptr() != \
            x.untyped_storage().data_ptr()
        assert s["a"].untyped_storage().nbytes() == 2 * 3 * 4
    back = unshard_rows(shards)
    torch.testing.assert_close(back["a"], x)
    torch.testing.assert_close(back["b"]["c"], torch.arange(8))
    (one,) = shard_rows(tree, _cpu_mesh(1))
    assert one["a"] is x and unshard_rows([one]) is one
    with pytest.raises(ValueError, match="divisible"):
        shard_rows(x, _cpu_mesh(3))
    copies = replicate_data(_cpu_mesh(3), x)
    assert len(copies) == 3 and all(c is x for c in copies)


@pytest.mark.parametrize("n", [8, 16, 64, 100, 1000])
@pytest.mark.parametrize("p", [1, 2, 4])
def test_capacity_with_shards_matches_jax(n, p):
    for rate in (0.05, 0.1, 0.25, 0.5, 1.0):
        for slack in (1.0, 1.25, 1.5, 3.0):
            for cap in (None, 1, 3, 15, n):
                want = jcompact.capacity_bounds(n, rate, slack, cap,
                                                n_shards=p)
                got = compact.capacity_bounds(n, rate, slack, cap,
                                              n_shards=p)
                assert got == want, (n, p, rate, slack, cap)
                assert compact.capacity_for(n, rate, slack, cap,
                                            n_shards=p) == \
                    jcompact.capacity_for(n, rate, slack, cap, n_shards=p)


def test_paper_mnist_capacity_per_shard():
    # C = ⌈1.5·0.1·100⌉ = 16 (the fp64 product lands above 15): ⌈16/2⌉ =
    # 8 slots a shard at P = 2, 4 at P = 4; floors ⌈0.1·50⌉, ⌈0.1·25⌉.
    assert compact.capacity_bounds(100, 0.1, 1.5, n_shards=2) == (5, 8)
    assert compact.capacity_bounds(100, 0.1, 1.5, n_shards=4) == (3, 4)
    with pytest.raises(ValueError, match="divisible"):
        compact.capacity_for(100, 0.1, 1.5, n_shards=3)


@pytest.mark.parametrize("p", [2, 3, 4])
def test_balanced_permutation_matches_jax(p):
    rng = np.random.default_rng(p)
    for _ in range(20):
        sizes = rng.integers(1, 200, 12)
        np.testing.assert_array_equal(
            balanced_permutation(sizes, p),
            jclients.balanced_permutation(sizes, p))
    with pytest.raises(ValueError):
        balanced_permutation(np.ones(10), 4)


@pytest.mark.parametrize("n_local", [4, 12, 25, 50])
def test_shard_commit_limit_bit_equal(n_local):
    """The adaptive limit sums a shard's n_local loads; those sums must
    be XLA's at the sharded rounds' local counts (8 / 2, 100 / 4 …)."""
    rng = np.random.default_rng(n_local)
    for trial in range(40):
        qload = (rng.random(n_local) * rng.choice([1.0, 1e-3, 0.05], n_local)
                 ).astype(np.float32)
        want = jax.jit(jnp.sum)(jnp.asarray(qload))
        got = compact.sum_in_xla_cpu_order(torch.from_numpy(qload))
        assert got.numpy().tobytes() == np.asarray(want).tobytes(), trial
        hi = max(2, n_local // 3)
        assert int(compact.adaptive_limit(torch.from_numpy(qload), 1, hi)) \
            == int(jcompact.adaptive_limit(jnp.asarray(qload), 1, hi))


@pytest.mark.parametrize("case", range(len(KERNEL_SHAPES)))
def test_sharded_kernels_match_jax(case, jax_kernels):
    p, n, d = KERNEL_SHAPES[case]
    res = jax_kernels[case]
    mesh = _cpu_mesh(p)
    z, w, th, la = (_f32(res[k]) for k in ("z", "w", "theta", "lam"))
    zs, ws = shard_rows(z, mesh), replicate_data(mesh, w)
    sq = ops.trigger_sq_norms_sharded(zs, ws, mesh)
    assert len(sq) == p
    np.testing.assert_allclose(torch.cat(sq).numpy(), np.asarray(res["sq"]),
                               rtol=1e-6)
    for got, part in zip(sq, zs, strict=True):
        assert torch.equal(got, ops.trigger_sq_norms(part, w))
    for with_z in (True, False):
        outs = ops.admm_update(shard_rows(th, mesh), shard_rows(la, mesh),
                               ws, with_z=with_z, mesh=mesh)
        want = ops.admm_update(th, la, w, with_z=with_z)
        assert len(outs) == len(want) == len(res[f"admm_{with_z}"])
        for got, x, jx in zip(outs, want, res[f"admm_{with_z}"],
                              strict=True):
            assert torch.equal(torch.cat(got), x)
            assert torch.cat(got).numpy().tobytes() == np.asarray(
                jx, np.float32).tobytes()
    tree = {"a": z[:, :d // 3].reshape(n, -1, 1), "b": z[:, d // 3:]}
    wt = {"a": w[:d // 3].reshape(-1, 1), "b": w[d // 3:]}
    tsq = ops.trigger_sq_norms_pytree(shard_rows(tree, mesh),
                                      replicate_data(mesh, wt), mesh=mesh)
    np.testing.assert_allclose(torch.cat(tsq).numpy(),
                               np.asarray(res["tree_sq"]), rtol=1e-6)
    assert all(v == 0 for v in ops.launch_counts().values())


def test_sharded_kernel_shards_checked():
    mesh = _cpu_mesh(2)
    z, w = torch.ones(4, 3), torch.ones(3)
    with pytest.raises(ValueError, match="expected 2 shards"):
        ops.trigger_sq_norms_sharded([z], [w], mesh)
    with pytest.raises(ValueError, match="shard 1 lies on meta"):
        ops.trigger_sq_norms_sharded([z, z.to("meta")], [w, w], mesh)
    with pytest.raises(ValueError, match="expected 2 shards"):
        ops.admm_update_sharded([z, z], [z], [w, w], mesh)
    # The plain versions are what CPU shards take.
    zs = [torch.randn(4, 3), torch.randn(4, 3)]
    ws = [torch.randn(3)] * 2
    for got, want in zip(ops.trigger_sq_norms_sharded(zs, ws, mesh),
                         ops.trigger_sq_norms_sharded_ref(zs, ws),
                         strict=True):
        assert torch.equal(got, want)
    for got, want in zip(ops.admm_update_sharded(zs, zs, ws, mesh),
                         ops.admm_update_sharded_ref(zs, zs, ws),
                         strict=True):
        assert all(torch.equal(a, b) for a, b in zip(got, want, strict=True))


class _Shard:
    """What the selections read of a shard's state."""

    def __init__(self, delta, rnd):
        self.ctrl = type("C", (), {"delta": delta})()
        self.round = rnd


@pytest.mark.parametrize("name", ["random", "bernoulli", "round_robin",
                                  "fedback", "full"])
@pytest.mark.parametrize("p", [2, 4])
def test_draws_under_a_mesh_equal_unsharded(name, p):
    n = 100
    sel = make_selection(name, rate=0.1, controller=ControllerConfig())
    mesh = _cpu_mesh(p)
    rng = np.random.default_rng(p)
    delta = torch.from_numpy(rng.random(n).astype(np.float32))
    dist = torch.from_numpy(rng.random(n).astype(np.float32))
    for r in range(5):
        key = prng.split(prng.PRNGKey(r, device="cpu"), 2)[1]
        rnd = torch.tensor(r, dtype=torch.int32)
        want = sel.decide(key, _Shard(delta, rnd), dist)
        shards = [_Shard(d, rnd) for d in shard_rows(delta, mesh)]
        got = sel.decide_shards(key, shards, shard_rows(dist, mesh), mesh)
        assert len(got) == p and all(g.shape == (n // p,) for g in got)
        assert torch.equal(torch.cat(got), want), (name, r)
        if name in ("random", "round_robin"):
            elig = torch.from_numpy(rng.random(n) < 0.6)
            want = sel.decide(key, _Shard(delta, rnd), dist, eligible=elig)
            got = sel.decide_shards(key, shards, shard_rows(dist, mesh),
                                    mesh, eligible=shard_rows(elig, mesh))
            assert torch.equal(torch.cat(got), want), (name, r)


def test_state_round_trip_through_shards():
    _, params, _ = make_least_squares(N, 8, 5, device="cpu")
    cfg = FLConfig(n_clients=N, compact=True)
    want = jax.device_get(jax_init_state(JFLConfig(n_clients=N,
                                                   compact=True),
                                         {"theta": jnp.arange(5.0)}))
    mesh = _cpu_mesh(4)
    shards = state_from_numpy(want, mesh=mesh)
    assert len(shards) == 4 and shards[1].queue.age.shape == (2,)
    got = state_to_numpy(shards)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want),
                    strict=True):
        np.testing.assert_array_equal(a, np.asarray(b))
    mine = init_state(cfg, params, mesh=mesh)
    assert [s.theta["theta"].shape for s in mine] == [(2, 5)] * 4
    assert len({s.theta["theta"].data_ptr() for s in mine}) == 4
    bad = list(mine)
    bad[2] = bad[2]._replace(omega={"theta": bad[2].omega["theta"] + 1})
    with pytest.raises(ValueError, match="replicated omega differ"):
        state_to_numpy(bad)


def test_mesh_refusals():
    data, params, loss = make_least_squares(N, 8, 5, device="cpu")
    mesh = _cpu_mesh(2)
    with pytest.raises(ValueError, match="not both"):
        init_state(FLConfig(n_clients=N), params, device="cpu", mesh=mesh)
    with pytest.raises(ValueError, match="divisible"):
        init_state(FLConfig(n_clients=N), params, mesh=_cpu_mesh(3))
    with pytest.raises(ValueError, match="divisible"):
        make_round_fn(FLConfig(n_clients=N), loss, data, mesh=_cpu_mesh(3))
    with pytest.raises(ValueError, match="single-host"):
        make_round_fn(FLConfig(n_clients=N, state_backend="host"), loss,
                      data, mesh=mesh)
    # A per-client target is no longer refused: each shard takes its
    # rows (tests/test_torch_mesh_targets.py holds it against JAX).
    per_client = FLConfig(n_clients=N, controller=ControllerConfig(
        target_rate=torch.full((N,), 0.2)))
    shards = init_state(per_client, params, mesh=mesh)
    _, m = make_round_fn(per_client, loss, data, mesh=mesh)(shards)
    assert tuple(m.delta.shape) == (N,)


def test_eval_fn_reads_a_shard_list_and_any_state_with_omega():
    from repro_torch.core import init_scaffold, make_eval_fn

    data, params, _ = make_least_squares(N, 8, 5, device="cpu")
    cfg = FLConfig(n_clients=N)

    def loss_and_acc(p, x, y):
        return torch.sum(p["theta"]) + x.sum(), y.sum()

    eval_fn = make_eval_fn(loss_and_acc, device="cpu")
    x, y = torch.ones(3, 5), torch.zeros(3)
    shards = init_state(cfg, {"theta": torch.arange(5.0)},
                        mesh=_cpu_mesh(2))
    single = init_state(cfg, {"theta": torch.arange(5.0)}, device="cpu")
    assert eval_fn(shards, x, y) == eval_fn(single, x, y)
    scaffold = init_scaffold(FLConfig(algorithm="scaffold", n_clients=N),
                             params, device="cpu")
    assert eval_fn(scaffold, x, y)[0] == 15.0

"""The tree layout's building blocks against the JAX package.

* The pytree helpers (``repro_torch.utils.pytree``): leaf order, the
  row-masked select, broadcast, per-client squared norms, size, and
  the flatten helpers against the reference's flat codec (bit-equal).
* K1c's plain version (``trigger_sq_norms_pytree`` on CPU tensors)
  against ``repro.kernels.ops.trigger_sq_norms_pytree`` with its Pallas
  kernel in interpret mode, on a stacked tree of 1-D, 2-D and 4-D
  leaves, in fp32 and with one bf16 leaf (rtol 1e-6); the flat case is
  read in place.
* The tree ``trigger_distances`` for l2, linf and cosine (rtol 1e-6).
* ``dual_ascent``, ``prox_center``, ``gated_commit``, the SGD step and
  the compact plan's row gather/scatter on trees, bit-exact; the
  consensus and participant means (reductions) at rtol 1e-6.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import compact as jax_compact
from repro.core import engine as jax_engine
from repro.core.trigger import trigger_distances as jax_trigger_distances
from repro.kernels import ops as jax_ops
from repro.optim.sgd import SGDState as JSGDState
from repro.optim.sgd import sgd_step as jax_sgd_step
from repro.utils import pytree as jax_pytree
from repro_torch.core import compact, engine
from repro_torch.core.trigger import trigger_distances
from repro_torch.kernels import ops
from repro_torch.optim.sgd import sgd_step
from repro_torch.utils import pytree

N = 6
# Leaves of rank 1, 2 and 4 (an HWIO kernel), keys out of sorted order.
SHAPES = {"fc": {"w": (7, 5), "b": (5,)}, "conv": {"w": (3, 3, 2, 4),
                                                   "b": (4,)},
          "a_scale": (3,)}


def _tree(rng, stacked=True):
    def leaf(shape):
        shape = ((N,) if stacked else ()) + shape
        return rng.normal(size=shape).astype(np.float32)

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        return leaf(node)
    return walk(SHAPES)


def _jax(tree):
    return jax.tree.map(jnp.asarray, tree)


def _torch(tree):
    return jax.tree.map(torch.from_numpy, tree)


def _assert_equal(got, want):
    got, want = pytree.tree_leaves(got), jax.tree.leaves(want)
    assert len(got) == len(want)
    for g, w in zip(got, want, strict=True):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_leaves_come_in_jax_order():
    rng = np.random.default_rng(0)
    tree = _tree(rng)
    got = [t.numpy() for t in pytree.tree_leaves(_torch(tree))]
    want = jax.tree.leaves(tree)
    assert [g.shape for g in got] == [w.shape for w in want]
    for g, w in zip(got, want, strict=True):
        np.testing.assert_array_equal(g, w)
    assert pytree.tree_size(_torch(tree)) == jax_pytree.tree_size(tree)
    one = torch.zeros(3, 4)
    assert pytree.tree_leaves(one) == [one]
    assert pytree.tree_map(lambda x: x + 1, one).sum() == 12


def test_tree_map_refuses_other_structures():
    a = {"x": torch.zeros(2), "y": torch.zeros(2)}
    with pytest.raises(ValueError, match="structures differ"):
        pytree.tree_map(torch.add, a, {"x": torch.zeros(2)})
    with pytest.raises(ValueError, match="structures differ"):
        pytree.tree_map(torch.add, a, torch.zeros(2))


def test_flatten_helpers_lay_leaves_out_as_flatstate():
    """``flatten`` / ``flatten_stacked`` (shared by ``FlatSpec`` and
    K1c's front end) lay the leaves out in the reference flat codec's
    order, bf16 leaves cast to fp32."""
    from repro.utils.flatstate import make_flat_spec as jax_make_flat_spec
    from repro_torch.kernels.trigger_pytree import pytree_operands
    from repro_torch.utils import make_flat_spec

    rng = np.random.default_rng(5)
    stacked, omega = _tree(rng), _tree(rng, stacked=False)
    jspec = jax_make_flat_spec(omega)
    want_z = np.asarray(jspec.flatten_stacked(_jax(stacked)))
    want_w = np.asarray(jspec.flatten(_jax(omega)))
    got_z = pytree.flatten_stacked(_torch(stacked))
    np.testing.assert_array_equal(got_z.numpy(), want_z)
    np.testing.assert_array_equal(pytree.flatten(_torch(omega)).numpy(),
                                  want_w)
    spec = make_flat_spec(_torch(omega))
    assert torch.equal(spec.flatten_stacked(_torch(stacked)), got_z)
    z2d, w1d = pytree_operands(_torch(stacked), _torch(omega))
    assert torch.equal(z2d, got_z) and w1d.dtype == torch.float32
    half = _torch(stacked)
    half["fc"]["w"] = half["fc"]["w"].to(torch.bfloat16)
    got = pytree.flatten_stacked(half)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(
        got.numpy(), make_flat_spec(_torch(omega)).flatten_stacked(
            half).numpy())


def test_where_broadcast_zeros_and_norms_match_jax():
    rng = np.random.default_rng(1)
    a, b = _tree(rng), _tree(rng)
    mask = rng.random(N) < 0.5
    _assert_equal(pytree.tree_where(torch.from_numpy(mask), _torch(a),
                                    _torch(b)),
                  jax_pytree.tree_where(jnp.asarray(mask), _jax(a), _jax(b)))
    w = _tree(rng, stacked=False)
    _assert_equal(pytree.tree_broadcast_like(_torch(w), N),
                  jax_pytree.tree_broadcast_like(_jax(w), N))
    _assert_equal(pytree.tree_zeros_like(_torch(a)),
                  jax_pytree.tree_zeros_like(_jax(a)))
    np.testing.assert_allclose(
        pytree.stacked_sq_norms(_torch(a)).numpy(),
        np.asarray(jax_pytree.stacked_sq_norms(_jax(a))), rtol=1e-6)


def _bf16_tree(tree):
    """One leaf (the 4-D kernel) in bf16, in both packages."""
    j, t = _jax(tree), _torch(tree)
    j["conv"]["w"] = j["conv"]["w"].astype(jnp.bfloat16)
    t["conv"]["w"] = t["conv"]["w"].to(torch.bfloat16)
    return j, t


@pytest.mark.parametrize("bf16", [False, True])
def test_k1c_plain_version_matches_the_pallas_front_end(bf16):
    rng = np.random.default_rng(2)
    z, w = _tree(rng), _tree(rng, stacked=False)
    (jz, tz), (jw, tw) = ((_bf16_tree(t) if bf16 else (_jax(t), _torch(t)))
                          for t in (z, w))
    want = np.asarray(jax_ops.trigger_sq_norms_pytree(jz, jw,
                                                      interpret=True))
    ops.reset_launch_counts()
    got = ops.trigger_sq_norms_pytree(tz, tw)
    assert got.dtype == torch.float32 and got.shape == (N,)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)
    np.testing.assert_array_equal(
        ops.trigger_sq_norms_pytree_ref(tz, tw).numpy(), got.numpy())
    # CPU tensors take the plain version: nothing is launched.
    assert all(v == 0 for v in ops.launch_counts().values())


def test_k1c_reads_the_flat_matrix_in_place(monkeypatch):
    from repro_torch.kernels import trigger_pytree

    rng = np.random.default_rng(3)
    z = torch.from_numpy(rng.normal(size=(N, 40)).astype(np.float32))
    w = torch.from_numpy(rng.normal(size=40).astype(np.float32))
    seen = []

    def spy(z2d, w1d):
        seen.append((z2d.data_ptr(), w1d.data_ptr()))
        return ops.trigger_sq_norms_ref(z2d, w1d)

    monkeypatch.setattr(trigger_pytree, "trigger_sq_norms", spy)
    got = ops.trigger_sq_norms_pytree(z, w)
    assert seen == [(z.data_ptr(), w.data_ptr())]  # no copy
    want = np.asarray(jax_ops.trigger_sq_norms_pytree(
        jnp.asarray(z.numpy()), jnp.asarray(w.numpy()), interpret=True))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)


def test_k1c_hbm_bytes_count_each_leaf_once():
    rng = np.random.default_rng(4)
    z, w = _tree(rng), _tree(rng, stacked=False)
    _, tz = _bf16_tree(z)
    _, tw = _bf16_tree(w)
    size = jax_pytree.tree_size(w)
    conv = 3 * 3 * 2 * 4
    want = (N + 1) * (4 * (size - conv) + 2 * conv) + 4 * N
    assert ops.trigger_sq_norms_pytree_hbm_bytes(tz, tw) == want


@pytest.mark.parametrize("metric", ["l2", "linf", "cosine"])
def test_trigger_distances_on_trees(metric):
    rng = np.random.default_rng(5)
    z, w = _tree(rng), _tree(rng, stacked=False)
    want = np.asarray(jax_trigger_distances(_jax(w), _jax(z), metric))
    got = trigger_distances(_torch(w), _torch(z), metric)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)


def test_dual_algebra_and_commit_are_bit_exact():
    rng = np.random.default_rng(6)
    lam, theta, proposed = _tree(rng), _tree(rng), _tree(rng)
    w = _tree(rng, stacked=False)
    lam_new = engine.dual_ascent(_torch(lam), _torch(theta), _torch(w))
    want = jax_engine.dual_ascent(_jax(lam), _jax(theta), _jax(w))
    _assert_equal(lam_new, want)
    _assert_equal(engine.prox_center(_torch(w), lam_new),
                  jax_engine.prox_center(_jax(w), want))
    events = rng.random(N) < 0.5
    _assert_equal(engine.gated_commit(torch.from_numpy(events),
                                      _torch(proposed), _torch(theta)),
                  jax_engine.gated_commit(jnp.asarray(events),
                                          _jax(proposed), _jax(theta)))
    # The consensus mean is a reduction: held at a tolerance.
    for g, x in zip(pytree.tree_leaves(engine.consensus_mean(_torch(theta))),
                    jax.tree.leaves(jax_engine.consensus_mean(_jax(theta))),
                    strict=True):
        np.testing.assert_allclose(g.numpy(), np.asarray(x), rtol=1e-6,
                                   atol=1e-7)


@pytest.mark.parametrize("p", [0.0, 0.5])
def test_participant_mean_on_trees(p):
    rng = np.random.default_rng(7)
    z, w = _tree(rng), _tree(rng, stacked=False)
    events = rng.random(N) < p
    got = pytree.tree_leaves(engine.participant_mean(
        _torch(z), torch.from_numpy(events), _torch(w)))
    want = jax.tree.leaves(jax_engine.participant_mean(
        _jax(z), jnp.asarray(events), _jax(w)))
    for g, x in zip(got, want, strict=True):
        np.testing.assert_allclose(g.numpy(), np.asarray(x), rtol=1e-6,
                                   atol=1e-7)


def test_sgd_step_on_trees_is_bit_exact():
    rng = np.random.default_rng(8)
    p, g, m = _tree(rng), _tree(rng), _tree(rng)
    got_p, got_m = sgd_step(_torch(p), _torch(g), _torch(m), 0.01, 0.9)
    want_p, want_s = jax_sgd_step(_jax(p), _jax(g),
                                  JSGDState(_jax(m), jnp.zeros((), jnp.int32)),
                                  0.01, 0.9)
    _assert_equal(got_p, want_p)
    _assert_equal(got_m, want_s.momentum)


def test_gather_and_scatter_rows_on_trees():
    rng = np.random.default_rng(9)
    state, rows = _tree(rng), _tree(rng)
    rows = jax.tree.map(lambda x: x[:3], rows)
    idx = np.array([4, 0, 2], np.int32)
    valid = np.array([True, False, True])
    _assert_equal(compact.gather_rows(_torch(state), torch.from_numpy(idx)),
                  jax_compact.gather_rows(_jax(state), jnp.asarray(idx)))
    _assert_equal(compact.scatter_rows(_torch(state), _torch(rows),
                                       torch.from_numpy(idx),
                                       torch.from_numpy(valid)),
                  jax_compact.scatter_rows(_jax(state), _jax(rows),
                                           jnp.asarray(idx),
                                           jnp.asarray(valid)))

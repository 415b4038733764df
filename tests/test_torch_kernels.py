"""The port's kernel ops on the CPU against the JAX package's Pallas
kernels run in interpret mode, on the same numpy inputs.

On CPU tensors each op runs its plain PyTorch version (the kernels
themselves are held against those versions on the card by
``chip_smoke.py`` and ``tests/test_torch_cuda.py``).  Tolerances:

* ``trigger_sq_norms``: rtol 1e-6 — a sum over D, taken in another
  order than the Pallas kernel's blocked sum;
* ``admm_update`` and ``fused_gss``: bit-equal — elementwise adds and
  subtractions in the reference's order.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.kernels import ops

SHAPES = [(16, 130), (7, 1000), (1, 130), (33, 257)]


def _mk(rng, *shape):
    return rng.normal(size=shape).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(autouse=True)
def _counts_stay_zero():
    ops.reset_launch_counts()
    yield
    assert ops.launch_counts() == {k: 0 for k in ops.KERNELS}, \
        "a CPU tensor must never reach a kernel launch"


@pytest.mark.parametrize("n,d", SHAPES)
def test_trigger_sq_norms_matches_pallas(n, d):
    rng = np.random.default_rng(n * d)
    z, w = _mk(rng, n, d), _mk(rng, d)
    want = np.asarray(jops.trigger_sq_norms(jnp.asarray(z), jnp.asarray(w),
                                            interpret=True))
    got = ops.trigger_sq_norms(_t(z), _t(w)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6)
    got_tree = ops.trigger_sq_norms_pytree(_t(z), _t(w)).numpy()
    np.testing.assert_array_equal(got_tree, got)


@pytest.mark.parametrize("n,d", SHAPES)
@pytest.mark.parametrize("with_z", [True, False])
def test_admm_update_bit_equal(n, d, with_z):
    rng = np.random.default_rng(n + d)
    th, la, w = _mk(rng, n, d), _mk(rng, n, d), _mk(rng, d)
    want = jops.admm_update(jnp.asarray(th), jnp.asarray(la),
                            jnp.asarray(w), interpret=True, with_z=with_z)
    got = ops.admm_update(_t(th), _t(la), _t(w), with_z=with_z)
    assert len(got) == len(want) == (3 if with_z else 2)
    for g, x in zip(got, want, strict=True):
        assert g.numpy().tobytes() == np.asarray(x).tobytes()


@pytest.mark.parametrize("n,c,d", [(16, 8, 130), (64, 24, 1000), (9, 3, 7),
                                   (5, 5, 130), (1, 1, 130)])
@pytest.mark.parametrize("with_z", [True, False])
def test_fused_gss_bit_equal(n, c, d, with_z):
    rng = np.random.default_rng(7 * n + c + d)
    th, la, z, w, solved = (_mk(rng, n, d), _mk(rng, n, d), _mk(rng, n, d),
                            _mk(rng, d), _mk(rng, c, d))
    idx = rng.permutation(n)[:c].astype(np.int32)
    valid = rng.random(c) < 0.7
    valid[0] = True
    if c > 1:
        valid[-1] = False  # at least one invalid lane
    want = jops.fused_gss(jnp.asarray(idx), jnp.asarray(valid),
                          jnp.asarray(solved), jnp.asarray(w),
                          jnp.asarray(th), jnp.asarray(la),
                          jnp.asarray(z) if with_z else None,
                          interpret=True, with_z=with_z)
    tt, tl, tz = _t(th), _t(la), _t(z)  # copies: the op writes in place
    got = ops.fused_gss(_t(idx), _t(valid), _t(solved), _t(w), tt, tl,
                        tz if with_z else None, with_z=with_z)
    assert got[0] is tt and got[1] is tl  # in place, returned as given
    for g, x in zip(got, want, strict=True):
        assert g.numpy().tobytes() == np.asarray(x).tobytes()
    untouched = np.setdiff1d(np.arange(n), idx[valid])
    for before, after in ((th, tt), (la, tl), (z, tz)):
        np.testing.assert_array_equal(after.numpy()[untouched],
                                      before[untouched])
    if not with_z:
        np.testing.assert_array_equal(tz.numpy(), z)


def test_fused_gss_lambda_equals_admm_update():
    rng = np.random.default_rng(5)
    n, c, d = 12, 6, 130
    th, la, w, solved = (_mk(rng, n, d), _mk(rng, n, d), _mk(rng, d),
                         _mk(rng, c, d))
    idx = rng.permutation(n)[:c].astype(np.int32)
    lam_new, _ = ops.admm_update(_t(th[idx]), _t(la[idx]), _t(w),
                                 with_z=False)
    tl = _t(la)
    ops.fused_gss(_t(idx), torch.ones(c, dtype=torch.bool), _t(solved),
                  _t(w), _t(th), tl, with_z=False)
    assert tl.numpy()[idx].tobytes() == lam_new.numpy().tobytes()


def test_traffic_models():
    assert ops.admm_update_hbm_bytes(100, 159010, with_z=False) == \
        4 * (4 * 100 * 159010 + 159010)
    assert ops.fused_gss_hbm_bytes(16, 159010) == \
        4 * (6 * 16 * 159010 + 159010)
    assert ops.trigger_sq_norms_hbm_bytes(100, 159010) == \
        4 * (100 * 159010 + 159010 + 100)


def test_mixed_devices_raise():
    z = torch.zeros(2, 3)
    with pytest.raises(ValueError, match="CPU or all on one CUDA"):
        ops.trigger_sq_norms(z, torch.zeros(3, device="meta"))

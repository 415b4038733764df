"""The CIFAR CNN's convolution and the precision tool built on it.

* ``models.mlp.conv3x3_same`` (NCHW activations, HWIO kernel, SAME)
  against the reference's ``lax.conv_general_dilated`` on NHWC (rtol
  1e-5 / atol 1e-6).
* ``launch.conv_precision``: ``unfold_matmul`` computes the same
  convolution; every route's batched passes (forward, data and weight
  gradients, vmapped over clients as the solve batches them) lie within
  the 5e-5 of float64 that ``chip_smoke.py`` holds the card to, here on
  the CPU at a small size; ``update_ratio`` is the relative norm it
  says; ``cudnn_flags`` restores what it set.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.launch import conv_precision as cp
from repro_torch.models.mlp import conv3x3_same

CONV_REL_TOL = 5e-5  # chip_smoke.py's bound on the card


def test_conv3x3_same_matches_the_reference_convolution():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 8, 8, 3)).astype(np.float32)  # NHWC
    w = rng.normal(size=(3, 3, 3, 5)).astype(np.float32)  # HWIO
    want = jax.lax.conv_general_dilated(
        jnp.asarray(x), jnp.asarray(w), (1, 1), "SAME",
        dimension_numbers=("NHWC", "HWIO", "NHWC"))
    got = conv3x3_same(torch.from_numpy(x).permute(0, 3, 1, 2),
                       torch.from_numpy(w)).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


def test_unfold_matmul_is_the_same_convolution():
    g = torch.Generator().manual_seed(1)
    x = torch.randn(3, 4, 6, 6, generator=g)
    w = torch.randn(3, 3, 4, 7, generator=g)
    torch.testing.assert_close(cp.unfold_matmul(x, w), conv3x3_same(x, w),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("route", sorted(cp.ROUTES))
def test_batched_passes_within_the_fp32_bound(route):
    conv, flags = cp.ROUTES[route]
    inputs = cp.layer_inputs(2, 3, torch.device("cpu"))
    with cp.cudnn_flags(**flags):
        errs = cp.pass_errors(conv, inputs)
    assert sorted(errs) == ["conv1", "conv2", "conv3"]
    assert all(sorted(e) == sorted(cp.PASSES) for e in errs.values())
    assert 0.0 < cp.worst(errs) <= CONV_REL_TOL


def test_update_ratio_and_cudnn_flags():
    before = {"a": np.zeros(3, np.float32), "b": np.zeros(1, np.float32)}
    want = {"a": np.array([3.0, 0.0, 0.0], np.float32),
            "b": np.array([4.0], np.float32)}
    got = {"a": np.array([3.0, 0.5, 0.0], np.float32),
           "b": np.array([4.0], np.float32)}
    assert cp.update_ratio(got, want, before) == pytest.approx(0.1)
    assert cp.update_ratio(want, before, before) == 0.0
    old = torch.backends.cudnn.allow_tf32
    with cp.cudnn_flags(allow_tf32=not old):
        assert torch.backends.cudnn.allow_tf32 is (not old)
    assert torch.backends.cudnn.allow_tf32 is old

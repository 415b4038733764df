"""F1: a seed gives the reference's starting weights.

``init_mlp(prng.PRNGKey(s))`` against the JAX package's
``init_mlp(jax.random.PRNGKey(s))``, and the reduced zamba2
``build_model(cfg).init(s)`` against ``init_params(PRNGKey(s), cfg)``
leaf by leaf.  The normals come from the ``jax.random`` twin, within 3
ulp of JAX's (ROADMAP D5); a scale multiplies them in fp32 as the
reference does, so a scaled fp32 weight is held at one ulp more, and a
bf16 weight, rounded from those fp32 values, equal or one bf16 ulp
apart.  The fixed SSM parameters keep D3's bound (≤ 1 ulp).
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models.api import build_model as jax_build_model
from repro.models.mlp import init_mlp as jax_init_mlp
from repro_torch import prng
from repro_torch.configs import get_config
from repro_torch.models import build_model, init_mlp
from test_torch_prng_dists import NORMAL_ULPS, ulps
from torch_threads import _one_torch_thread  # noqa: F401

SCALED_ULPS = NORMAL_ULPS + 1


@pytest.mark.parametrize("seed", [0, 1, 7])
@pytest.mark.parametrize("dims", [(784, 200, 10), (32, 16, 4)])
def test_init_mlp_is_the_references(seed, dims):
    got = init_mlp(prng.PRNGKey(seed, device="cpu"), *dims, device="cpu")
    want = jax.device_get(jax_init_mlp(jax.random.PRNGKey(seed), *dims))
    for layer in ("fc1", "fc2"):
        w, b = got[layer]["w"].numpy(), got[layer]["b"].numpy()
        assert w.shape == want[layer]["w"].shape and w.dtype == np.float32
        assert ulps(w, want[layer]["w"]).max() <= SCALED_ULPS, layer
        np.testing.assert_array_equal(b, want[layer]["b"])


def _paths(tree):
    return {"/".join(str(getattr(k, "key", k)) for k in path): v
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _leaves(tree):
    return {k: np.asarray(v) for k, v in _paths(tree).items()}


def _bf16_ulps(t, w):
    """|t − w| in bf16 ulps: a torch bf16 tensor against JAX's array."""
    import torch

    def ordered(i):
        i = i.astype(np.int64)
        return np.where(i < 0, -(i & 0x7FFF), i)
    return np.abs(ordered(t.detach().view(torch.int16).numpy())
                  - ordered(w.view(np.int16))).max()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("seed", [0, 3])
def test_zamba2_init_is_the_references(dtype, seed):
    import torch
    jcfg = dataclasses.replace(jax_get_config("zamba2-2.7b").reduced(),
                               dtype=dtype)
    cfg = dataclasses.replace(get_config("zamba2-2.7b").reduced(),
                              dtype=dtype)
    want = _leaves(jax.device_get(jax_build_model(jcfg).init(
        jax.random.PRNGKey(seed))))
    got = _paths(build_model(cfg).init(seed, device="cpu"))
    assert set(got) == set(want)
    n_checked = 0
    for key, leaf in want.items():
        if key.startswith("layers/"):
            pairs = [(got[key][i], leaf[i]) for i in range(cfg.num_layers)]
        else:
            pairs = [(got[key], leaf)]
        for t, w in pairs:
            assert tuple(t.shape) == w.shape, key
            if key.endswith(("A_log", "dt_bias")):  # D3
                assert ulps(t.numpy(), w).max() <= 1, key
            elif t.dtype == torch.bfloat16:
                assert str(w.dtype) == "bfloat16", key
                assert _bf16_ulps(t, w) <= 1, key
            else:
                assert t.dtype == torch.float32 and w.dtype == np.float32
                assert ulps(t.numpy(), w).max() <= SCALED_ULPS, key
            n_checked += 1
    assert n_checked == sum(cfg.num_layers if k.startswith("layers/")
                            else 1 for k in got)

"""The paper's CIFAR-10 workload against the JAX package.

* ``make_synthetic_cifar``, ``partition_dirichlet`` (indices and
  ``PartitionStats``) and ``federated_arrays`` with the Dirichlet and
  iid schemes: bit-equal (numpy draws from the same seeds).
* ``init_cnn(PRNGKey(s))``, s ∈ {0, 1}, leaf by leaf within D5's bound
  (a scaled normal: 4 ulp).
* ``cnn_logits`` and the loss gradient at full width (32×32×3 images,
  D = 196,426) on a batch of 8, on weights carried across: logits rtol
  1e-5, gradients rtol 1e-4, each with an atol of 1e-6 of the largest
  value.
* ``configs.paper_cifar.fl_config`` field by field, and one CF-A (flat,
  compact, fused commit) and one CF-T (tree layout, compact) run of two
  rounds at N = 8, state-synced (tests/test_torch_round.py's harness):
  events and the committed set equal, and each state field within 1e-3
  of the norm of the round's update.  Not element by element: where two
  values of a 2×2 max-pool window lie within an fp32 rounding of each
  other, the two packages can route that gradient to different pixels
  (with these inputs: 17 weights of one conv1 channel move by ~5e-6 at
  the fourth SGD step of the first round, 6.8e-5 of its update norm).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import paper_cifar as jax_paper_cifar
from repro.data import federated_arrays as jax_federated_arrays
from repro.data import make_synthetic_cifar as jax_make_cifar
from repro.data.partition import partition_dirichlet as jax_dirichlet
from repro.models.mlp import cnn_logits as jax_cnn_logits
from repro.models.mlp import init_cnn as jax_init_cnn
from repro.models.mlp import make_loss_fn as jax_make_loss_fn
from repro_torch import prng
from repro_torch.configs import paper_cifar
from repro_torch.convert import nest_params, params_from_numpy
from repro_torch.data import federated_arrays, make_synthetic_cifar, \
    partition_dirichlet
from repro_torch.models import cnn_logits, init_cnn, make_loss_fn
from repro_torch.utils import make_flat_spec
from test_torch_init import SCALED_ULPS
from test_torch_prng_dists import ulps
from test_torch_round import _run_synced

N_TRAIN, N_TEST = 480, 64


@pytest.fixture(scope="module")
def datasets():
    return jax_make_cifar(N_TRAIN, N_TEST), make_synthetic_cifar(N_TRAIN,
                                                                 N_TEST)


def test_synthetic_cifar_is_bit_equal(datasets):
    jds, tds = datasets
    assert tds.x_train.shape == (N_TRAIN, 3072)
    assert tds.num_classes == jds.num_classes == 10
    for f in ("x_train", "y_train", "x_test", "y_test"):
        got, want = getattr(tds, f), getattr(jds, f)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want, err_msg=f)


def test_dirichlet_partition_is_bit_equal(datasets):
    _, tds = datasets
    kw = dict(n_clients=8, beta=0.5, seed=3)
    tx, ty, tstats = partition_dirichlet(tds.x_train, tds.y_train, **kw)
    jx, jy, jstats = jax_dirichlet(tds.x_train, tds.y_train, **kw)
    for a, b in zip(tx + ty, jx + jy, strict=True):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(tstats.sizes, jstats.sizes)
    np.testing.assert_array_equal(tstats.label_histogram,
                                  jstats.label_histogram)
    assert tstats.dropped == jstats.dropped == 0
    assert tstats.total == N_TRAIN and min(tstats.sizes) >= 8


@pytest.mark.parametrize("scheme", ["dirichlet", "iid"])
def test_federated_arrays_are_bit_equal(datasets, scheme):
    jds, tds = datasets
    jdata, jtest = jax_federated_arrays(jds, n_clients=8, scheme=scheme,
                                        beta=0.5, seed=1)
    tdata, ttest = federated_arrays(tds, n_clients=8, scheme=scheme,
                                    beta=0.5, seed=1, device="cpu")
    for got, want in ((tdata, jdata), (ttest, jtest)):
        for k in ("x", "y"):
            np.testing.assert_array_equal(got[k].numpy(),
                                          np.asarray(want[k]))


@pytest.mark.parametrize("seed", [0, 1])
def test_init_cnn_is_the_references(seed):
    got = init_cnn(prng.PRNGKey(seed, device="cpu"), device="cpu")
    want = jax.device_get(jax_init_cnn(jax.random.PRNGKey(seed)))
    assert sorted(got) == sorted(want)
    assert make_flat_spec(got).dim == 196426
    for layer in want:
        w, b = got[layer]["w"].numpy(), got[layer]["b"].numpy()
        assert w.shape == want[layer]["w"].shape and w.dtype == np.float32
        assert ulps(w, want[layer]["w"]).max() <= SCALED_ULPS, layer
        np.testing.assert_array_equal(b, want[layer]["b"])


@pytest.mark.parametrize("seed", [0, 1])
def test_cnn_logits_and_gradient_at_full_width(datasets, seed):
    """The reference's init of ``seed`` with non-zero biases (so the bias
    paths are held too), on 8 images.  Both packages sum in fp32 in
    their own orders and each lands ~4e-6 from a float64 evaluation at
    logits of ~8, so the atol of an element is 1e-6 of the largest
    logit (of the largest gradient of its leaf), not 1e-6 flat."""
    jds, _ = datasets
    jparams = jax.device_get(jax_init_cnn(jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed)
    for layer in jparams.values():
        layer["b"] = rng.normal(size=layer["b"].shape).astype(np.float32) \
            * np.float32(0.1)
    tparams = nest_params(params_from_numpy(jparams, device="cpu"))
    x, y = jds.x_train[8 * seed:8 * seed + 8], jds.y_train[8 * seed:
                                                           8 * seed + 8]
    want = np.asarray(jax_cnn_logits(jparams, jnp.asarray(x)))
    got = cnn_logits(tparams, torch.from_numpy(x)).numpy()
    assert got.shape == (8, 10)
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6 * scale)
    jgrad = jax.grad(jax_make_loss_fn(jax_cnn_logits))(
        jparams, jnp.asarray(x), jnp.asarray(y))
    tgrad = torch.func.grad(make_loss_fn(cnn_logits))(
        tparams, torch.from_numpy(x), torch.from_numpy(y))
    for layer in jgrad:
        for k in ("w", "b"):
            want_g = np.asarray(jgrad[layer][k])
            np.testing.assert_allclose(
                tgrad[layer][k].numpy(), want_g, rtol=1e-4,
                atol=1e-6 * float(np.abs(want_g).max()),
                err_msg=f"{layer}/{k}")


def test_fl_config_is_the_references():
    got, want = paper_cifar.fl_config(), jax_paper_cifar.fl_config()
    for f in dataclasses.fields(got):
        assert getattr(got, f.name) == getattr(want, f.name), f.name
    assert paper_cifar.N_CLIENTS == jax_paper_cifar.N_CLIENTS
    assert paper_cifar.TARGET_ACCURACY == jax_paper_cifar.TARGET_ACCURACY
    assert paper_cifar.DIRICHLET_BETA == jax_paper_cifar.DIRICHLET_BETA
    assert [paper_cifar.FORMS[f].layout for f in ("CF-A", "CF-T")] == \
        ["flat", "tree"]


@pytest.mark.parametrize("form", ["CF-A", "CF-T"])
def test_cifar_round_matches_jax(datasets, form):
    jds, tds = datasets
    kw = dict(paper_cifar.FORMS[form].kw, n_clients=8)
    jcfg = jax_paper_cifar.fl_config(**kw)
    tcfg = paper_cifar.fl_config(**kw)
    jdata, _ = jax_federated_arrays(jds, n_clients=8, scheme="dirichlet",
                                    beta=0.5)
    tdata, _ = federated_arrays(tds, n_clients=8, scheme="dirichlet",
                                beta=0.5, device="cpu")
    jparams = jax.device_get(jax_init_cnn(jax.random.PRNGKey(0)))
    seen = _run_synced(
        jcfg, tcfg, jax_make_loss_fn(jax_cnn_logits),
        make_loss_fn(cnn_logits), jdata, tdata, jparams,
        nest_params(params_from_numpy(jparams, device="cpu")), rounds=2,
        layout=paper_cifar.FORMS[form].layout, update_tol=1e-3)
    assert seen["flipped_rounds"] == 0
    assert seen["events"] > 0

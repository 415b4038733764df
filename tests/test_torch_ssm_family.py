"""The SSM-bearing families of the port against the JAX package's, on
the CPU: the hybrid (zamba2-2.7b) and ssm (mamba2-2.7b) training losses
and their gradients, the differentiable SSD, the ssm family's init,
serving and cross-pod round, the prefill's SSD precision, the training
launcher on mamba2, and the last two dense configs (phi3-medium-14b,
deepseek-67b).

Everything runs on ``.reduced()`` configs in fp32 (zamba2: 4 mamba
layers in 2 groups of 2 and the shared block, d_model 128; mamba2: 2
layers; ssm_state 16, 8 heads of 16, chunk 8), with weights carried
across from the JAX package's init (``convert.lm_params_from_numpy``)
and inputs made with numpy from a seed.  The JAX side runs as the JAX
package runs it on the CPU (its training SSD is a ``lax.scan``, its
gradients ``jax.value_and_grad``); the port's side runs the plain paths
(CPU tensors), gradients by autograd.

Tolerances, those of tests/test_torch_dense.py:
* losses and logits at rtol/atol 2e-5 (fp32, sums in another order);
  gradients at rtol 1e-4 / atol 1e-6 (the same through a backward pass);
* the init within D5's ulps (D3's one ulp for A_log and dt_bias);
* cross-pod rounds at the grades of tests/test_torch_crosspod.py
  (events equal, δ within one ulp of its operands, state at the solve
  grade).
"""
import dataclasses
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.core.controller import ControllerConfig as JaxControllerConfig
from repro.core.crosspod import CrossPodConfig as JaxCrossPodConfig
from repro.core.crosspod import init_cross_pod_state as jax_init_state
from repro.core.crosspod import make_cross_pod_round as jax_make_round
from repro.models import ssm as jssm
from repro.models.api import build_model as jax_build_model
from repro.models.api import param_count as jax_param_count
from repro_torch.configs import get_config
from repro_torch.convert import cross_pod_state_from_numpy, \
    cross_pod_state_to_numpy, lm_cache_from_numpy, lm_params_from_numpy
from repro_torch.core.controller import ControllerConfig
from repro_torch.core.crosspod import CrossPodConfig, make_cross_pod_round
from repro_torch.kernels import ops
from repro_torch.kernels.ssd_scan import ssd_scan_ref
from repro_torch.models import abstract_cache, abstract_params, \
    build_model, param_count
from repro_torch.models import ssm
from repro_torch.models.transformer import init_params
from repro_torch.utils.pytree import tree_leaves, tree_map
from test_torch_crosspod import STATE_TOL, _within_ulp
from test_torch_init import SCALED_ULPS
from test_torch_prng_dists import ulps
from torch_threads import _one_torch_thread  # noqa: F401

TOL = dict(rtol=2e-5, atol=2e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)
HYBRID, SSM = "zamba2-2.7b", "mamba2-2.7b"
DENSE = ("phi3-medium-14b", "deepseek-67b")
NEW_CONFIGS = (SSM,) + DENSE


def _np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


def _t(a, requires_grad=False):
    return torch.from_numpy(np.array(a)).requires_grad_(requires_grad)


def _jleaves(tree):
    return [np.asarray(x) for x in jax.tree.leaves(tree)]


@pytest.fixture(autouse=True)
def _counts_stay_zero():
    ops.reset_launch_counts()
    yield
    assert ops.launch_counts() == {k: 0 for k in ops.KERNELS}, \
        "a CPU tensor must never reach a kernel launch"


def _setup(arch, **overrides):
    """Both packages' reduced config, the JAX model and its seed-0
    weights, and the port's model on those weights."""
    jcfg = jax_get_config(arch).reduced(**overrides)
    cfg = get_config(arch).reduced(**overrides)
    jmodel, model = jax_build_model(jcfg), build_model(cfg)
    jparams = jax.jit(jmodel.init)(jax.random.PRNGKey(0))
    params = lm_params_from_numpy(jax.device_get(jparams), cfg,
                                  device="cpu")
    return jcfg, cfg, jmodel, model, jparams, params


@pytest.fixture(scope="module")
def setups():
    return {arch: _setup(arch) for arch in (HYBRID, SSM)}


def _batch(cfg, b, s, seed):
    toks = np.random.default_rng(seed).integers(0, cfg.vocab_size,
                                                (b, s + 1))
    return toks[:, :-1], toks[:, 1:]


# ----------------------------------------------------------------------
# configuration, sizes and init
# ----------------------------------------------------------------------


@pytest.mark.parametrize("reduced", [False, True])
@pytest.mark.parametrize("arch", NEW_CONFIGS)
def test_config_is_the_jax_packages(arch, reduced):
    got, want = get_config(arch), jax_get_config(arch)
    if reduced:
        got, want = got.reduced(), want.reduced()
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.vocab_padded == want.vocab_padded
    assert get_config(arch.replace("-", "_").replace(".", "_")) == \
        get_config(arch)


# The reference's parameter counts at full size (``param_count``).
FULL_PARAMS = {SSM: 2_832_074_240, "phi3-medium-14b": 14_659_507_200,
               "deepseek-67b": 67_425_001_472}


@pytest.mark.parametrize("arch", NEW_CONFIGS)
def test_param_count_and_abstract_shapes_match_the_jax_package(arch):
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    assert param_count(cfg) == jax_param_count(jcfg) == FULL_PARAMS[arch]
    shapes = jax.tree.leaves(jax.eval_shape(
        jax_build_model(jcfg).init, jax.random.PRNGKey(0)))
    got = tree_leaves(abstract_params(build_model(cfg)))
    assert [tuple(t.shape) for t in got] == [s.shape for s in shapes]
    assert [t.dtype for t in got] == [torch.bfloat16 if str(s.dtype) ==
                                      "bfloat16" else torch.float32
                                      for s in shapes]
    assert all(t.device.type == "meta" for t in got)


def test_ssm_abstract_cache_has_no_kv():
    from repro.models import transformer as jtf

    cfg = get_config(SSM)
    cache = abstract_cache(build_model(cfg), 4, 64)
    want = jax.eval_shape(lambda: jtf.init_cache(jax_get_config(SSM), 4,
                                                 64))
    assert set(cache) == set(want) == {"layers", "pos"}
    for k in ("ssm", "conv"):
        assert tuple(cache["layers"][k].shape) == want["layers"][k].shape
    assert tuple(cache["layers"]["ssm"].shape) == (64, 4, 80, 64, 128)
    assert cache["layers"]["ssm"].dtype == torch.float32


@pytest.mark.parametrize("seed", [0, 5])
def test_ssm_init_is_the_references(seed):
    cfg, jcfg = get_config(SSM).reduced(), jax_get_config(SSM).reduced()
    got = init_params(cfg, seed, device="cpu")
    want = jax.device_get(jax_build_model(jcfg).init(
        jax.random.PRNGKey(seed)))
    assert "shared" not in got and set(got) == set(want)
    paths = jax.tree_util.tree_flatten_with_path(want)[0]
    assert len(paths) == len(tree_leaves(got))
    for (path, w), g in zip(paths, tree_leaves(got), strict=True):
        g, w, key = g.numpy(), np.asarray(w), jax.tree_util.keystr(path)
        assert g.shape == w.shape and g.dtype == w.dtype, key
        if key.endswith(("'A_log']", "'dt_bias']")):  # D3
            assert ulps(g, w).max() <= 1, key
        elif re.search(r"'(ln|norm_g|final_ln|D|conv_b)'\]$", key):
            np.testing.assert_array_equal(g, w, err_msg=key)
        else:
            assert ulps(g, w).max() <= SCALED_ULPS, key


# ----------------------------------------------------------------------
# the differentiable SSD and the training losses
# ----------------------------------------------------------------------


@pytest.mark.parametrize("s", [24, 21])
def test_ssd_chunked_grads_through_the_plain_scan(s):
    """``ssd_chunked(scan=ssd_scan_ref)`` and its gradients against the
    reference's (a ``lax.scan``), at a chunk multiple and a ragged S."""
    rng = np.random.default_rng(s)
    b, h, p, n, q = 2, 3, 4, 5, 8
    x = rng.normal(size=(b, s, h, p)).astype(np.float32)
    dt = rng.uniform(0.01, 0.5, size=(b, s, h)).astype(np.float32)
    a_log = rng.normal(size=(h,)).astype(np.float32)
    bm, cm = (rng.normal(size=(b, s, n)).astype(np.float32)
              for _ in range(2))
    cy = rng.normal(size=(b, s, h, p)).astype(np.float32)
    ch = rng.normal(size=(b, h, p, n)).astype(np.float32)

    def jf(*args):
        y, hl = jssm.ssd_chunked(*args, chunk=q)
        return jnp.sum(y * cy) + jnp.sum(hl * ch)

    want, jgrads = jax.value_and_grad(jf, argnums=tuple(range(5)))(
        *(jnp.asarray(a) for a in (x, dt, a_log, bm, cm)))
    args = [_t(a, True) for a in (x, dt, a_log, bm, cm)]
    y, hl = ssm.ssd_chunked(*args, chunk=q, scan=ssd_scan_ref)
    got = torch.sum(y * _t(cy)) + torch.sum(hl * _t(ch))
    grads = torch.autograd.grad(got, args)
    np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)
    for g, w in zip(grads, jgrads, strict=True):
        np.testing.assert_allclose(_np(g), np.asarray(w), **GRAD_TOL)
    # K5's wrapper refuses the same inputs: it has no backward.
    with pytest.raises(ValueError, match="no backward"):
        ssm.ssd_chunked(*args, chunk=q)


LOSS_KW = dict(loss_chunk=8)


@pytest.fixture(scope="module")
def loss_refs(setups):
    """Per family: a batch of 2 × 20 tokens and the reference's loss and
    gradients on it (jitted, remat off: remat recomputes the same
    values, so one reference serves every remat setting)."""
    out = {}
    for arch, (jcfg, cfg, _, _, jparams, _) in setups.items():
        tok, lab = _batch(cfg, 2, 20, seed=7)
        jb = {"tokens": jnp.asarray(tok, jnp.int32),
              "labels": jnp.asarray(lab, jnp.int32)}
        jmodel = jax_build_model(dataclasses.replace(jcfg, remat=False,
                                                     **LOSS_KW))
        want, jgrads = jax.jit(jax.value_and_grad(jmodel.loss))(jparams, jb)
        out[arch] = (tok, lab, np.asarray(want), jax.device_get(jgrads))
    return out


@pytest.mark.parametrize("arch,remat,remat_group", [
    (HYBRID, False, 1), (HYBRID, True, 1), (SSM, False, 1),
    (SSM, True, 1), (SSM, True, 2)])
def test_loss_and_grads_match_jax(setups, loss_refs, arch, remat,
                                  remat_group):
    _, cfg, _, _, _, params = setups[arch]
    cfg = dataclasses.replace(cfg, remat=remat, remat_group=remat_group,
                              **LOSS_KW)
    tok, lab, want, jgrads = loss_refs[arch]
    tparams = tree_map(lambda x: x.clone().requires_grad_(True), params)
    got = build_model(cfg).loss(tparams, {"tokens": torch.from_numpy(tok),
                                          "labels": torch.from_numpy(lab)})
    grads = torch.autograd.grad(got, tree_leaves(tparams))
    np.testing.assert_allclose(_np(got), want, **TOL)
    paths = jax.tree_util.tree_flatten_with_path(jgrads)[0]
    for g, (path, w) in zip(grads, paths, strict=True):
        np.testing.assert_allclose(_np(g), np.asarray(w),
                                   err_msg=jax.tree_util.keystr(path),
                                   **GRAD_TOL)
    if arch == HYBRID:
        # The shared block runs once per group (2 groups), and autograd
        # adds its gradients over them (held above with the rest).
        assert cfg.num_layers // cfg.attn_every == 2
        shared = {id(x) for x in tree_leaves(tparams["shared"])}
        assert len(shared) == 9 and all(
            bool(g.any()) for g, x in zip(grads, tree_leaves(tparams),
                                          strict=True) if id(x) in shared)


# ----------------------------------------------------------------------
# the prefill's SSD precision (the port's prefill, as the reference's,
# ignores ``ssd_intra_dtype``; the training loss honours it)
# ----------------------------------------------------------------------


@pytest.mark.parametrize("arch", [SSM, HYBRID])
def test_prefill_ignores_ssd_intra_dtype_and_training_honours_it(arch):
    jcfg = jax_get_config(arch).reduced(dtype="bfloat16")
    cfg = get_config(arch).reduced(dtype="bfloat16")
    forced = dict(ssd_intra_dtype="float32_forced")
    params = build_model(cfg).init(0, device="cpu")
    tok, lab = _batch(cfg, 2, 20, seed=3)
    got = {}
    for name, c in (("default", cfg), ("forced", dataclasses.replace(
            cfg, **forced))):
        model = build_model(c)
        logits, cache = model.prefill(params, {"tokens":
                                               torch.from_numpy(tok)})
        got[name] = (logits, cache["layers"]["ssm"],
                     model.loss(params, {"tokens": torch.from_numpy(tok),
                                         "labels": torch.from_numpy(lab)}))
    # The port's prefill: bit-equal whatever the setting.
    assert torch.equal(got["default"][0], got["forced"][0])
    assert torch.equal(got["default"][1], got["forced"][1])
    # The training loss: the setting changes its arithmetic.
    assert float(got["default"][2]) != float(got["forced"][2])
    # The reference's prefill is invariant too.
    jparams = jax.jit(jax_build_model(jcfg).init)(jax.random.PRNGKey(0))
    jgot = [jax.jit(jax_build_model(c).prefill)(
        jparams, {"tokens": jnp.asarray(tok, jnp.int32)})[0]
        for c in (jcfg, dataclasses.replace(jcfg, **forced))]
    np.testing.assert_array_equal(np.asarray(jgot[0]), np.asarray(jgot[1]))


# ----------------------------------------------------------------------
# the ssm family served
# ----------------------------------------------------------------------


@pytest.mark.parametrize("s,max_seq", [(16, 24), (21, 28)])
def test_ssm_prefill_and_decode_match_jax(setups, s, max_seq):
    _, cfg, jmodel, model, jparams, params = setups[SSM]
    tok, _ = _batch(cfg, 2, s, seed=s)
    want, jcache = jax.jit(lambda p, b: jmodel.prefill(p, b, max_seq))(
        jparams, {"tokens": jnp.asarray(tok, jnp.int32)})
    got, cache = model.prefill(params, {"tokens": torch.from_numpy(tok)},
                               max_seq)
    assert set(cache) == {"layers", "pos"}
    np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)
    for k in ("ssm", "conv"):
        np.testing.assert_allclose(_np(cache["layers"][k]),
                                   np.asarray(jcache["layers"][k]), **TOL)
    assert cache["pos"] == int(jcache["pos"]) == s
    step = jax.jit(jmodel.decode_step)
    for i in range(3):  # state-synced: each step from the JAX cache
        token = np.full((2, 1), (7 * i + 2) % cfg.vocab_size)
        want, jnext = step(jparams, jnp.asarray(token, jnp.int32), jcache)
        got, new = model.decode_step(
            params, torch.from_numpy(token),
            lm_cache_from_numpy(jax.device_get(jcache), device="cpu"))
        np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)
        for k in ("ssm", "conv"):
            np.testing.assert_allclose(_np(new["layers"][k]),
                                       np.asarray(jnext["layers"][k]),
                                       **TOL)
        assert new["pos"] == s + i + 1
        jcache = jnext


def test_ssm_init_cache_is_the_references():
    from repro.models import transformer as jtf

    cfg = get_config(SSM).reduced()
    got = build_model(cfg).init_cache(3, 16, device="cpu")
    want = jtf.init_cache(jax_get_config(SSM).reduced(), 3, 16)
    assert set(got) == set(want) == {"layers", "pos"} and got["pos"] == 0
    for k in ("ssm", "conv"):
        assert tuple(got["layers"][k].shape) == want["layers"][k].shape
        assert not got["layers"][k].any()


# ----------------------------------------------------------------------
# the cross-pod round on both families
# ----------------------------------------------------------------------

CP = dict(rho=1e-3, lr=5e-3, local_steps=2)
CTRL = dict(K=0.05, alpha=0.9, target_rate=0.5)


@pytest.mark.parametrize("arch", [HYBRID, SSM])
def test_cross_pod_rounds_match_jax_state_synced(setups, arch):
    """Two rounds at P = 2 from the reference's seed-0 state (the first
    fires both pods, the second is decided by the controller), each from
    the reference's state before it, on 2 × 16 tokens a step."""
    jcfg, cfg = jax_get_config(arch).reduced(), get_config(arch).reduced()
    jcp = JaxCrossPodConfig(n_pods=2, controller=JaxControllerConfig(**CTRL),
                            **CP)
    cp = CrossPodConfig(n_pods=2, controller=ControllerConfig(**CTRL), **CP)
    jmodel = jax_build_model(jcfg)
    jround = jax.jit(jax_make_round(jcp, jmodel.loss))
    jstate = jax_init_state(jcp, setups[arch][4])  # the seed-0 weights
    round_fn = make_cross_pod_round(cp, build_model(cfg).loss)
    rng = np.random.default_rng(0)
    for r in range(2):
        toks = rng.integers(0, cfg.vocab_size, (2, CP["local_steps"], 2, 17))
        before = jax.device_get(jstate)
        jstate, wm = jround(jstate, {
            "tokens": jnp.asarray(toks[..., :-1], jnp.int32),
            "labels": jnp.asarray(toks[..., 1:], jnp.int32)})
        want, wm = jax.device_get(jstate), jax.device_get(wm)
        new, m = round_fn(cross_pod_state_from_numpy(before, device="cpu"),
                          {"tokens": torch.from_numpy(toks[..., :-1]),
                           "labels": torch.from_numpy(toks[..., 1:])})
        got, msg = cross_pod_state_to_numpy(new), f"{arch} round {r}"
        np.testing.assert_allclose(m.distances.numpy(), wm.distances,
                                   rtol=1e-5, atol=1e-7, err_msg=msg)
        np.testing.assert_array_equal(m.events.numpy(), wm.events,
                                      err_msg=msg)
        _within_ulp(got.ctrl.delta, want.ctrl.delta, before.ctrl.delta)
        for f in ("theta", "lam", "z_prev"):
            for g, w in zip(tree_leaves(getattr(got, f)),
                            jax.tree.leaves(getattr(want, f)), strict=True):
                np.testing.assert_allclose(g, np.asarray(w), err_msg=msg,
                                           **STATE_TOL)
        np.testing.assert_allclose(float(m.train_loss),
                                   float(wm.train_loss), rtol=1e-5,
                                   err_msg=msg)
        np.testing.assert_array_equal(got.rng, np.asarray(want.rng))
    assert int(got.round) == 2


def test_train_launcher_runs_mamba2_reduced(capsys):
    from repro_torch.launch import train

    train.main(["--engine", "crosspod", "--arch", SSM, "--reduced",
                "--rounds", "1", "--batch", "2", "--seq", "16",
                "--device", "cpu"])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == "mesh: {'pod': 2, 'device': 'cpu'}"
    assert len(lines) == 2 and re.fullmatch(
        r"round +0 events=\[1 1\] cum=2 loss=\d+\.\d{4}", lines[1])


# ----------------------------------------------------------------------
# the last two dense configs
# ----------------------------------------------------------------------


@pytest.mark.parametrize("arch", DENSE)
def test_dense_config_loss_and_prefill_match_jax(arch):
    jcfg, cfg, jmodel, model, jparams, params = _setup(arch)
    tok, lab = _batch(cfg, 2, 12, seed=1)
    want = jax.jit(jmodel.loss)(jparams, {
        "tokens": jnp.asarray(tok, jnp.int32),
        "labels": jnp.asarray(lab, jnp.int32)})
    got = model.loss(params, {"tokens": torch.from_numpy(tok),
                              "labels": torch.from_numpy(lab)})
    np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)
    want, jcache = jax.jit(lambda p, b: jmodel.prefill(p, b, 16))(
        jparams, {"tokens": jnp.asarray(tok, jnp.int32)})
    got, cache = model.prefill(params, {"tokens": torch.from_numpy(tok)}, 16)
    np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)
    for k in ("k", "v"):
        np.testing.assert_allclose(_np(cache[k]), np.asarray(jcache[k]),
                                   **TOL)


def test_bf16_cross_pod_round_matches_jax():
    """ROADMAP D10 (D4 on a training path): one bf16 cross-pod round of
    reduced mamba2 from the reference's bf16 init, state-synced.  The
    port's bf16 einsums in ``ssd_chunked`` round to bf16 where XLA keeps
    fp32, on top of the bf16 arithmetic that tests/test_torch_crosspod.py
    grades on granite; so the events are equal and each leaf's update
    within that file's 25% of the reference's in norm, the loss at rtol
    1e-3."""
    from test_torch_crosspod import BF16_UPDATE_RTOL, _update_error

    jcfg = jax_get_config(SSM).reduced(dtype="bfloat16")
    cfg = get_config(SSM).reduced(dtype="bfloat16")
    jcp = JaxCrossPodConfig(n_pods=2, controller=JaxControllerConfig(**CTRL),
                            **CP)
    cp = CrossPodConfig(n_pods=2, controller=ControllerConfig(**CTRL), **CP)
    jmodel = jax_build_model(jcfg)
    before = jax_init_state(jcp, jax.jit(jmodel.init)(jax.random.PRNGKey(0)))
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size,
                                             (2, CP["local_steps"], 2, 17))
    jstate, wm = jax.jit(jax_make_round(jcp, jmodel.loss))(before, {
        "tokens": jnp.asarray(toks[..., :-1], jnp.int32),
        "labels": jnp.asarray(toks[..., 1:], jnp.int32)})
    before, want = jax.device_get(before), jax.device_get(jstate)
    state = cross_pod_state_from_numpy(before, device="cpu")
    assert tree_leaves(state.theta)[0].dtype == torch.bfloat16
    new, m = make_cross_pod_round(cp, build_model(cfg).loss)(
        state, {"tokens": torch.from_numpy(toks[..., :-1]),
                "labels": torch.from_numpy(toks[..., 1:])})
    assert np.asarray(wm.events).all()
    np.testing.assert_array_equal(m.events.numpy(), wm.events)
    got = cross_pod_state_to_numpy(new)
    for f in ("theta", "lam", "z_prev"):
        for g, w, b in zip(tree_leaves(getattr(got, f)),
                           jax.tree.leaves(getattr(want, f)),
                           jax.tree.leaves(getattr(before, f)), strict=True):
            assert _update_error(b, g, w) <= BF16_UPDATE_RTOL, f
    np.testing.assert_allclose(float(m.train_loss), float(wm.train_loss),
                               rtol=1e-3)

"""The dense family (granite-3-2b) of the port against the JAX package's,
on the CPU: the seeded init, the LM loss pieces, the blockwise
attention, the training loss and its gradients, serving, AdamW and the
schedules, the train step.

Everything runs on ``granite-3-2b`` ``.reduced()`` (2 layers, d_model
128, 4 heads of 32 with 2 kv heads, d_ff 256, vocab 512, kv_block 8) in
fp32, with weights carried across from the JAX package's init
(``convert.lm_params_from_numpy``) and inputs made with numpy from a
seed.  The JAX side runs as the JAX package runs it on the CPU (its
attention through ``blockwise_attention``, gradients by
``jax.value_and_grad``); the port's side runs the plain paths (CPU
tensors), gradients by autograd.

Tolerances:
* the init: the port's draws are the ``jax.random`` twin's, within 3
  ulp of JAX's normals and one more for the scale (ROADMAP D5, the
  zamba2 grade of tests/test_torch_init.py); the norms' ones equal;
* losses, logits and attention outputs at rtol/atol 2e-5 (fp32, sums in
  another order); gradients at rtol 1e-4 / atol 1e-6 (the same, through
  a backward pass);
* AdamW bit-equal over 3 steps (with the correctly rounded sqrt);
* the schedules within 4 ulp (``cos`` is within an ulp on either side,
  and 0.5·(1 + cos) scales its error up).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro.models.api import build_model as jax_build_model
from repro.models.api import input_specs as jax_input_specs
from repro.models.api import param_count as jax_param_count
from repro.optim import adam as jadam
from repro.optim import schedules as jsched
from repro_torch.configs import get_config
from repro_torch.convert import lm_cache_from_numpy, lm_params_from_numpy
from repro_torch.kernels import ops
from repro_torch.models import abstract_cache, abstract_params, \
    build_model, input_specs, param_count
from repro_torch.models import attention, layers
from repro_torch.models.transformer import init_params
from repro_torch.optim import adam_init, adam_step, constant, cosine_decay, \
    warmup_cosine
from repro_torch.utils.pytree import tree_leaves, tree_map
from test_torch_init import SCALED_ULPS
from test_torch_prng_dists import ulps
from torch_threads import _one_torch_thread  # noqa: F401

TOL = dict(rtol=2e-5, atol=2e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)
ARCH = "granite-3-2b"


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


@pytest.fixture(scope="module")
def setup():
    """The reduced config of both packages, the JAX model and its seed-0
    weights, and the port's model on those weights."""
    jcfg, cfg = jax_get_config(ARCH).reduced(), get_config(ARCH).reduced()
    jmodel, model = jax_build_model(jcfg), build_model(cfg)
    jparams = jax.jit(jmodel.init)(jax.random.PRNGKey(0))
    params = lm_params_from_numpy(jax.device_get(jparams), cfg,
                                  device="cpu")
    return jcfg, cfg, jmodel, model, jparams, params


def _batch(cfg, b, s, seed):
    toks = np.random.default_rng(seed).integers(0, cfg.vocab_size,
                                                (b, s + 1))
    return toks[:, :-1], toks[:, 1:]


# ----------------------------------------------------------------------
# configuration and init
# ----------------------------------------------------------------------


@pytest.mark.parametrize("reduced", [False, True])
def test_config_is_the_jax_packages(reduced):
    got, want = get_config(ARCH), jax_get_config(ARCH)
    if reduced:
        got, want = got.reduced(), want.reduced()
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.vocab_padded == want.vocab_padded
    assert get_config("granite_3_2b") == get_config(ARCH)
    if not reduced:
        assert got.vocab_padded == 49408 and got.loss_chunk == 1024


def test_param_count_and_abstract_shapes_match_the_jax_package():
    cfg, jcfg = get_config(ARCH), jax_get_config(ARCH)
    assert param_count(cfg) == jax_param_count(jcfg)
    model = build_model(cfg)
    shapes = jax.tree.leaves(jax.eval_shape(
        jax_build_model(jcfg).init, jax.random.PRNGKey(0)))
    got = tree_leaves(abstract_params(model))
    assert [tuple(t.shape) for t in got] == [s.shape for s in shapes]
    assert all(t.device.type == "meta" for t in got)
    cache = abstract_cache(model, 4, 64)
    assert tuple(cache["k"].shape) == (40, 4, 64, 8, 64)
    for mode in ("train", "prefill", "decode"):
        want = jax_input_specs(jcfg, mode=mode, batch=4, seq=64)
        spec = input_specs(cfg, mode=mode, batch=4, seq=64)
        assert {k: tuple(v.shape) for k, v in spec.items()} == \
            {k: v.shape for k, v in want.items()}


@pytest.mark.parametrize("seed", [0, 5])
def test_init_is_the_references(seed):
    cfg, jcfg = get_config(ARCH).reduced(), jax_get_config(ARCH).reduced()
    got = init_params(cfg, seed, device="cpu")
    want = jax.device_get(jax_build_model(jcfg).init(
        jax.random.PRNGKey(seed)))
    paths = jax.tree_util.tree_flatten_with_path(want)[0]
    assert len(paths) == len(tree_leaves(got))
    for (path, w), g in zip(paths, tree_leaves(got), strict=True):
        g, w, key = g.numpy(), np.asarray(w), jax.tree_util.keystr(path)
        assert g.shape == w.shape and g.dtype == w.dtype, key
        if "ln" in key:
            np.testing.assert_array_equal(g, w, err_msg=key)
        else:
            assert ulps(g, w).max() <= SCALED_ULPS, key


def test_converted_params_round_trip(setup):
    _, cfg, _, _, jparams, params = setup
    assert tree_leaves(params["layers"])[0].shape[0] == cfg.num_layers
    want = _jleaves(jparams)
    got = [_np(x) for x in tree_leaves(params)]
    for g, w in zip(got, want, strict=True):
        np.testing.assert_array_equal(g, w)


# ----------------------------------------------------------------------
# the loss pieces
# ----------------------------------------------------------------------


@pytest.mark.parametrize("chunk,s", [(0, 24), (8, 24), (10, 24), (32, 24)])
def test_chunked_lm_loss_and_grads(chunk, s):
    rng = np.random.default_rng(chunk)
    b, d, v, valid = 3, 16, 64, 50
    h = rng.normal(size=(b, s, d)).astype(np.float32)
    w = (rng.normal(size=(d, v)) * 0.3).astype(np.float32)
    y = rng.integers(0, valid, (b, s)).astype(np.int32)
    y[0, :5] = -100  # ignored positions
    want, (jgh, jgw) = jax.jit(jax.value_and_grad(
        lambda h, w: jlayers.chunked_lm_loss(h, w, jnp.asarray(y), chunk,
                                             valid_vocab=valid),
        argnums=(0, 1)))(jnp.asarray(h), jnp.asarray(w))
    th, tw = _t(h, True), _t(w, True)
    got = layers.chunked_lm_loss(th, tw, _t(y).long(), chunk,
                                 valid_vocab=valid)
    gh, gw = torch.autograd.grad(got, (th, tw))
    np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)
    np.testing.assert_allclose(_np(gh), np.asarray(jgh), **GRAD_TOL)
    np.testing.assert_allclose(_np(gw), np.asarray(jgw), **GRAD_TOL)
    # The padded columns take no probability: their gradient is 0.
    assert not _np(gw)[:, valid:].any()


def test_cross_entropy_logits_masks_and_ignores():
    rng = np.random.default_rng(1)
    logits = rng.normal(size=(2, 7, 20)).astype(np.float32)
    y = rng.integers(0, 15, (2, 7)).astype(np.int32)
    y[1, 3] = -100
    for valid in (0, 15):
        want = jlayers.cross_entropy_logits(jnp.asarray(logits),
                                            jnp.asarray(y),
                                            valid_vocab=valid)
        got = layers.cross_entropy_logits(_t(logits), _t(y).long(),
                                          valid_vocab=valid)
        np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)
    all_ignored = layers.cross_entropy_logits(
        _t(logits), torch.full((2, 7), -100))
    assert float(all_ignored) == 0.0


@pytest.mark.parametrize("mask_mode,window,prefix_len,kv_block", [
    ("causal", 0, 0, 8), ("causal", 0, 0, 5), ("causal", 6, 0, 8),
    ("prefix", 0, 4, 8), ("bidir", 0, 0, 8)])
def test_blockwise_attention_and_grads(mask_mode, window, prefix_len,
                                       kv_block):
    rng = np.random.default_rng(3)
    b, s, h, kvh, hd = 2, 21, 4, 2, 16
    q, k, v = (rng.normal(size=(b, s, n, hd)).astype(np.float32)
               for n in (h, kvh, kvh))
    pos = np.arange(s)
    kw = dict(mask_mode=mask_mode, window=window, prefix_len=prefix_len,
              kv_block=kv_block)
    cot = rng.normal(size=(b, s, h, hd)).astype(np.float32)

    def jf(q, k, v):
        out = jattn.blockwise_attention(
            q, k, v, q_positions=jnp.asarray(pos),
            kv_positions=jnp.asarray(pos), **kw)
        return jnp.sum(out * cot), out

    (_, want), jgrads = jax.jit(jax.value_and_grad(
        jf, argnums=(0, 1, 2), has_aux=True))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv = (_t(x, True) for x in (q, k, v))
    got = attention.blockwise_attention(
        tq, tk, tv, q_positions=torch.from_numpy(pos),
        kv_positions=torch.from_numpy(pos), **kw)
    grads = torch.autograd.grad(torch.sum(got * _t(cot)), (tq, tk, tv))
    np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)
    for g, w in zip(grads, jgrads, strict=True):
        np.testing.assert_allclose(_np(g), np.asarray(w), **GRAD_TOL)
    if mask_mode == "causal" and not window:
        # The plain one-pass version K4 is held to gives the same values.
        ref = ops.flash_attention_ref(tq.detach(), tk.detach(), tv.detach(),
                                      layout="bshd")
        np.testing.assert_allclose(_np(got), _np(ref), **TOL)


def test_flash_attention_refuses_inputs_that_require_grad():
    q = torch.zeros((1, 8, 2, 16), requires_grad=True)
    k = v = torch.zeros((1, 8, 2, 16))
    with pytest.raises(ValueError, match="no backward"):
        ops.flash_attention(q, k, v, layout="bshd")


# ----------------------------------------------------------------------
# the training loss
# ----------------------------------------------------------------------


@pytest.fixture(scope="module")
def loss_refs(setup):
    """The reference's loss and gradients on 3 × 20 tokens, jitted, per
    ``loss_chunk`` (remat off: remat recomputes the same values, so one
    reference serves both remat settings)."""
    jcfg, cfg, _, _, jparams, _ = setup
    tok, lab = _batch(cfg, 3, 20, seed=7)
    jb = {"tokens": jnp.asarray(tok, jnp.int32),
          "labels": jnp.asarray(lab, jnp.int32)}
    out = {}
    for chunk in (0, 8):
        jmodel = jax_build_model(dataclasses.replace(jcfg, remat=False,
                                                     loss_chunk=chunk))
        want, jgrads = jax.jit(jax.value_and_grad(jmodel.loss))(jparams, jb)
        out[chunk] = (np.asarray(want), _jleaves(jgrads))
    return tok, lab, out


@pytest.mark.parametrize("remat,loss_chunk", [(False, 0), (True, 8),
                                              (True, 0)])
def test_loss_and_grads_match_jax(setup, loss_refs, remat, loss_chunk):
    _, cfg, _, _, _, params = setup
    cfg = dataclasses.replace(cfg, remat=remat, loss_chunk=loss_chunk)
    tok, lab, refs = loss_refs
    want, jgrads = refs[loss_chunk]
    tparams = tree_map(lambda x: x.clone().requires_grad_(True), params)
    got = build_model(cfg).loss(tparams, {"tokens": torch.from_numpy(tok),
                                          "labels": torch.from_numpy(lab)})
    grads = torch.autograd.grad(got, tree_leaves(tparams))
    np.testing.assert_allclose(_np(got), want, **TOL)
    for g, w in zip(grads, jgrads, strict=True):
        np.testing.assert_allclose(_np(g), w, **GRAD_TOL)
    # The parameter module gives the same loss as its stacked dict.
    same = build_model(cfg).loss(params, {"tokens": torch.from_numpy(tok),
                                          "labels": torch.from_numpy(lab)})
    assert float(same) == float(got.detach())


@pytest.mark.parametrize("family", ["moe", "vlm", "audio"])
def test_unported_families_are_refused(family):
    """The three families ported last build (``check_family`` passes),
    and what the port still refuses raises ``ValueError``: an unknown
    family or attention mask, a decode past the end of a vlm cache sized
    without its prefix (ROADMAP D11), and serving the audio encoder."""
    from repro_torch.models.attention import check_mask_mode
    from repro_torch.models.transformer import check_family

    extra = {"moe": dict(num_experts=4, top_k=2),
             "vlm": dict(prefix_tokens=4, frontend_dim=32),
             "audio": dict(frontend_dim=32, encoder_only=True)}[family]
    cfg = dataclasses.replace(get_config(ARCH).reduced(), family=family,
                              **extra)
    check_family(cfg)
    model = build_model(cfg)
    with pytest.raises(ValueError, match="unknown family"):
        check_family(dataclasses.replace(cfg, family=family + "-x"))
    with pytest.raises(ValueError, match="mask_mode"):
        check_mask_mode(family)
    if family == "moe":
        assert set(abstract_params(model)["layers"]["moe"]) == {
            "router", "w_gate", "w_up", "w_down"}
        return
    params = model.init(0, device="cpu")
    if family == "audio":
        with pytest.raises(ValueError, match="encoder-only"):
            model.prefill(params, {"tokens": torch.zeros((1, 4),
                                                         dtype=torch.int64)})
        with pytest.raises(ValueError, match="no cache"):
            model.init_cache(1, 8, device="cpu")
        return
    batch = {"tokens": torch.zeros((1, 5), dtype=torch.int64),
             "patches": torch.zeros((1, 4, 32))}
    _, cache = model.prefill(params, batch)  # max_seq: the text's 5
    assert cache["k"].shape[2] == cache["pos"] == 9
    with pytest.raises(ValueError, match="prefix"):
        model.decode_step(params, torch.zeros((1, 1), dtype=torch.int64),
                          cache)


# ----------------------------------------------------------------------
# serving
# ----------------------------------------------------------------------


@pytest.mark.parametrize("s,max_seq", [(12, 16), (21, 24)])
def test_prefill_and_decode_match_jax(setup, s, max_seq):
    _, cfg, jmodel, model, jparams, params = setup
    tok, _ = _batch(cfg, 2, s, seed=s)
    want, jcache = jax.jit(lambda p, b: jmodel.prefill(p, b, max_seq))(
        jparams, {"tokens": jnp.asarray(tok, jnp.int32)})
    got, cache = model.prefill(params, {"tokens": torch.from_numpy(tok)},
                               max_seq)
    np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)
    for key in ("k", "v"):
        np.testing.assert_allclose(_np(cache[key]), np.asarray(jcache[key]),
                                   **TOL)
    assert cache["pos"] == int(jcache["pos"]) == s
    # Decode state-synced: each step from the JAX cache.
    step = jax.jit(jmodel.decode_step)
    for i in range(3):
        token = np.full((2, 1), (5 * i + 3) % cfg.vocab_size)
        want, jnext = step(jparams, jnp.asarray(token, jnp.int32), jcache)
        got, _ = model.decode_step(
            params, torch.from_numpy(token),
            lm_cache_from_numpy(jax.device_get(jcache), device="cpu"))
        np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)
        jcache = jnext


# ----------------------------------------------------------------------
# the optimizer and the train step
# ----------------------------------------------------------------------


def _tree(rng, shapes):
    return {k: rng.normal(size=s).astype(np.float32)
            for k, s in shapes.items()}


@pytest.mark.parametrize("sched", ["float", "warmup_cosine"])
@pytest.mark.parametrize("weight_decay", [0.0, 0.1])
def test_adam_step_bit_equal(sched, weight_decay):
    rng = np.random.default_rng(11)
    shapes = {"a": (300, 17), "b": (33,), "c": (4, 5, 6)}
    p = _tree(rng, shapes)
    jp, tp = ({k: jnp.asarray(v) for k, v in p.items()},
              {k: _t(v) for k, v in p.items()})
    jlr = 1e-2 if sched == "float" else jsched.warmup_cosine(1e-2, 2, 10)
    tlr = 1e-2 if sched == "float" else warmup_cosine(1e-2, 2, 10)
    jst, tst = jadam.adam_init(jp), adam_init(tp)
    for _ in range(3):
        g = _tree(rng, shapes)
        jp, jst = jadam.adam_step(jp, {k: jnp.asarray(v)
                                       for k, v in g.items()}, jst, jlr,
                                  weight_decay=weight_decay)
        tp, tst = adam_step(tp, {k: _t(v) for k, v in g.items()}, tst, tlr,
                            weight_decay=weight_decay)
        for k in shapes:
            np.testing.assert_array_equal(_np(tp[k]), np.asarray(jp[k]))
            np.testing.assert_array_equal(_np(tst.mu[k]),
                                          np.asarray(jst.mu[k]))
            np.testing.assert_array_equal(_np(tst.nu[k]),
                                          np.asarray(jst.nu[k]))
        assert int(tst.step) == int(jst.step)


def test_adam_keeps_fp32_moments_for_bf16_params():
    p = {"w": torch.ones((4, 4), dtype=torch.bfloat16)}
    st = adam_init(p)
    assert st.mu["w"].dtype == torch.float32
    new, st = adam_step(p, {"w": torch.full((4, 4), 0.5,
                                            dtype=torch.bfloat16)}, st, 0.1)
    assert new["w"].dtype == torch.bfloat16 and int(st.step) == 1


def test_schedules_match_jax():
    steps = np.arange(0, 30, dtype=np.int32)
    pairs = ((jsched.constant(3e-4), constant(3e-4)),
             (jsched.cosine_decay(1e-3, 20, 0.1), cosine_decay(1e-3, 20, 0.1)),
             (jsched.warmup_cosine(1e-3, 5, 25), warmup_cosine(1e-3, 5, 25)))
    for jf, tf in pairs:
        for s in steps:
            want = np.asarray(jf(jnp.asarray(s)))
            got = _np(tf(torch.tensor(int(s), dtype=torch.int32)))
            assert got.dtype == np.float32
            assert ulps(np.atleast_1d(got), np.atleast_1d(want)).max() <= 4


@pytest.mark.parametrize("grad_accum", [1, 2])
def test_train_step_matches_jax(setup, grad_accum):
    """The reference's make_train_step on a one-device (data, model) mesh
    against the port's: loss, then AdamW on the loss gradient plus the
    prox pull toward a center."""
    from jax.sharding import Mesh

    from repro.launch.steps import make_train_step as jax_make_train_step
    from repro_torch.launch.steps import make_train_step

    jcfg, cfg, jmodel, model, jparams, params = setup
    mesh = Mesh(np.asarray(jax.devices()[:1]).reshape(1, 1),
                ("data", "model"))
    jstep, _, _, (_, opt_abs, _, b_abs) = jax_make_train_step(
        jmodel, mesh, batch=4, seq=16, grad_accum=grad_accum, rho=1e-2,
        lr=1e-3)
    step, (p_abs, t_opt_abs, _, tb_abs) = make_train_step(
        model, batch=4, seq=16, grad_accum=grad_accum, rho=1e-2, lr=1e-3)
    assert tuple(tb_abs["tokens"].shape) == b_abs["tokens"].shape
    rng = np.random.default_rng(2)
    center = jax.tree.map(lambda x: x + 0.01 * rng.normal(
        size=x.shape).astype(np.float32), jax.device_get(jparams))
    tok, lab = _batch(cfg, 4, 16, seed=9)
    jb = {"tokens": jnp.asarray(tok, jnp.int32),
          "labels": jnp.asarray(lab, jnp.int32)}
    jp, jopt, jloss = jax.jit(jstep)(jparams, jadam.adam_init(jparams),
                                     center, jb)
    tcenter = tree_map(_t, center)
    tp, topt, tloss = step(params, adam_init(params), tcenter,
                           {"tokens": torch.from_numpy(tok),
                            "labels": torch.from_numpy(lab)})
    np.testing.assert_allclose(_np(tloss), np.asarray(jloss), **TOL)
    # The first moment is (1 − β1)·(∇ + ρ(θ − c)): the gradient grade.
    for g, w in zip(tree_leaves(topt.mu), _jleaves(jopt.mu), strict=True):
        np.testing.assert_allclose(_np(g), w, rtol=1e-4, atol=1e-7)
    # Adam's first step moves a weight by lr·g/(|g| + ε): where |g| is
    # within its rounding of 0 the direction is not determined, and the
    # two may differ by up to lr; elsewhere the solve grade.
    for g, w, m in zip(tree_leaves(tp), _jleaves(jp), _jleaves(jopt.mu),
                       strict=True):
        g, firm = _np(g), np.abs(m) > 1e-7
        np.testing.assert_allclose(g[firm], w[firm], rtol=1e-4, atol=1e-6)
        assert np.abs(g - w).max() <= 1e-3 * 1.0001
    assert int(topt.step) == 1


def test_prefill_and_decode_steps_run_their_abstract_arguments(setup):
    """``launch.steps.make_prefill_step`` / ``make_decode_step``: the
    meta-device arguments have the real arguments' shapes, and the steps
    run on those."""
    from repro_torch.launch.steps import make_decode_step, make_prefill_step

    _, cfg, _, model, _, params = setup
    prefill, (p_abs, b_abs) = make_prefill_step(model, batch=2, seq=12)
    decode, (_, tok_abs, cache_abs) = make_decode_step(model, batch=2,
                                                       seq=12)
    real = tree_leaves(params)
    assert len(tree_leaves(p_abs)) == len(real)
    for a, r in zip(tree_leaves(p_abs), real, strict=True):
        assert a.device.type == "meta" and a.shape == r.shape
    tokens = torch.zeros(b_abs["tokens"].shape, dtype=torch.int64)
    logits, cache = prefill(params, {"tokens": tokens})
    assert logits.shape == (2, 1, cfg.vocab_size)
    assert cache["k"].shape == cache_abs["k"].shape
    cache["pos"] = 11  # the last slot of the 12-position cache
    logits, _ = decode(params, torch.zeros(tok_abs.shape,
                                           dtype=torch.int64), cache)
    assert logits.shape == (2, 1, cfg.vocab_size)

"""The port's zamba2-2.7b serving path against the JAX package's, on
the CPU, module by module and as a whole.

Weights come from the JAX package's init and are carried across with
``repro_torch.convert.lm_params_from_numpy``; inputs are made with
numpy from a seed.  The JAX side runs as the JAX package runs it on the
CPU (its attention prefill through ``blockwise_attention``, its SSD
scan through ``lax.scan``); the port's side runs its kernels' plain
versions (CPU tensors).  Everything is fp32, ``zamba2-2.7b``
``.reduced()`` (4 mamba layers in 2 groups, d_model 128, 4 heads of
32 with 2 kv heads, window 16, chunk 8).

Tolerance: rtol/atol 2e-4 throughout — the same functions computed in
fp32 with sums taken in another order (matmuls, the online against the
one-pass softmax, the chunked SSD's einsums).  Decode is compared
state-synced: every step starts from the JAX cache.
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
from repro.models import ssm as jssm
from repro.models.api import build_model as jax_build_model
from repro_torch import prng
from repro_torch.configs import get_config
from repro_torch.convert import lm_cache_from_numpy, lm_params_from_numpy
from repro_torch.kernels import ops
from repro_torch.models import attention, build_model, layers, param_count, \
    ssm
from torch_threads import _one_torch_thread  # noqa: F401

TOL = dict(rtol=2e-4, atol=2e-4)


def _np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


def _t(a):
    return torch.from_numpy(np.array(a))


def _tree_t(tree):
    return {k: _tree_t(v) if isinstance(v, dict) else _t(v)
            for k, v in tree.items()}


def _close(got, want, **tol):
    np.testing.assert_allclose(_np(got), np.asarray(want), **(tol or TOL))


@pytest.fixture(autouse=True)
def _counts_stay_zero():
    ops.reset_launch_counts()
    yield
    assert ops.launch_counts() == {k: 0 for k in ops.KERNELS}, \
        "a CPU tensor must never reach a kernel launch"


# ----------------------------------------------------------------------
# configuration
# ----------------------------------------------------------------------


@pytest.mark.parametrize("reduced", [False, True])
def test_config_is_the_jax_packages(reduced):
    got, want = get_config("zamba2-2.7b"), jax_get_config("zamba2-2.7b")
    if reduced:
        got, want = got.reduced(), want.reduced()
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.vocab_padded == want.vocab_padded
    assert got.supports_decode == want.supports_decode
    assert get_config("zamba2_2_7b") == get_config("zamba2-2.7b")


def test_param_count_matches_the_jax_package():
    from repro.models.api import param_count as jax_param_count
    cfg = get_config("zamba2-2.7b")
    assert param_count(cfg) == jax_param_count(
        jax_get_config("zamba2-2.7b"))
    r = cfg.reduced()
    assert param_count(r) == jax_param_count(
        jax_get_config("zamba2-2.7b").reduced())


# ----------------------------------------------------------------------
# layers
# ----------------------------------------------------------------------


def test_rmsnorm():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 5, 64)).astype(np.float32)
    g = rng.normal(size=(64,)).astype(np.float32)
    _close(layers.rmsnorm(_t(x), _t(g), 1e-5),
           jlayers.rmsnorm(jnp.asarray(x), jnp.asarray(g), 1e-5))


def test_rmsnorm_casts_before_gamma():
    """bf16: the fp32 statistics are cast back to bf16 before γ."""
    rng = np.random.default_rng(1)
    x = rng.normal(size=(3, 64)).astype(np.float32)
    g = rng.normal(size=(64,)).astype(np.float32)
    got = layers.rmsnorm(_t(x).bfloat16(), _t(g).bfloat16())
    want = jlayers.rmsnorm(jnp.asarray(x, jnp.bfloat16),
                           jnp.asarray(g, jnp.bfloat16))
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want, np.float32))


@pytest.mark.parametrize("hd", [16, 80])
def test_rope_is_half_split(hd):
    rng = np.random.default_rng(hd)
    x = rng.normal(size=(2, 7, 3, hd)).astype(np.float32)
    pos = np.arange(3, 10)
    got = layers.apply_rope(_t(x), _t(pos)[None, :], 1e4)
    want = jlayers.apply_rope(jnp.asarray(x), jnp.asarray(pos)[None, :],
                              1e4)
    _close(got, want)


def test_swiglu():
    rng = np.random.default_rng(2)
    p = {k: rng.normal(size=s).astype(np.float32) * 0.1
         for k, s in (("w_gate", (32, 48)), ("w_up", (32, 48)),
                      ("w_down", (48, 32)))}
    x = rng.normal(size=(2, 5, 32)).astype(np.float32)
    _close(layers.swiglu(_tree_t(p), _t(x)),
           jlayers.swiglu({k: jnp.asarray(v) for k, v in p.items()},
                          jnp.asarray(x)))


def test_init_draws_the_jax_packages_shapes_and_scales():
    """Same shapes and dtypes, and the same draws: the port follows the
    reference's key tree with the ``jax.random`` twin, so each weight
    lies within 4 ulp of JAX's (3 for the normal draw, ROADMAP D5, and
    one for the scale)."""
    cfg = get_config("zamba2-2.7b").reduced()
    params = build_model(cfg).init(0, device="cpu")
    jtree = jax_build_model(jax_get_config("zamba2-2.7b").reduced()).init(
        jax.random.PRNGKey(0))
    jflat = {"/".join(str(getattr(k, "key", k)) for k in path): leaf
             for path, leaf in jax.tree_util.tree_flatten_with_path(jtree)[0]}
    got = _flat_paths(params)
    assert set(got) == set(jflat)
    for key, leaf in jflat.items():
        t = got[key]
        assert tuple(t.shape) == tuple(leaf.shape), key
        assert str(t.dtype).split(".")[-1] == str(leaf.dtype), key
        assert _ulps(_np(t), leaf) <= (1 if key.endswith(
            ("A_log", "dt_bias")) else 4), key
    # the deterministic SSM parameters (see test_ssm_fixed_params)
    for name in ("A_log", "D", "dt_bias"):
        assert _ulps(_np(params["layers"]["ssm"][name][1]),
                     jtree["layers"]["ssm"][name][1]) <= 1, name


# ----------------------------------------------------------------------
# SSM
# ----------------------------------------------------------------------

SSM_KW = dict(expand=2, ssm_state=16, head_dim=16, conv_kernel=4)


def _ssm_params(d_model=64, seed=0):
    p = jssm.ssm_init(jax.random.PRNGKey(seed), d_model, dtype=jnp.float32,
                      **SSM_KW)
    # non-trivial conv bias and norm gain
    rng = np.random.default_rng(seed)
    p = jax.device_get(p)
    p["conv_b"] = rng.normal(size=p["conv_b"].shape).astype(np.float32) * .1
    p["norm_g"] = 1 + rng.normal(size=p["norm_g"].shape).astype(
        np.float32) * .1
    return p


def _flat_paths(tree):
    """A nested dict → {"a/b/c": leaf}, the JAX tree's paths."""
    return {"/".join(str(getattr(k, "key", k)) for k in path): leaf
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _ulps(a, b):
    a = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    b = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return int(np.abs(a - b).max())


@pytest.mark.parametrize("n_heads", [8, 16, 80])
def test_ssm_fixed_params(n_heads):
    """The linspaces are bit-equal to jnp.linspace's; A_log and dt_bias
    within 1 ulp of the JAX package's at the head counts the served
    configurations use (16 reduced, 80 full): XLA's CPU log is not
    correctly rounded (ROADMAP Queue 3 D3)."""
    for lo, hi in ((1.0, 16.0), (1e-3, 0.1)):
        np.testing.assert_array_equal(
            ssm.linspace_f32(lo, hi, n_heads).numpy(),
            np.asarray(jnp.linspace(lo, hi, n_heads), np.float32))
    got = ssm.ssm_fixed_params(n_heads, "cpu")
    want = jax.device_get(jssm.ssm_init(
        jax.random.PRNGKey(0), n_heads * 8, expand=2, ssm_state=4,
        head_dim=16, conv_kernel=4, dtype=jnp.float32))
    for name in ("A_log", "D", "dt_bias"):
        assert got[name].dtype == torch.float32
        assert _ulps(_np(got[name]), want[name]) <= 1, name


def test_ssm_init_shapes_and_constants():
    got = ssm.ssm_init(prng.PRNGKey(0, device="cpu"), 64, dtype=
                       torch.float32, device="cpu", **SSM_KW)
    want = jax.device_get(jssm.ssm_init(jax.random.PRNGKey(0), 64,
                                        dtype=jnp.float32, **SSM_KW))
    for name in ("D", "conv_b", "norm_g"):
        np.testing.assert_array_equal(_np(got[name]), want[name])
    for name in ("in_proj", "conv_w", "out_proj"):
        assert tuple(got[name].shape) == want[name].shape
        assert _ulps(_np(got[name]), want[name]) <= 4, name  # D5


@pytest.mark.parametrize("s", [21, 24])
def test_ssm_forward_with_state(s):
    rng = np.random.default_rng(s)
    p = _ssm_params()
    x = rng.normal(size=(2, s, 64)).astype(np.float32)
    want, want_h = jssm.ssm_forward(p, jnp.asarray(x), chunk=8,
                                    return_state=True, **SSM_KW)
    got, got_h = ssm.ssm_forward(_tree_t(p), _t(x), chunk=8,
                                 return_state=True, **SSM_KW)
    assert got_h.dtype == torch.float32
    _close(got, want)
    _close(got_h, want_h)


def test_ssd_chunked_pads_with_dt_zero():
    """A sequence that is not a chunk multiple: y cropped, state
    untouched by the padding."""
    rng = np.random.default_rng(5)
    b, s, h, p, n = 1, 13, 2, 4, 8
    x = rng.normal(size=(b, s, h, p)).astype(np.float32)
    dt = rng.uniform(0.01, 0.3, (b, s, h)).astype(np.float32)
    a_log = rng.uniform(-1, 1, (h,)).astype(np.float32)
    bm = rng.normal(size=(b, s, n)).astype(np.float32)
    cm = rng.normal(size=(b, s, n)).astype(np.float32)
    want_y, want_h = jssm.ssd_chunked(*(jnp.asarray(a) for a in
                                        (x, dt, a_log, bm, cm)), chunk=8)
    got_y, got_h = ssm.ssd_chunked(*(_t(a) for a in (x, dt, a_log, bm, cm)),
                                   chunk=8)
    assert got_y.shape == (b, s, h, p)
    _close(got_y, want_y)
    _close(got_h, want_h)


def test_ssm_decode_step():
    rng = np.random.default_rng(7)
    p = _ssm_params(seed=3)
    cache = {"conv": rng.normal(size=(2, 3, 128 + 32)).astype(np.float32),
             "ssm": rng.normal(size=(2, 8, 16, 16)).astype(np.float32)}
    x = rng.normal(size=(2, 1, 64)).astype(np.float32)
    want, want_c = jssm.ssm_decode_step(
        p, jnp.asarray(x), {k: jnp.asarray(v) for k, v in cache.items()},
        **SSM_KW)
    got, got_c = ssm.ssm_decode_step(_tree_t(p), _t(x), _tree_t(cache),
                                     **SSM_KW)
    _close(got, want)
    for k in ("conv", "ssm"):
        _close(got_c[k], want_c[k])


# ----------------------------------------------------------------------
# attention
# ----------------------------------------------------------------------

ATT_KW = dict(rope_theta=1e4, num_heads=4, num_kv_heads=2, head_dim=32)


def _att_params(seed=0):
    return jax.device_get(jattn.attention_init(
        jax.random.PRNGKey(seed), 64, 4, 2, 32, jnp.float32))


@pytest.mark.parametrize("window", [0, 16])
def test_attention_forward(window):
    rng = np.random.default_rng(window)
    p = _att_params()
    x = rng.normal(size=(2, 37, 64)).astype(np.float32)
    pos = np.arange(37)
    want, (wk, wv) = jattn.attention_forward(
        p, jnp.asarray(x), positions=jnp.asarray(pos), window=window,
        kv_block=8, return_kv=True, **ATT_KW)
    got, (gk, gv) = attention.attention_forward(
        _tree_t(p), _t(x), positions=_t(pos), window=window,
        return_kv=True, **ATT_KW)
    _close(got, want)
    _close(gk, wk)
    _close(gv, wv)


@pytest.mark.parametrize("mode", ["prefix", "bidir"])
def test_attention_masks_not_ported_raise(mode):
    """The prefix and bidir masks have no kernel: serving takes
    ``blockwise_attention`` for them (the reference's path, no launch)
    and gives its values; a name that is not a mask raises."""
    p = _att_params()
    x = np.random.default_rng(5).normal(size=(2, 11, 64)).astype(np.float32)
    want = jattn.attention_forward(
        p, jnp.asarray(x), positions=jnp.arange(11), mask_mode=mode,
        prefix_len=4, kv_block=8, **ATT_KW)
    ops.reset_launch_counts()
    got = attention.attention_forward(
        _tree_t(p), _t(x), positions=torch.arange(11), mask_mode=mode,
        prefix_len=4, kv_block=8, **ATT_KW)
    assert ops.launch_counts() == {k: 0 for k in ops.KERNELS}
    _close(got, want)
    with pytest.raises(ValueError, match="mask_mode"):
        attention.attention_forward(_tree_t(p), torch.zeros(1, 4, 64),
                                    positions=torch.arange(4),
                                    mask_mode=mode + "-lm", **ATT_KW)


@pytest.mark.parametrize("window,s_max,pos", [
    (16, 16, 5),    # ring not yet full
    (16, 16, 29),   # ring wrapped
    (0, 24, 11),    # linear cache
])
def test_attention_decode(window, s_max, pos):
    rng = np.random.default_rng(pos)
    p = _att_params(seed=1)
    kc = rng.normal(size=(2, s_max, 2, 32)).astype(np.float32)
    vc = rng.normal(size=(2, s_max, 2, 32)).astype(np.float32)
    x = rng.normal(size=(2, 1, 64)).astype(np.float32)
    want, (wk, wv) = jattn.attention_decode(
        p, jnp.asarray(x), (jnp.asarray(kc), jnp.asarray(vc)),
        jnp.asarray(pos, jnp.int32), window=window, **ATT_KW)
    gk, gv = _t(kc), _t(vc)
    got, _ = attention.attention_decode(_tree_t(p), _t(x), (gk, gv), pos,
                                        window=window, **ATT_KW)
    _close(got, want)
    _close(gk, wk)  # written in place
    _close(gv, wv)


# ----------------------------------------------------------------------
# the slice as a whole
# ----------------------------------------------------------------------


@pytest.fixture(scope="module")
def slice_setup():
    jcfg = jax_get_config("zamba2-2.7b").reduced()
    cfg = get_config("zamba2-2.7b").reduced()
    jmodel = jax_build_model(jcfg)
    jparams = jax.jit(jmodel.init)(jax.random.PRNGKey(0))
    params = lm_params_from_numpy(jax.device_get(jparams), cfg,
                                  device="cpu")
    return dict(cfg=cfg, jcfg=jcfg, jmodel=jmodel, jparams=jparams,
                model=build_model(cfg), params=params)


def _tokens(cfg, b, s, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)


def _cache_close(got, want):
    assert got["pos"] == int(want["pos"])
    for k in ("ssm", "conv"):
        _close(got["layers"][k], want["layers"][k])
    _close(got["k"], want["k"])
    _close(got["v"], want["v"])


def test_converted_params_mirror_the_jax_tree(slice_setup):
    params, jparams = slice_setup["params"], slice_setup["jparams"]
    assert params["layers"]["ssm"]["in_proj"].shape[0] == 4
    np.testing.assert_array_equal(
        _np(params["layers"]["ssm"]["in_proj"][2]),
        np.asarray(jparams["layers"]["ssm"]["in_proj"][2]))
    np.testing.assert_array_equal(_np(params["shared"]["attn"]["wq"]),
                                  np.asarray(jparams["shared"]["attn"]["wq"]))
    np.testing.assert_array_equal(_np(params["lm_head"]),
                                  np.asarray(jparams["lm_head"]))


@pytest.mark.parametrize("s", [12, 21, 24])
def test_prefill_and_decode_match_jax(slice_setup, s):
    """Prefill logits and cache (12: shorter than the window, the KV
    cache padded; 21: not a chunk multiple; 24: a chunk multiple longer
    than the window, the KV ring rolled), then 4 state-synced decode
    steps."""
    cfg, jmodel, jparams = (slice_setup[k] for k in
                            ("cfg", "jmodel", "jparams"))
    model, params = slice_setup["model"], slice_setup["params"]
    max_seq = s + 8
    tok = _tokens(cfg, 2, s, s)
    want, jcache = jax.jit(lambda p, b: jmodel.prefill(p, b, max_seq))(
        jparams, {"tokens": jnp.asarray(tok)})
    got, cache = model.prefill(params, {"tokens": _t(tok).long()}, max_seq)
    assert got.shape == (2, 1, cfg.vocab_size)
    _close(got, want)
    jcache = jax.device_get(jcache)
    _cache_close(cache, jcache)

    step = jax.jit(jmodel.decode_step)
    for _ in range(4):
        nxt = np.asarray(jnp.argmax(want[:, -1], -1)).astype(np.int32)[:,
                                                                        None]
        cache = lm_cache_from_numpy(jcache, device="cpu")
        got, cache = model.decode_step(params, _t(nxt).long(), cache)
        want, jcache = step(jparams, jnp.asarray(nxt), jcache)
        jcache = jax.device_get(jcache)
        _close(got, want)
        _cache_close(cache, jcache)


def test_prefill_decode_consistency(slice_setup):
    """The port's own: prefill(t₀..tₙ)'s last logits == decode of tₙ
    after prefill(t₀..tₙ₋₁) (as tests/test_archs.py checks the JAX
    package), and free-running greedy decode agrees with JAX's."""
    cfg, model, params = (slice_setup[k] for k in ("cfg", "model",
                                                    "params"))
    tok = _t(_tokens(cfg, 2, 32, 11)).long()
    full, _ = model.prefill(params, {"tokens": tok}, 32)
    _, cache = model.prefill(params, {"tokens": tok[:, :-1]}, 32)
    dec, _ = model.decode_step(params, tok[:, -1:], cache)
    torch.testing.assert_close(dec, full, **TOL)


def test_greedy_generation_matches_jax(slice_setup):
    """Free-running: 6 greedy tokens from the port equal JAX's."""
    cfg, jmodel, jparams = (slice_setup[k] for k in
                            ("cfg", "jmodel", "jparams"))
    model, params = slice_setup["model"], slice_setup["params"]
    tok = _tokens(cfg, 2, 19, 4)
    want, jcache = jax.jit(lambda p, b: jmodel.prefill(p, b, 32))(
        jparams, {"tokens": jnp.asarray(tok)})
    got, cache = model.prefill(params, {"tokens": _t(tok).long()}, 32)
    step = jax.jit(jmodel.decode_step)
    jt, gt = [], []
    for _ in range(6):
        jn = jnp.argmax(want[:, -1], -1).astype(jnp.int32)[:, None]
        gn = got[:, -1].argmax(-1)[:, None]
        jt.append(np.asarray(jn))
        gt.append(_np(gn))
        want, jcache = step(jparams, jn, jcache)
        got, cache = model.decode_step(params, gn, cache)
    np.testing.assert_array_equal(np.concatenate(gt, 1),
                                  np.concatenate(jt, 1))


def test_other_families_raise():
    """Every family of the reference builds; an unknown family or
    architecture raises."""
    from repro_torch.configs.model_config import ModelConfig
    assert get_config("granite-3-2b").family == "dense"
    assert get_config("mamba2-2.7b").family == "ssm"
    assert get_config("mixtral-8x7b").family == "moe"
    moe = ModelConfig(name="m", family="moe", num_layers=2, d_model=8,
                      num_heads=2, num_kv_heads=2, head_dim=4, d_ff=16,
                      vocab_size=32, num_experts=4, top_k=2)
    params = build_model(moe).init(0, device="cpu")
    assert tuple(params["layers"]["moe"]["w_gate"].shape) == (2, 4, 8, 16)
    with pytest.raises(ValueError, match="unknown family"):
        build_model(ModelConfig(name="x", family="encdec", num_layers=2,
                                d_model=8, num_heads=2, num_kv_heads=2,
                                head_dim=4, d_ff=16, vocab_size=32))
    with pytest.raises(KeyError):
        get_config("no-such-model")


@pytest.mark.parametrize("name,kind", [
    ("void (anonymous namespace)::flash_attention_kernel<float, 5>(float "
     "const*, ...)", "K4 flash_attention"),
    ("void (anonymous namespace)::flash_attention_tc_kernel<5>(CUtensorMap_st"
     ", ...)", "K4 flash_attention"),
    ("void (anonymous namespace)::ssd_scan_kernel<__nv_bfloat16>(...)",
     "K5 ssd_scan"),
    ("void (anonymous namespace)::ssd_scan_vec_kernel<__nv_bfloat16>(...)",
     "K5 ssd_scan"),
    ("nvjet_tst_320x128_64x3_1x2_h_bz_coopB_NNT", "matmul (cuBLAS)"),
    ("void at::native::elementwise_kernel<128, 4, ...>", "other")])
def test_profile_serve_names_every_kernel_instance(name, kind):
    """The serve profile's breakdown finds both instances of K4 and both
    kernels of K5 by name."""
    from repro_torch.launch.profile_serve import kind_of

    assert kind_of(name) == kind

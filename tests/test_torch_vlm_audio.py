"""The vlm (paligemma-3b, prefix-LM) and audio (hubert-xlarge,
bidirectional encoder) families of the port against the JAX package's,
on the CPU.

* ``attention_forward`` under each of the reference's four masks
  (causal, causal with a window, prefix, bidir) — its output and its
  gradients against ``jax.value_and_grad`` of the reference's; off the
  causal mask the serving path takes ``blockwise_attention`` (no kernel
  has those masks), and an unknown mask raises.  The function
  differentiated is the mean of out·cot, a loss's scale.
* Both families ``.reduced()`` in fp32 (2 layers, d_model 128, 4 heads
  of 32, 4 prefix patches or frames of width 32) from the reference's
  seed-0 init (``convert.lm_params_from_numpy``): the loss and every
  gradient against ``jax.value_and_grad`` at the solve grade (rtol 1e-4
  / atol 1e-6), the vlm's over the text positions only.
* The vlm served: prefill with a cache that counts the prefix, against
  the reference's (logits and K/V at rtol/atol 2e-5), then three
  state-synced decode steps; with the reference's default ``max_seq``
  (the text's length) the cache has the reference's shape (prefix +
  text, no room for decode), and the port's decode refuses it (ROADMAP
  D11: the reference's clamps its write onto the last prompt position).
* The audio family has no decode path: ``prefill``, ``decode_step``,
  ``init_cache`` and the serving launcher raise, as the reference's do;
  the cross-pod launcher refuses both families (token batches only).

The JAX side of each is computed once per module, jitted.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import attention as jattn
from repro.models import transformer as jtf
from repro.models.api import build_model as jax_build_model
from repro.models.api import input_specs as jax_input_specs
from repro_torch.configs import get_config
from repro_torch.convert import lm_cache_from_numpy, lm_params_from_numpy
from repro_torch.kernels import ops
from repro_torch.models import attention, build_model, input_specs
from repro_torch.utils.pytree import tree_leaves, tree_map
from torch_threads import _one_torch_thread  # noqa: F401

TOL = dict(rtol=2e-5, atol=2e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)
VLM, AUDIO = "paligemma-3b", "hubert-xlarge"


def _np(t):
    return t.detach().cpu().numpy()


def _t(a, requires_grad=False):
    return torch.from_numpy(np.array(a)).requires_grad_(requires_grad)


@pytest.fixture(autouse=True)
def _counts_stay_zero():
    ops.reset_launch_counts()
    yield
    assert ops.launch_counts() == {k: 0 for k in ops.KERNELS}, \
        "a CPU tensor must never reach a kernel launch"


# ----------------------------------------------------------------------
# the four masks
# ----------------------------------------------------------------------

ATT_KW = dict(rope_theta=1e4, num_heads=4, num_kv_heads=2, head_dim=16)
MASKS = {"causal": ("causal", 0, 0), "window": ("causal", 6, 0),
         "prefix": ("prefix", 0, 5), "bidir": ("bidir", 0, 0)}


@pytest.fixture(scope="module")
def mask_reference():
    """Per mask: the weights, x, the cotangent and the reference's output
    and gradients (x and each weight) of mean(out·cot)."""
    rng = np.random.default_rng(0)
    p = jax.device_get(jattn.attention_init(jax.random.PRNGKey(0), 32, 4, 2,
                                            16, jnp.float32))
    x = rng.normal(size=(2, 19, 32)).astype(np.float32)
    cot = rng.normal(size=(2, 19, 32)).astype(np.float32)
    out = {}
    for name, (mode, window, prefix) in MASKS.items():
        def f(p, x, mode=mode, window=window, prefix=prefix):
            y = jattn.attention_forward(
                p, x, positions=jnp.arange(19), mask_mode=mode,
                window=window, prefix_len=prefix, kv_block=8, **ATT_KW)
            return jnp.mean(y * cot), y

        (_, y), grads = jax.jit(jax.value_and_grad(
            f, argnums=(0, 1), has_aux=True))(p, jnp.asarray(x))
        out[name] = (np.asarray(y), jax.device_get(grads))
    return p, x, cot, out


@pytest.mark.parametrize("mask", list(MASKS))
def test_attention_forward_masks_match_jax(mask, mask_reference):
    p, x, cot, ref = mask_reference
    mode, window, prefix = MASKS[mask]
    want, (wp, wx) = ref[mask]
    tp = {k: _t(v, True) for k, v in p.items()}
    tx = _t(x, True)
    for blockwise in (False, True):  # the serving and the training path
        kw = dict(positions=torch.arange(19), mask_mode=mode, window=window,
                  prefix_len=prefix, kv_block=8, blockwise=blockwise,
                  **ATT_KW)
        if not blockwise and mode == "causal":
            # K4's plain version: it has no backward (its wrapper refuses
            # inputs that require grad), and serving runs without grad.
            with torch.no_grad():
                got = attention.attention_forward(tp, tx, **kw)
            np.testing.assert_allclose(_np(got), want, **TOL)
            continue
        got = attention.attention_forward(tp, tx, **kw)
        np.testing.assert_allclose(_np(got), want, **TOL)
        grads = torch.autograd.grad(torch.mean(got * _t(cot)),
                                    [tx] + [tp[k] for k in sorted(tp)])
        np.testing.assert_allclose(_np(grads[0]), np.asarray(wx), **GRAD_TOL)
        for g, k in zip(grads[1:], sorted(tp), strict=True):
            np.testing.assert_allclose(_np(g), np.asarray(wp[k]), err_msg=k,
                                       **GRAD_TOL)


@pytest.mark.parametrize("mode", ["none", "sliding", "prefix_lm"])
def test_unknown_mask_modes_raise(mode):
    with pytest.raises(ValueError, match="mask_mode"):
        attention.check_mask_mode(mode)
    p = {k: torch.zeros(8, 8) for k in ("wq", "wk", "wv", "wo")}
    with pytest.raises(ValueError, match="mask_mode"):
        attention.attention_forward(
            p, torch.zeros(1, 3, 8), positions=torch.arange(3),
            rope_theta=1e4, num_heads=2, num_kv_heads=2, head_dim=4,
            mask_mode=mode)


# ----------------------------------------------------------------------
# the two families: configs, inputs, loss and gradients
# ----------------------------------------------------------------------


def _train_batch(cfg, b, s, seed):
    """A train batch of ``s`` positions, numpy and torch: the audio
    family's frames, the vlm's patches and s − prefix text tokens."""
    rng = np.random.default_rng(seed)
    text = s - cfg.prefix_tokens if cfg.family == "vlm" else s
    np_b = {"labels": rng.integers(0, cfg.vocab_size, (b, text))}
    if cfg.family == "audio":
        np_b["features"] = (rng.normal(size=(b, s, cfg.frontend_dim))
                            * 0.3).astype(np.float32)
    else:
        np_b["tokens"] = rng.integers(0, cfg.vocab_size, (b, text))
        np_b["patches"] = (rng.normal(size=(b, cfg.prefix_tokens,
                                            cfg.frontend_dim))
                           * 0.3).astype(np.float32)
    jb = {k: jnp.asarray(v, jnp.int32 if v.dtype.kind == "i" else v.dtype)
          for k, v in np_b.items()}
    return jb, {k: torch.from_numpy(v) for k, v in np_b.items()}


@pytest.fixture(scope="module")
def families():
    """Per family: both reduced configs, the reference's seed-0 weights
    on both sides, a train batch and the reference's loss and
    gradients."""
    out = {}
    for arch in (VLM, AUDIO):
        jcfg, cfg = jax_get_config(arch).reduced(), get_config(arch).reduced()
        jmodel = jax_build_model(jcfg)
        jparams = jax.jit(jmodel.init)(jax.random.PRNGKey(0))
        params = lm_params_from_numpy(jax.device_get(jparams), cfg,
                                      device="cpu")
        jb, tb = _train_batch(cfg, 2, 20, seed=7)
        loss, grads = jax.jit(jax.value_and_grad(jmodel.loss))(jparams, jb)
        out[arch] = dict(jcfg=jcfg, cfg=cfg, jmodel=jmodel, jparams=jparams,
                         params=params, batch=tb, loss=np.asarray(loss),
                         grads=jax.device_get(grads))
    return out


@pytest.mark.parametrize("arch", [VLM, AUDIO])
@pytest.mark.parametrize("reduced", [False, True])
def test_config_is_the_jax_packages(arch, reduced):
    got, want = get_config(arch), jax_get_config(arch)
    if reduced:
        got, want = got.reduced(), want.reduced()
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.supports_decode == want.supports_decode == (arch == VLM)


@pytest.mark.parametrize("arch", [VLM, AUDIO])
@pytest.mark.parametrize("mode", ["train", "prefill", "decode"])
def test_input_specs_are_the_references(arch, mode):
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    want = jax_input_specs(jcfg, mode=mode, batch=4, seq=512)
    got = input_specs(cfg, mode=mode, batch=4, seq=512)
    assert {k: tuple(v.shape) for k, v in got.items()} == \
        {k: v.shape for k, v in want.items()}
    for k, v in got.items():
        assert v.device.type == "meta"
        assert v.dtype == (torch.int64 if want[k].dtype == jnp.int32
                           else torch.bfloat16), k


def test_parameter_trees_are_the_references(families):
    """The audio family has ``frontend_proj`` and no embedding; the vlm
    ``patch_proj`` beside its embedding."""
    for arch, want_keys in ((AUDIO, {"final_ln", "frontend_proj",
                                     "lm_head", "layers"}),
                            (VLM, {"final_ln", "embed", "lm_head",
                                   "patch_proj", "layers"})):
        f = families[arch]
        assert set(f["params"]) == want_keys == set(f["jparams"])
        got = tree_leaves(f["params"])
        want = jax.tree.leaves(f["jparams"])
        assert [tuple(t.shape) for t in got] == [w.shape for w in want]


@pytest.mark.parametrize("arch,remat", [(VLM, False), (VLM, True),
                                        (AUDIO, False), (AUDIO, True)])
def test_loss_and_grads_match_jax(families, arch, remat):
    f = families[arch]
    cfg = dataclasses.replace(f["cfg"], remat=remat)
    tparams = tree_map(lambda x: x.clone().requires_grad_(True), f["params"])
    got = build_model(cfg).loss(tparams, f["batch"])
    grads = torch.autograd.grad(got, tree_leaves(tparams))
    np.testing.assert_allclose(_np(got), f["loss"], **TOL)
    paths = jax.tree_util.tree_flatten_with_path(f["grads"])[0]
    for g, (path, w) in zip(grads, paths, strict=True):
        np.testing.assert_allclose(_np(g), np.asarray(w),
                                   err_msg=jax.tree_util.keystr(path),
                                   **GRAD_TOL)


def test_vlm_loss_reads_the_text_positions_only(families):
    """The patches shape the text's hidden states through the prefix
    mask, so they move the loss; the labels cover the text only."""
    f = families[VLM]
    model, batch = build_model(f["cfg"]), dict(f["batch"])
    base = float(model.loss(f["params"], batch))
    batch["patches"] = batch["patches"] * 2
    assert float(model.loss(f["params"], batch)) != base
    assert batch["labels"].shape[1] == 20 - f["cfg"].prefix_tokens


# ----------------------------------------------------------------------
# the vlm served, and D11
# ----------------------------------------------------------------------

PROMPT, NEW = 9, 3


@pytest.fixture(scope="module")
def vlm_serving(families):
    """The reference's prefill of 2 requests (4 patches + 9 text tokens)
    into a cache with room for 3 new tokens, its 3 decode steps, and its
    prefill with the default ``max_seq``."""
    f = families[VLM]
    cfg, jmodel, jparams = f["cfg"], f["jmodel"], f["jparams"]
    rng = np.random.default_rng(3)
    tok = rng.integers(0, cfg.vocab_size, (2, PROMPT))
    patches = (rng.normal(size=(2, cfg.prefix_tokens, cfg.frontend_dim))
               * 0.2).astype(np.float32)
    jb = {"tokens": jnp.asarray(tok, jnp.int32),
          "patches": jnp.asarray(patches)}
    room = cfg.prefix_tokens + PROMPT + NEW
    logits, cache = jax.jit(lambda p, b: jmodel.prefill(p, b, room))(
        jparams, jb)
    decode = jax.jit(jmodel.decode_step)
    steps = []
    for i in range(NEW):
        token = np.full((2, 1), (7 * i + 2) % cfg.vocab_size)
        before = jax.device_get(cache)
        step_logits, cache = decode(jparams, jnp.asarray(token, jnp.int32),
                                    cache)
        steps.append((token, before, np.asarray(step_logits)))
    _, tight = jax.jit(lambda p, b: jmodel.prefill(p, b))(jparams, jb)
    return dict(batch={"tokens": torch.from_numpy(tok),
                       "patches": torch.from_numpy(patches)},
                room=room, logits=np.asarray(logits),
                cache=jax.device_get(steps[0][1]), steps=steps,
                tight=jax.device_get(tight))


def test_vlm_prefill_and_decode_match_jax(families, vlm_serving):
    f, v = families[VLM], vlm_serving
    model, params = build_model(f["cfg"]), f["params"]
    got, cache = model.prefill(params, v["batch"], v["room"])
    np.testing.assert_allclose(_np(got), v["logits"], **TOL)
    assert cache["pos"] == int(v["cache"]["pos"]) == \
        f["cfg"].prefix_tokens + PROMPT
    for key in ("k", "v"):
        assert cache[key].shape[2] == v["room"]
        np.testing.assert_allclose(_np(cache[key]), v["cache"][key], **TOL)
    for token, before, want in v["steps"]:  # each from the JAX cache
        got, _ = model.decode_step(params, torch.from_numpy(token),
                                   lm_cache_from_numpy(before, device="cpu"))
        np.testing.assert_allclose(_np(got), want, **TOL)
    # The port's own cache carries on as the reference's does.
    for token, _, want in v["steps"]:
        got, cache = model.decode_step(params, torch.from_numpy(token), cache)
        np.testing.assert_allclose(_np(got), want, **TOL)
    assert cache["pos"] == v["room"]


def test_vlm_default_cache_has_no_room_and_decode_refuses_it(families,
                                                           vlm_serving):
    """D11: with ``max_seq`` defaulting to the text's length the cache
    holds prefix + text positions (the reference's shape); the next
    position lies past its end, where the reference's decode would
    overwrite the last prompt position's K/V."""
    f, v = families[VLM], vlm_serving
    model, params = build_model(f["cfg"]), f["params"]
    _, cache = model.prefill(params, v["batch"])
    s = f["cfg"].prefix_tokens + PROMPT
    assert cache["k"].shape == v["tight"]["k"].shape
    assert cache["k"].shape[2] == s == cache["pos"]
    np.testing.assert_allclose(_np(cache["k"]), v["tight"]["k"], **TOL)
    before = cache["k"].clone()
    with pytest.raises(ValueError, match="prefix"):
        model.decode_step(params, torch.zeros((2, 1), dtype=torch.int64),
                          cache)
    assert torch.equal(cache["k"], before) and cache["pos"] == s


def test_serve_launcher_sizes_the_vlm_cache_for_the_prefix():
    """``launch/serve_lm.py`` on reduced paligemma: the request carries
    its patches, the cache counts them, every new token decodes, and no
    kernel runs (the prefix mask has none; CPU tensors take none)."""
    from repro_torch.launch.serve_lm import cache_len, make_request, serve

    cfg = get_config(VLM).reduced()
    req = make_request(cfg, 2, 6, 0, "cpu")
    assert tuple(req["patches"].shape) == (2, cfg.prefix_tokens,
                                           cfg.frontend_dim)
    assert req["patches"].dtype == torch.float32
    # The patches come from the prompts' generator, after the tokens.
    rng = np.random.default_rng(0)
    np.testing.assert_array_equal(req["tokens"].numpy(),
                                  rng.integers(0, cfg.vocab_size, (2, 6)))
    np.testing.assert_array_equal(req["patches"].numpy(), (rng.normal(
        size=(2, cfg.prefix_tokens, cfg.frontend_dim)) * 0.2).astype(
            np.float32))
    assert cache_len(cfg, 6, 5) == cfg.prefix_tokens + 11
    report = serve(cfg, batch=2, prompt_len=6, new_tokens=5, seed=0,
                   device="cpu")
    assert np.asarray(report["tokens"]).shape == (2, 5)
    assert report["launches"]["prefill"] == {k: 0 for k in ops.KERNELS}


# ----------------------------------------------------------------------
# the audio family has no decode path
# ----------------------------------------------------------------------


def test_audio_serving_raises_as_the_reference(families):
    f = families[AUDIO]
    cfg, jcfg, params = f["cfg"], f["jcfg"], f["params"]
    model = build_model(cfg)
    feats = torch.zeros((1, 4, cfg.frontend_dim))
    calls = {
        "prefill": (lambda: model.prefill(params, {"features": feats,
                                                   "tokens": feats}),
                    lambda: jtf.prefill(jcfg, f["jparams"], {})),
        "decode_step": (lambda: model.decode_step(
            params, torch.zeros((1, 1), dtype=torch.int64), {"pos": 0}),
            lambda: jtf.decode_step(jcfg, f["jparams"], None, {})),
        "init_cache": (lambda: model.init_cache(1, 8, device="cpu"),
                       lambda: jtf.init_cache(jcfg, 1, 8)),
    }
    for name, (port, ref) in calls.items():
        with pytest.raises(ValueError) as want:
            ref()
        with pytest.raises(ValueError) as got:
            port()
        assert str(got.value) == str(want.value), name


def test_launchers_refuse_what_the_family_cannot_do(capsys):
    from repro_torch.launch import serve_lm, train

    with pytest.raises(SystemExit, match="encoder-only"):
        serve_lm.main(["--arch", AUDIO, "--reduced", "--device", "cpu"])
    with pytest.raises(ValueError, match="encoder-only"):
        serve_lm.serve(get_config(AUDIO).reduced(), batch=1, prompt_len=4,
                       new_tokens=2, seed=0, device="cpu")
    for arch, what in ((VLM, "patch"), (AUDIO, "frame")):
        with pytest.raises(SystemExit, match=what):
            train.main(["--engine", "crosspod", "--arch", arch, "--reduced",
                        "--rounds", "1", "--device", "cpu"])

"""The MoE family of the port (``models/moe.py`` and the moe branch of
``models/transformer.py``) against the JAX package's, on the CPU.

The layer: ``moe_apply`` on weights of ``moe_init``'s shapes and scales
and inputs, made with numpy from a seed — the expert ids
equal to ``jax.lax.top_k``'s (the lower index first on a tie, the
reference's adversarial router of tests/test_models.py included), the
keep mask equal to the one the reference's cumulative count gives, out
and aux at rtol 1e-5; with a drop-free capacity ``moe_apply`` equals
the dense oracle ``moe_ref`` (the reference's property test, as cases);
the gradients through the router and the experts against
``jax.grad``, and twice bit for bit.

The family: ``mixtral-8x7b`` ``.reduced()`` (2 layers, 4 experts top-2,
a window of 16, d_model 128, vocab 512) in fp32 from the reference's
seed-0 init (``convert.lm_params_from_numpy``; the port's own init
within the ``jax.random`` twin's ulps of it): the loss (its aux term
included) and its gradients against ``jax.value_and_grad`` at the solve
grade (rtol 1e-4 / atol 1e-6), with and without remat; prefill and
state-synced decode against the reference's (window ring included) at
the dense family's rtol/atol 2e-5;
one cross-pod round state-synced against the reference's jitted round.
The JAX side of each is computed once per module, jitted (on the CPU
XLA compiles a jitted function once, where eager dispatch compiles each
of its ops and scan bodies on its own, several times slower).
"""
import dataclasses
import functools

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
from repro.models import moe as jmoe
from repro.models.api import build_model as jax_build_model
from repro_torch.configs import get_config
from repro_torch.convert import cross_pod_state_from_numpy, \
    cross_pod_state_to_numpy, lm_cache_from_numpy, lm_params_from_numpy
from repro_torch.core.controller import ControllerConfig
from repro_torch.core.crosspod import CrossPodConfig, make_cross_pod_round
from repro_torch.kernels import ops
from repro_torch.models import build_model, moe
from repro_torch.models.transformer import init_params
from repro_torch.utils.pytree import tree_leaves, tree_map
from torch_threads import _one_torch_thread  # noqa: F401

TOL = dict(rtol=1e-5, atol=1e-6)
LM_TOL = dict(rtol=2e-5, atol=2e-5)  # tests/test_torch_dense.py's grade
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)
ARCH = "mixtral-8x7b"


def _np(t):
    return t.detach().cpu().numpy()


def _tree_t(tree, requires_grad=False):
    return {k: torch.from_numpy(np.array(v)).requires_grad_(requires_grad)
            for k, v in tree.items()}


@pytest.fixture(autouse=True)
def _counts_stay_zero():
    ops.reset_launch_counts()
    yield
    assert ops.launch_counts() == {k: 0 for k in ops.KERNELS}, \
        "a CPU tensor must never reach a kernel launch"


# ----------------------------------------------------------------------
# the layer
# ----------------------------------------------------------------------


def _layer(seed, d, f, e, b, s, rigged=False):
    """Weights of ``moe_init``'s shapes and scales (numpy; the init's
    draws are held to the reference's by ``test_init_is_the_references``)
    and an input (B, S, d); ``rigged``: the adversarial router of
    tests/test_models.py (every token to expert 0, experts 1–3 tied) on
    positive inputs."""
    rng = np.random.default_rng(seed)
    se = (2.0 / (d + f)) ** 0.5
    p = {"router": rng.normal(size=(d, e)) * (2.0 / (d + e)) ** 0.5,
         "w_gate": rng.normal(size=(e, d, f)) * se,
         "w_up": rng.normal(size=(e, d, f)) * se,
         "w_down": rng.normal(size=(e, f, d)) * se}
    p = {k: v.astype(np.float32) for k, v in p.items()}
    x = rng.normal(size=(b, s, d)).astype(np.float32)
    if rigged:
        p["router"] = np.zeros_like(p["router"])
        p["router"][:, 0] = 10.0
        x = np.abs(x) + 0.1
    return p, x


def _keep_from_ids(eids, cap):
    """The reference's keep mask from its expert ids: a row is kept if
    fewer than ``cap`` earlier rows of its group chose its expert."""
    b = eids.shape[0]
    flat = eids.reshape(b, -1)
    keep = np.zeros(flat.shape, bool)
    for g in range(b):
        seen = {}
        for r, e in enumerate(flat[g]):
            keep[g, r] = seen.get(e, 0) < cap
            seen[e] = seen.get(e, 0) + 1
    return keep


# (seed, d, d_ff, experts, top_k, batch, seq, capacity factor, rigged)
LAYER_CASES = {
    "drops_cf1": (0, 16, 32, 4, 2, 2, 16, 1.0, False),
    "cf1.25_e8": (1, 16, 24, 8, 2, 3, 24, 1.25, False),
    "moonshot_like_e64_k6": (2, 32, 16, 64, 6, 2, 40, 1.25, False),
    "decode_s1": (3, 16, 32, 8, 2, 4, 1, 1.25, False),
    "no_drop": (4, 16, 32, 4, 2, 2, 12, 4.0, False),
    "tie_rigged_router": (0, 8, 16, 4, 2, 2, 16, 1.0, True),
}


@pytest.fixture(scope="module")
def layer_reference():
    """Per case: the weights, the input, and the reference's ids, out
    and aux, and its dense oracle's out."""
    out = {}
    for name, (seed, d, f, e, k, b, s, cf, rigged) in LAYER_CASES.items():
        p, x = _layer(seed, d, f, e, b, s, rigged)
        eids, y, aux, ref = _jreference(p, jnp.asarray(x), k, cf)
        out[name] = (p, x, np.asarray(eids), np.asarray(y), np.asarray(aux),
                     np.asarray(ref))
    return out


@functools.partial(jax.jit, static_argnums=(2, 3))
def _jreference(p, x, k, cf):
    _, eids = jax.lax.top_k(jax.nn.softmax(x @ p["router"], axis=-1), k)
    y, aux = jmoe.moe_apply(p, x, top_k=k, capacity_factor=cf)
    return eids, y, aux, jmoe.moe_ref(p, x, top_k=k)


@pytest.mark.parametrize("case", list(LAYER_CASES))
def test_moe_apply_matches_jax(case, layer_reference):
    _, d, _, e, k, b, s, cf, rigged = LAYER_CASES[case]
    p, x, eids, want, want_aux, want_ref = layer_reference[case]
    got, aux = moe.moe_apply(_tree_t(p), torch.from_numpy(x), top_k=k,
                             capacity_factor=cf)
    plan = moe.routing(_tree_t(p), torch.from_numpy(x), k, cf)
    cap = moe.capacity(s, k, e, cf)
    assert plan["cap"] == cap
    np.testing.assert_array_equal(plan["eids"].numpy(), eids)
    keep = _keep_from_ids(eids, cap)
    np.testing.assert_array_equal(plan["keep"].numpy(), keep)
    np.testing.assert_allclose(_np(got), want, **TOL)
    np.testing.assert_allclose(_np(aux), want_aux, **TOL)
    if rigged:
        # The tie: experts 1–3 equal, the lower index second everywhere;
        # expert 0 overflows its capacity and the aux flags it.
        assert (eids[..., 0] == 0).all() and (eids[..., 1] == 1).all()
        assert not keep.all() and float(aux) > 1.5
    # The dense oracle, and with a drop-free capacity the layer, equal
    # the reference's oracle.
    np.testing.assert_allclose(_np(moe.moe_ref(_tree_t(p), torch.from_numpy(
        x), top_k=k)), want_ref, **TOL)
    if case == "no_drop":
        assert keep.all()
        np.testing.assert_allclose(_np(got), want_ref, rtol=2e-4, atol=2e-4)
    if s == 1:
        assert cap == 1 and keep.all()  # one token's k experts never drop
    # Without the aux: the same out, and a zero.
    out2, zero = moe.moe_apply(_tree_t(p), torch.from_numpy(x), top_k=k,
                               capacity_factor=cf, return_aux=False)
    assert torch.equal(out2, got) and float(zero) == 0.0


@pytest.mark.parametrize("s,top_k,e,cf", [
    (16, 2, 4, 1.0), (2048, 6, 64, 1.25), (1, 6, 64, 1.25), (7, 2, 8, 1.25),
    (2048, 2, 8, 1.25), (256, 6, 64, 64.0), (3, 8, 128, 1.25),
    (5, 2, 4, 4.0)])
def test_capacity_is_the_references(s, top_k, e, cf):
    want = max(min(int(-(-s * top_k // e) * cf), s * top_k), 1)
    assert moe.capacity(s, top_k, e, cf) == want


# The reference's property test (no drop ⇒ the dense oracle), as cases
# (the oracle is held to the reference's in test_moe_apply_matches_jax).
@pytest.mark.parametrize("e,k,s,seed", [
    (2, 1, 2, 0), (2, 2, 9, 7), (4, 1, 24, 13), (4, 2, 17, 21),
    (8, 1, 5, 34), (8, 2, 24, 50)])
def test_no_drop_matches_the_dense_oracle(e, k, s, seed):
    p, x = _layer(seed, 8, 16, e, 2, s)
    tp, tx = _tree_t(p), torch.from_numpy(x)
    out, _ = moe.moe_apply(tp, tx, top_k=k, capacity_factor=float(e))
    ref = moe.moe_ref(tp, tx, top_k=k)
    np.testing.assert_allclose(_np(out), _np(ref), rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("cf", [4.0, 1.0])
def test_router_and_expert_grads_match_jax(cf):
    """tests/test_models.py's router-gradient loss (Σ out² + 0.01·aux),
    every leaf's gradient against ``jax.grad``; with cf 1.0 some rows
    drop.  The backward repeats bit for bit."""
    p, x = _layer(0, 8, 16, 4, 1, 8)

    def jloss(p):
        out, aux = jmoe.moe_apply(p, jnp.asarray(x), top_k=2,
                                  capacity_factor=cf)
        return jnp.sum(out ** 2) + 0.01 * aux

    want = jax.jit(jax.grad(jloss))(p)

    def grads():
        tp = _tree_t(p, requires_grad=True)
        out, aux = moe.moe_apply(tp, torch.from_numpy(x), top_k=2,
                                 capacity_factor=cf)
        loss = torch.sum(out ** 2) + 0.01 * aux
        return dict(zip(tp, torch.autograd.grad(loss, list(tp.values()))))

    got, again = grads(), grads()
    assert float(got["router"].abs().sum()) > 0
    for k in p:
        np.testing.assert_allclose(_np(got[k]), np.asarray(want[k]),
                                   err_msg=k, **GRAD_TOL)
        assert torch.equal(got[k], again[k]), k


def test_router_is_fp32_in_a_bf16_model():
    """The router is drawn in fp32 whatever the model's dtype (the
    reference's ``dense_init(kr, d, E, float32)``), the experts in the
    model's; a bf16 layer returns bf16 and an fp32 aux."""
    cfg = get_config(ARCH).reduced(dtype="bfloat16")
    lp = init_params(cfg, device="meta")["layers"]["moe"]
    assert lp["router"].dtype == torch.float32
    assert lp["w_gate"].dtype == torch.bfloat16
    assert tuple(lp["w_gate"].shape) == (2, 4, 128, 256)
    assert tuple(lp["w_down"].shape) == (2, 4, 256, 128)
    p, x = _layer(0, 16, 32, 4, 2, 5)
    lay = {k: torch.from_numpy(v).to(torch.float32 if k == "router"
                                     else torch.bfloat16)
           for k, v in p.items()}
    out, aux = moe.moe_apply(lay, torch.from_numpy(x).to(torch.bfloat16),
                             top_k=2)
    assert out.dtype == torch.bfloat16 and aux.dtype == torch.float32


def test_first_block_routing_at_moonshot_width_is_the_references():
    """moonshot-v1-16b-a3b's first block at its published widths (d
    2048, 16 heads of 128, 64 experts top-6, capacity factor 1.25) on
    one sequence of 1024 random token embeddings at the init's scale
    1/√d, the attention and router weights at the init's scales (numpy):
    the router's input rmsnorm(e + attention(rmsnorm(e))) routes to the
    reference's expert ids and keep mask.  The attention's output (a
    causal average of random values) outweighs the embedding and shares
    a direction across the sequence, so the routing crowds a few experts
    and drops rows, where the embedding alone drops none."""
    from repro.models.attention import attention_forward as jattention
    from repro.models.layers import rmsnorm as jrmsnorm
    from repro_torch.models.attention import attention_forward
    from repro_torch.models.layers import rmsnorm

    cfg = get_config("moonshot-v1-16b-a3b")
    d, e, k, s = cfg.d_model, cfg.num_experts, cfg.top_k, 1024
    rng = np.random.default_rng(0)
    qkv = cfg.num_heads * cfg.head_dim
    w = {n: (rng.normal(size=shape) * (2.0 / sum(shape)) ** 0.5)
         .astype(np.float32)
         for n, shape in (("wq", (d, qkv)), ("wk", (d, qkv)), ("wv", (d, qkv)),
                          ("wo", (qkv, d)), ("router", (d, e)))}
    emb = (rng.normal(size=(1, s, d)) / d ** 0.5).astype(np.float32)
    kw = dict(rope_theta=cfg.rope_theta, num_heads=cfg.num_heads,
              num_kv_heads=cfg.num_kv_heads, head_dim=cfg.head_dim)
    ones = np.ones(d, np.float32)
    jw = {n: jnp.asarray(v) for n, v in w.items()}
    jx = jnp.asarray(emb)
    jh = jx + jattention(jw, jrmsnorm(jx, ones), positions=jnp.arange(s),
                         **kw)
    _, want = jax.lax.top_k(jax.nn.softmax(
        jrmsnorm(jh, ones) @ jw["router"], axis=-1), k)
    want = np.asarray(want)
    tw = _tree_t(w)
    x = torch.from_numpy(emb)
    h = x + attention_forward(tw, rmsnorm(x, torch.from_numpy(ones)),
                              positions=torch.arange(s), blockwise=True,
                              **kw)
    got = moe.routing(tw, rmsnorm(h, torch.from_numpy(ones)), k,
                      cfg.capacity_factor)
    cap = moe.capacity(s, k, e, cfg.capacity_factor)
    np.testing.assert_array_equal(got["eids"].numpy(), want)
    np.testing.assert_array_equal(got["keep"].numpy(),
                                  _keep_from_ids(want, cap))
    alone = moe.routing(tw, rmsnorm(x, torch.from_numpy(ones)), k,
                        cfg.capacity_factor)
    assert bool(alone["keep"].all())
    assert float(got["keep"].float().mean()) < 0.95


# ----------------------------------------------------------------------
# the family: reduced mixtral (window 16)
# ----------------------------------------------------------------------


def _batch(cfg, b, s, seed):
    toks = np.random.default_rng(seed).integers(0, cfg.vocab_size,
                                                (b, s + 1))
    return toks[:, :-1], toks[:, 1:]


LOSS_SHAPE = (2, 20)
PREFILL = dict(s=21, max_seq=24)  # s > the window: the ring is cut


@pytest.fixture(scope="module")
def family():
    """Both packages' reduced mixtral, the reference's seed-0 weights on
    both sides, the reference's loss and gradients (remat off; remat
    leaves the values unchanged), its prefill and three state-synced
    decode steps."""
    jcfg, cfg = jax_get_config(ARCH).reduced(), get_config(ARCH).reduced()
    jmodel, model = jax_build_model(jcfg), build_model(cfg)
    jparams = jax.jit(jmodel.init)(jax.random.PRNGKey(0))
    params = lm_params_from_numpy(jax.device_get(jparams), cfg, device="cpu")
    tok, lab = _batch(cfg, *LOSS_SHAPE, seed=7)
    loss, grads = jax.jit(jax.value_and_grad(jmodel.loss))(
        jparams, {"tokens": jnp.asarray(tok, jnp.int32),
                  "labels": jnp.asarray(lab, jnp.int32)})
    ptok, _ = _batch(cfg, 2, PREFILL["s"], seed=3)
    logits, cache = jax.jit(lambda p, b: jmodel.prefill(
        p, b, PREFILL["max_seq"]))(jparams,
                                   {"tokens": jnp.asarray(ptok, jnp.int32)})
    decode = jax.jit(jmodel.decode_step)
    steps = []
    for i in range(3):
        token = np.full((2, 1), (5 * i + 3) % cfg.vocab_size)
        before = jax.device_get(cache)
        step_logits, cache = decode(jparams, jnp.asarray(token, jnp.int32),
                                    cache)
        steps.append((token, before, np.asarray(step_logits)))
    return dict(cfg=cfg, model=model, jparams=jparams, params=params,
                batch=(tok, lab),
                loss=np.asarray(loss), grads=jax.device_get(grads),
                prefill=(ptok, np.asarray(logits), jax.device_get(
                    steps[0][1])), steps=steps)


def test_mixtral_reduced_is_the_moe_family_with_a_window(family):
    cfg = family["cfg"]
    assert (cfg.family, cfg.num_experts, cfg.top_k, cfg.sliding_window,
            cfg.capacity_factor) == ("moe", 4, 2, 16, 8.0)
    assert set(family["params"]["layers"]) == {"attn", "ln1", "ln2", "moe"}


def test_init_is_the_references(family):
    """The port's seeded init draws the reference's experts and router
    along its key tree, within the ``jax.random`` twin's ulps (ROADMAP
    D5, tests/test_torch_init.py's grade); the norms' ones equal."""
    from test_torch_init import SCALED_ULPS
    from test_torch_prng_dists import ulps

    got = init_params(family["cfg"], 0, device="cpu")
    paths = jax.tree_util.tree_flatten_with_path(
        jax.device_get(family["jparams"]))[0]
    assert len(paths) == len(tree_leaves(got))
    for (path, w), g in zip(paths, tree_leaves(got), strict=True):
        g, w, key = g.numpy(), np.asarray(w), jax.tree_util.keystr(path)
        assert g.shape == w.shape and g.dtype == w.dtype, key
        if "ln" in key:
            np.testing.assert_array_equal(g, w, err_msg=key)
        else:
            assert ulps(g, w).max() <= SCALED_ULPS, key


@pytest.mark.parametrize("remat", [False, True])
def test_loss_and_grads_match_jax(family, remat):
    cfg = dataclasses.replace(family["cfg"], remat=remat)
    tok, lab = family["batch"]
    tparams = tree_map(lambda x: x.clone().requires_grad_(True),
                       family["params"])
    got = build_model(cfg).loss(tparams, {"tokens": torch.from_numpy(tok),
                                          "labels": torch.from_numpy(lab)})
    grads = torch.autograd.grad(got, tree_leaves(tparams))
    np.testing.assert_allclose(_np(got), family["loss"], **TOL)
    paths = jax.tree_util.tree_flatten_with_path(family["grads"])[0]
    for g, (path, w) in zip(grads, paths, strict=True):
        np.testing.assert_allclose(_np(g), np.asarray(w),
                                   err_msg=jax.tree_util.keystr(path),
                                   **GRAD_TOL)
    # The aux term is in the loss: without it the loss moves.
    plain = dataclasses.replace(cfg, aux_coef=0.0)
    without = build_model(plain).loss(family["params"], {
        "tokens": torch.from_numpy(tok), "labels": torch.from_numpy(lab)})
    assert float(without) != float(got.detach())


def test_prefill_and_decode_match_jax(family):
    cfg, model, params = family["cfg"], family["model"], family["params"]
    ptok, want, jcache = family["prefill"]
    got, cache = model.prefill(params, {"tokens": torch.from_numpy(ptok)},
                               PREFILL["max_seq"])
    np.testing.assert_allclose(_np(got), want, **LM_TOL)
    assert cache["k"].shape[2] == cfg.sliding_window == 16
    for key in ("k", "v"):
        np.testing.assert_allclose(_np(cache[key]), np.asarray(jcache[key]),
                                   **LM_TOL)
    assert cache["pos"] == PREFILL["s"]
    for token, before, want in family["steps"]:  # each from the JAX cache
        got, _ = model.decode_step(params, torch.from_numpy(token),
                                   lm_cache_from_numpy(before, device="cpu"))
        np.testing.assert_allclose(_np(got), want, **LM_TOL)


CP = dict(rho=1e-3, lr=5e-3, local_steps=2)
CTRL = dict(K=0.05, alpha=0.9, target_rate=0.5)


def test_cross_pod_round_matches_jax_state_synced(family):
    """One round at P = 2 from the reference's seed-0 state (both pods
    fire), 2 local steps of 2 × 16 tokens, against the reference's
    jitted round: events equal, distances at rtol 1e-5, θ/λ/z_prev at
    the solve grade, the loss (the aux term included) at rtol 1e-5."""
    jcfg, cfg = jax_get_config(ARCH).reduced(), get_config(ARCH).reduced()
    jcp = JaxCrossPodConfig(n_pods=2, controller=JaxControllerConfig(**CTRL),
                            **CP)
    cp = CrossPodConfig(n_pods=2, controller=ControllerConfig(**CTRL), **CP)
    jmodel = jax_build_model(jcfg)
    jstate = jax_init_state(jcp, family["jparams"])
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size,
                                             (2, CP["local_steps"], 2, 17))
    before = jax.device_get(jstate)
    jstate, wm = jax.jit(jax_make_round(jcp, jmodel.loss))(jstate, {
        "tokens": jnp.asarray(toks[..., :-1], jnp.int32),
        "labels": jnp.asarray(toks[..., 1:], jnp.int32)})
    want, wm = jax.device_get(jstate), jax.device_get(wm)
    new, m = make_cross_pod_round(cp, build_model(cfg).loss)(
        cross_pod_state_from_numpy(before, device="cpu"),
        {"tokens": torch.from_numpy(toks[..., :-1]),
         "labels": torch.from_numpy(toks[..., 1:])})
    got = cross_pod_state_to_numpy(new)
    assert np.asarray(wm.events).all()
    np.testing.assert_array_equal(m.events.numpy(), wm.events)
    np.testing.assert_allclose(m.distances.numpy(), wm.distances, rtol=1e-5,
                               atol=1e-7)
    for f in ("theta", "lam", "z_prev"):
        for g, w in zip(tree_leaves(getattr(got, f)),
                        jax.tree.leaves(getattr(want, f)), strict=True):
            np.testing.assert_allclose(g, np.asarray(w), err_msg=f,
                                       rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(float(m.train_loss), float(wm.train_loss),
                               rtol=1e-5)
    np.testing.assert_array_equal(got.rng, np.asarray(want.rng))

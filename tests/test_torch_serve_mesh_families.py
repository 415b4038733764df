"""Tensor-parallel serving for every family on the CPU: the serving
steps of ``launch/steps.py`` in modes tp, fsdp_tp and ep
(``sharding/serve.py``) against the port's unsharded prefill and decode.

* The reduced zamba2 (hybrid: its mamba layers and the shared block),
  mamba2 (ssm), moonshot and mixtral (moe; mixtral's window of 16 on a
  ring cache), paligemma (vlm, its prefix) and granite (dense), each in
  the three modes on ``make_test_mesh`` (1, 4) and (2, 2): a prefill and
  4 greedy decode steps against the unsharded port at ``PORT_TOL``
  (1e-5), each coordinate holding ``per_device_bytes`` of the
  parameters, and the cache put back together (``gather_tree``) equal
  to the unsharded one — its SSM state and conv ring in
  ``cache_specs``' layout, its k / v with each shard's kv heads (ROADMAP
  D14: where a shard takes one kv head per query head, the gathered
  cache holds kv head q // (H / KvH) at query head q).  The executor
  adds the partial sums of out_proj, wo and w_down and the norm's sums
  of squares in shard order, not in the unsharded product's order, so
  the logits agree to ~2e-6 rather than bit for bit.
* The bytes of each collective kind in a prefill and a decode step of
  mamba2, and in moonshot's prefill under the hidden cut (tp) and the
  expert cut (ep), against the formulas of ``sharding/serve.py``'s
  docstring.
* In bf16 a row-parallel product's partials stay fp32 until they are
  added and rounded once (ROADMAP D15): the reduced mamba2's and
  zamba2's tp prefill is as far from their fp32 prefill as the
  unsharded bf16 prefill is.
* Refusals: a cut the executor cannot serve names the leaf and its
  spec; an unknown mode lists the four; the audio family does not
  serve.
* tests/test_torch_serve_mesh_families_reference.py holds the same
  steps against the reference's own sharded steps.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.kernels import ops
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.launch.steps import make_decode_step, make_prefill_step
from repro_torch.models import abstract_params, build_model
from repro_torch.sharding import specs
from repro_torch.sharding.clients import collectives
from repro_torch.models.layers import matmul_fp32
from repro_torch.sharding.params import all_reduce, gather_tree, \
    per_device_bytes, shard_tree, tree_bytes_at
from repro_torch.sharding.serve import SERVE_MODES, TpLayout
from repro_torch.utils.pytree import tree_leaves
from torch_threads import _one_torch_thread  # noqa: F401

PORT_TOL = dict(rtol=1e-5, atol=1e-5)
B, S, STEPS = 4, 12, 4
ARCHS = ("zamba2-2.7b", "mamba2-2.7b", "moonshot-v1-16b-a3b",
         "mixtral-8x7b", "paligemma-3b", "granite-3-2b")
TP_MODES = ("tp", "fsdp_tp", "ep")
MESHES = ((1, 4), (2, 2))


@pytest.fixture(autouse=True)
def _counts_stay_zero():
    ops.reset_launch_counts()
    yield
    assert ops.launch_counts() == {k: 0 for k in ops.KERNELS}, \
        "a CPU tensor must never reach a kernel launch"


_UNSHARDED = {}


def _unsharded(arch):
    """The reduced model on seed-0 weights, a request (the vlm's with its
    patches), its cache length, and the unsharded port's prefill and
    greedy decode: logits per step, tokens, the final cache; once per
    architecture."""
    if arch not in _UNSHARDED:
        cfg = get_config(arch).reduced()
        model = build_model(cfg)
        params = model.init(0, device="cpu")
        rng = np.random.default_rng(3)
        batch = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                                         (B, S)))}
        if cfg.family == "vlm":
            batch["patches"] = torch.from_numpy(rng.normal(size=(
                B, cfg.prefix_tokens, cfg.frontend_dim)).astype(np.float32))
        seq = 16 + 8 + cfg.prefix_tokens * (cfg.family == "vlm")
        with torch.no_grad():
            logits, cache = model.prefill(params, batch, seq)
            want, greedy = [logits], []
            for _ in range(STEPS):
                greedy.append(logits[:, -1].argmax(-1)[:, None])
                logits, cache = model.decode_step(params, greedy[-1], cache)
                want.append(logits)
        _UNSHARDED[arch] = dict(cfg=cfg, model=model, params=params,
                                batch=batch, seq=seq, want=want,
                                greedy=greedy, cache=cache)
    return _UNSHARDED[arch]


def _serve(u, mesh, mode, steps=STEPS):
    """Prefill and ``steps`` of the greedy tokens through the mesh steps
    → (logits per step, the cache, the sharded parameters, the prefill's
    MeshArgs, the bytes each collective kind moved in the prefill and in
    each decode step)."""
    pre, pargs = make_prefill_step(u["model"], mesh, batch=B, seq=u["seq"],
                                   mode=mode)
    dec, dargs = make_decode_step(u["model"], mesh, batch=B, seq=u["seq"],
                                  mode=mode)
    sharded = shard_tree(u["params"], pargs.in_specs[0], mesh)
    batch = shard_tree(u["batch"], pargs.in_specs[1], mesh)
    moved = [{}]

    def count(kind, t):
        moved[-1][kind] = moved[-1].get(kind, 0) + t.numel() * t.element_size()

    tokens = [shard_tree(t, dargs.in_specs[1], mesh)
              for t in u["greedy"][:steps]]
    collectives.listeners.append(count)
    try:
        logits, cache = pre(sharded, batch)
        out = [logits]
        for tok in tokens:
            moved.append({})
            logits, cache = dec(sharded, tok, cache)
            out.append(logits)
    finally:
        collectives.listeners.remove(count)
    return out, cache, sharded, pargs, moved


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("mode", TP_MODES)
@pytest.mark.parametrize("arch", ARCHS)
def test_every_family_serves_in_every_mode(arch, mode, mesh):
    u = _unsharded(arch)
    cfg, m = u["cfg"], make_test_mesh(mesh)
    got, cache, sharded, pargs, _ = _serve(u, m, mode)
    assert len(got) == STEPS + 1
    for g, w in zip(got, u["want"], strict=True):
        assert g.shape == (B, 1, cfg.vocab_size)
        torch.testing.assert_close(g, w, **PORT_TOL)
    p_abs = abstract_params(u["model"])
    expect = per_device_bytes(p_abs, pargs.in_specs[0], m)
    assert [tree_bytes_at(sharded, c) for c in m.coords()] == \
        [expect] * m.size
    lay = TpLayout(cfg, pargs.in_specs[0], m)
    want = dict(u["cache"])
    if "k" in want and lay.take is not None:  # one kv head a query head
        g = cfg.num_heads // cfg.num_kv_heads
        heads = [q // g for q in range(cfg.num_heads)]
        want = dict(want, k=want["k"][:, :, :, heads],
                    v=want["v"][:, :, :, heads])
    back = gather_tree(cache)
    assert back.keys() == want.keys() and back["pos"] == S + STEPS \
        + cfg.prefix_tokens * (cfg.family == "vlm")
    for key in want:
        if key != "pos":
            for a, b in zip(tree_leaves(back[key]), tree_leaves(want[key]),
                            strict=True):
                torch.testing.assert_close(a, b, **PORT_TOL)
    if "k" in cache.specs:
        assert cache.specs["k"] == (None, "data", None, "model", None)
    if "layers" in cache.specs:
        assert cache.specs["layers"] == pargs.out_specs[1]["layers"]
        assert cache.specs["layers"]["ssm"][2] == "model"


def test_the_layouts_the_specs_give():
    """What the executor reads off the specs: moonshot's experts cut on
    their hidden and output columns under tp and fsdp_tp and on E under
    ep; mamba2's 16 heads as 4 a shard on (1, 4); paligemma's one kv head
    split over column blocks; zamba2's full-size shared block with 8 of
    its 32 kv heads a shard."""
    m = make_test_mesh((1, 4))
    moon = build_model(get_config("moonshot-v1-16b-a3b").reduced())
    for mode, kind in (("tp", "hidden"), ("fsdp_tp", "hidden"),
                       ("ep", "experts")):
        sp = specs.param_specs(abstract_params(moon), m, mode=mode)
        assert TpLayout(moon.config, sp, m).moe == kind
    mamba = build_model(get_config("mamba2-2.7b").reduced())
    lay = TpLayout(mamba.config, specs.param_specs(
        abstract_params(mamba), m, mode="tp"), m)
    assert lay.ssm_heads == 4 and lay.ssm_range(1) == range(4, 8)
    pali = build_model(get_config("paligemma-3b").reduced())
    lay = TpLayout(pali.config, specs.param_specs(
        abstract_params(pali), m, mode="ep"), m)
    assert lay.source == "column" and lay.take == [[0]] * 4
    zamba = build_model(get_config("zamba2-2.7b"))
    lay = TpLayout(zamba.config, specs.param_specs(
        abstract_params(zamba), m, mode="tp"), m)
    assert (lay.heads, lay.kv_heads, lay.source, lay.ssm_heads) == \
        (8, 8, "own", 20)


def _gathers(m, *elems):
    """Bytes of an all-gather of fp32 blocks of ``elems`` elements each
    (the whole's) over m shards."""
    return sum(m * (m - 1) * n // m * 4 for n in elems)


def test_mamba_collectives_move_the_docstrings_bytes():
    """mamba2 on (1, 4) under tp: the prefill and a decode step move what
    ``sharding/serve.py``'s docstring says, kind by kind."""
    u = _unsharded("mamba2-2.7b")
    cfg, m = u["cfg"], 4
    _, _, _, _, moved = _serve(u, make_test_mesh((1, 4)), "tp", steps=2)
    d_in = cfg.expand * cfg.d_model
    p_in = 2 * d_in + 2 * cfg.ssm_state + d_in // cfg.ssm_head_dim
    conv = d_in + 2 * cfg.ssm_state
    for s, got in ((S, moved[0]), (1, moved[1])):
        gather = (_gathers(m, B * s * cfg.d_model)
                  + (m - 1) * B * cfg.vocab_padded // m * 4
                  + cfg.num_layers * _gathers(m, B * s * p_in))
        if s == 1:  # the ring, cut on its channels, gathered each step
            gather += cfg.num_layers * _gathers(
                m, B * (cfg.conv_kernel - 1) * conv)
        reduce = cfg.num_layers * 2 * (m - 1) * (B * s * 4
                                                 + B * s * cfg.d_model * 4)
        assert got == {"all-gather": gather, "all-reduce": reduce}, s


@pytest.mark.parametrize("mode", ["tp", "ep"])
def test_moe_collectives_move_the_docstrings_bytes(mode):
    """moonshot's prefill on (1, 4): under tp the hidden blocks (B, E,
    C, f/M) and the combined columns (B, S, d/M) are gathered a layer,
    under ep the experts' outputs (B, E/M, C, d); the attention's k and
    v column blocks (one kv head split over two shards) and its output's
    all-reduce as the dense family's."""
    u = _unsharded("moonshot-v1-16b-a3b")
    cfg, m = u["cfg"], 4
    _, _, _, _, moved = _serve(u, make_test_mesh((1, 4)), mode, steps=0)
    from repro_torch.models.moe import capacity
    cap = capacity(S, cfg.top_k, cfg.num_experts, cfg.capacity_factor)
    act = B * S * cfg.d_model
    kv = B * S * cfg.num_kv_heads * cfg.head_dim
    moe = (_gathers(m, B * cfg.num_experts * cap * cfg.d_ff, act)
           if mode == "tp" else
           _gathers(m, B * cfg.num_experts * cap * cfg.d_model))
    gather = (_gathers(m, act) + (m - 1) * B * cfg.vocab_padded // m * 4
              + cfg.num_layers * (2 * _gathers(m, kv) + moe))
    reduce = cfg.num_layers * 2 * (m - 1) * act * 4
    assert moved[0] == {"all-gather": gather, "all-reduce": reduce}


def test_fsdp_tp_gathers_the_data_cut_leaves_before_their_layer():
    """On (2, 2) under fsdp_tp every leaf the specs cut over data is
    gathered over it each time its layer runs: the prefill moves more
    than tp's by exactly those gathers (each data shard's model shards
    take the other data shard's blocks of every such leaf once)."""
    u = _unsharded("mamba2-2.7b")
    m = make_test_mesh((2, 2))
    moved = {mode: _serve(u, m, mode, steps=0)[4][0]
             for mode in ("tp", "fsdp_tp")}
    sp = specs.param_specs(u["params"], m, mode="fsdp_tp")
    data_cut = 0
    for x, s in zip(tree_leaves(u["params"]), tree_leaves(sp), strict=True):
        if "data" in s:
            parts = 2 * (2 if "model" in s else 1)
            # each of 2 data shards × 2 model shards takes 1 block
            data_cut += 2 * 2 * x.numel() * 4 // parts
    assert moved["fsdp_tp"]["all-reduce"] == moved["tp"]["all-reduce"]
    assert moved["fsdp_tp"]["all-gather"] == \
        moved["tp"]["all-gather"] + data_cut


def test_row_parallel_partials_are_fp32_until_summed():
    gen = torch.Generator().manual_seed(0)
    x = torch.randn((3, 5, 16), generator=gen).to(torch.bfloat16)
    w = torch.randn((16, 8), generator=gen).to(torch.bfloat16)
    parts = [matmul_fp32(x[..., 4 * j:4 * (j + 1)], w[4 * j:4 * (j + 1)])
             for j in range(4)]
    assert all(p.dtype == torch.float32 for p in parts)
    assert torch.equal(parts[0], x[..., :4].float() @ w[:4].float())
    got = all_reduce(parts, ["cpu"] * 4, dtype=torch.bfloat16)
    want = (((parts[0] + parts[1]) + parts[2]) + parts[3]).to(torch.bfloat16)
    assert all(torch.equal(g, want) for g in got)
    xf = torch.randn((2, 3), generator=gen)
    assert torch.equal(matmul_fp32(xf, w.float()[:3]), xf @ w.float()[:3])


@pytest.mark.parametrize("arch", ["mamba2-2.7b", "zamba2-2.7b"])
def test_bf16_tp_is_as_close_to_fp32_as_the_unsharded(arch):
    """The reduced model in bf16 (6 mamba layers; zamba2's in 4 groups),
    4 × 64 tokens, on (1, 4) under tp: its prefill logits' largest gap
    to the same weights' fp32 prefill within 1.25× the unsharded bf16
    prefill's (the two bf16 runs round differently, ~0.01–0.02 apart, so
    their own gap is no gate)."""
    from repro_torch.utils.pytree import tree_map
    layers = 8 if arch.startswith("zamba") else 6
    cfg = get_config(arch).reduced(dtype="bfloat16", num_layers=layers)
    model = build_model(cfg)
    params = model.init(0, device="cpu")
    tokens = {"tokens": torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (B, 64)))}
    with torch.no_grad():
        bf16, _ = model.prefill(params, tokens, 64)
        f32 = build_model(dataclasses.replace(cfg, dtype="float32"))
        ref, _ = f32.prefill(tree_map(lambda x: x.float(), params), tokens,
                             64)
    m = make_test_mesh((1, 4))
    pre, pargs = make_prefill_step(model, m, batch=B, seq=64, mode="tp")
    tp, _ = pre(shard_tree(params, pargs.in_specs[0], m),
                shard_tree(tokens, pargs.in_specs[1], m))
    assert tp.dtype == torch.float32 and not torch.equal(tp, bf16)
    assert float((tp - ref).abs().max()) <= 1.25 * float(
        (bf16 - ref).abs().max())


def test_a_cut_the_executor_cannot_serve_names_its_leaf():
    m = make_test_mesh((1, 4))
    moon = build_model(get_config("moonshot-v1-16b-a3b").reduced())
    sp = specs.param_specs(abstract_params(moon), m, mode="tp")
    sp["layers"]["moe"]["w_down"] = (None, "model", None, None)
    with pytest.raises(ValueError, match="layers/moe/w_down is cut as"):
        TpLayout(moon.config, sp, m)
    sp = specs.param_specs(abstract_params(moon), m, mode="tp")
    sp["final_ln"] = ("model",)
    with pytest.raises(ValueError, match="final_ln is cut as .*no model "
                       "cut"):
        TpLayout(moon.config, sp, m)
    sp = specs.param_specs(abstract_params(moon), m, mode="tp")
    sp["layers"]["attn"]["wo"] = (None, None, "model")
    with pytest.raises(ValueError, match=r"layers/attn/wo is cut as \(None"
                       r", None, 'model'\): tp needs wo cut on its rows"):
        TpLayout(moon.config, sp, m)


def test_mamba_heads_that_do_not_split_are_refused():
    """2 mamba heads of 128 on a model axis of 4: in_proj's 544 columns
    and out_proj's 256 rows split, the heads do not."""
    cfg = get_config("mamba2-2.7b").reduced(ssm_head_dim=128, ssm_state=15)
    model = build_model(cfg)
    m = make_test_mesh((1, 4))
    sp = specs.param_specs(abstract_params(model), m, mode="tp")
    assert sp["layers"]["ssm"]["in_proj"] == (None, None, "model")
    with pytest.raises(ValueError, match="2 mamba heads do not split over a "
                       "model axis of 4 .*out_proj is cut as"):
        make_prefill_step(model, m, batch=2, seq=8, mode="tp")


@pytest.mark.parametrize("mode", TP_MODES)
def test_query_heads_that_do_not_split_are_refused(mode):
    # 3 heads of 32 over 4 shards of 24 columns: the shards straddle 1
    # and 2 heads, no span of one width (6 would straddle 2 each, served)
    cfg = dataclasses.replace(get_config("zamba2-2.7b").reduced(),
                              num_heads=3, num_kv_heads=1)
    with pytest.raises(ValueError, match="3 query heads of 32 do not split "
                       "over a model axis of 4 in spans of one width "
                       ".*shared/attn/wq is cut as"):
        make_decode_step(build_model(cfg), make_test_mesh((1, 4)), batch=2,
                         seq=8, mode=mode)


def test_an_unknown_mode_lists_the_four_and_audio_is_not_served():
    model = build_model(get_config("zamba2-2.7b").reduced())
    assert SERVE_MODES == ("fsdp", "tp", "fsdp_tp", "ep")
    with pytest.raises(ValueError, match="fsdp, tp, fsdp_tp, ep"):
        make_prefill_step(model, make_test_mesh((1, 4)), batch=2, seq=8,
                          mode="megatron")
    hubert = build_model(get_config("hubert-xlarge").reduced())
    for mode in SERVE_MODES:
        with pytest.raises(ValueError):
            make_prefill_step(hubert, make_test_mesh((1, 4)), batch=2,
                              seq=8, mode=mode)


@pytest.mark.parametrize("arch,mode", [("paligemma-3b", "fsdp_tp"),
                                       ("moonshot-v1-16b-a3b", "ep")])
def test_profile_serve_runs_every_mode(arch, mode, capsys):
    from repro_torch.launch import profile_serve
    profile_serve.main(["--arch", arch, "--reduced", "--device", "cpu",
                        "--batch", "2", "--prompt-len", "8",
                        "--decode-steps", "1", "--mesh", "2,2", "--mode",
                        mode])
    out = capsys.readouterr().out
    assert f"mesh 2,2 {mode}, on cpu" in out
    assert "decode step (per call, 1 calls)" in out

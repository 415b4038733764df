"""The model mesh of the port against the JAX package, on the CPU:
``launch/mesh.py``, the sharding rules (``sharding/specs.py``), their
placement (``sharding/params.py``) and the serving steps on a data ×
model mesh in ``fsdp`` and ``tp`` mode (``launch/steps.py``,
``sharding/serve.py``).

* The rules are pure functions: for every name in
  ``configs.ARCHITECTURES``, every mode and the fake meshes {data 16,
  model 16}, {2, 2} and {1, 4} (a ``FakeMesh``, as
  tests/test_distributed.py has), the port's specs equal the
  reference's ``PartitionSpec``\\ s element by element, and
  ``per_device_bytes`` the bytes those specs imply.
* ``shard_tree`` then ``gather_tree`` gives the tree back bit for bit.
* The reduced granite served on CPU meshes (2, 2) and (1, 4) in both
  modes — (1, 4) puts one query head on each model shard, whose kv head
  is split over two shards' column blocks, so each shard takes the
  whole kv head it needs — against the port's unsharded prefill and 4
  greedy decode steps at rtol/atol 1e-5 (fsdp gathers the weights and
  runs the unsharded block, tp sums row-parallel partials in another
  order), and against the JAX package's unsharded ``prefill`` /
  ``decode_step`` (jitted, computed once for the module) at the logits
  grade, rtol/atol 2e-4.  The specs' row-parallel GQA fallback and a
  replicated wk run against the unsharded port at 1e-5.
* The other serving families under fsdp against the unsharded port
  (tp, fsdp_tp and ep on them: tests/test_torch_serve_mesh_families.py).
* tests/test_torch_model_mesh_reference.py runs the reference's own
  sharded prefill on 4 forced host devices.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.configs import ARCHITECTURES as JAX_ARCHITECTURES
from repro.configs import get_config as jax_get_config
from repro.models.api import abstract_params as jax_abstract_params
from repro.models.api import build_model as jax_build_model
from repro.sharding import specs as jspecs
from repro_torch.configs import ARCHITECTURES, get_config
from repro_torch.convert import lm_params_from_numpy
from repro_torch.kernels import ops
from repro_torch.launch.mesh import DeviceMesh, make_mesh, \
    make_production_mesh, make_test_mesh
from repro_torch.launch.steps import MeshArgs, make_decode_step, \
    make_mesh_serve_steps, make_prefill_step
from repro_torch.models import abstract_cache, abstract_params, build_model
from repro_torch.sharding.serve import TpLayout, data_shards
from repro_torch.sharding import specs
from repro_torch.sharding.clients import collectives
from repro_torch.sharding.params import ShardedTree, gather_tree, \
    per_device_bytes, shard_tree, tree_bytes_at
from repro_torch.utils.pytree import tree_leaves, tree_map
from torch_threads import _one_torch_thread  # noqa: F401

PORT_TOL = dict(rtol=1e-5, atol=1e-5)
JAX_TOL = dict(rtol=2e-4, atol=2e-4)
MODES = ("fsdp", "tp", "fsdp_tp", "ep")
FAKE_MESHES = {"16x16": {"data": 16, "model": 16},
               "2x2": {"data": 2, "model": 2},
               "1x4": {"data": 1, "model": 4}}
B, S, MAX_SEQ, STEPS = 4, 12, 16, 4


class FakeMesh:
    def __init__(self, shape):
        self.shape = shape


@pytest.fixture(autouse=True)
def _counts_stay_zero():
    ops.reset_launch_counts()
    yield
    assert ops.launch_counts() == {k: 0 for k in ops.KERNELS}, \
        "a CPU tensor must never reach a kernel launch"


def test_the_architectures_are_the_references():
    assert tuple(ARCHITECTURES) == tuple(JAX_ARCHITECTURES)


# ----------------------------------------------------------------------
# the rules
# ----------------------------------------------------------------------


_SHAPES = {}


def _shapes(arch):
    """(the reference's abstract params, the port's meta params), once
    per architecture."""
    if arch not in _SHAPES:
        _SHAPES[arch] = (
            jax_abstract_params(jax_build_model(jax_get_config(arch))),
            abstract_params(build_model(get_config(arch))))
    return _SHAPES[arch]


def _jax_by_path(tree):
    """{path of dict keys: leaf} of a JAX tree (PartitionSpecs as
    leaves)."""
    flat = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, P))[0]
    return {tuple(str(k.key) for k in path): leaf for path, leaf in flat}


def _port_by_path(tree, path=()):
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_port_by_path(tree[k], path + (k,)))
        return out
    return {path: tree}


def _assert_specs_equal(got, want):
    got, want = _port_by_path(got), _jax_by_path(want)
    assert got.keys() == want.keys()
    for path, w in want.items():
        assert got[path] == tuple(w), (path, got[path], w)


@pytest.mark.parametrize("mesh", FAKE_MESHES)
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("arch", ARCHITECTURES)
def test_param_specs_are_the_references(arch, mode, mesh):
    jshapes, shapes = _shapes(arch)
    fake = FakeMesh(FAKE_MESHES[mesh])
    _assert_specs_equal(specs.param_specs(shapes, fake, mode=mode),
                        jspecs.param_specs(jshapes, fake, mode=mode))


@pytest.mark.parametrize("mesh", FAKE_MESHES)
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("arch", ARCHITECTURES)
def test_per_device_bytes_are_the_references_specs(arch, mode, mesh):
    """The bytes a coordinate holds: each leaf's bytes over the product
    of the mesh sizes its reference spec names."""
    jshapes, shapes = _shapes(arch)
    fake = FakeMesh(FAKE_MESHES[mesh])
    jsp = jspecs.param_specs(jshapes, fake, mode=mode)
    want = 0
    for leaf, spec in zip(jax.tree.leaves(jshapes), jax.tree.leaves(
            jsp, is_leaf=lambda x: isinstance(x, P)), strict=True):
        parts = 1
        for entry in spec:
            for a in ((entry,) if isinstance(entry, str) else entry or ()):
                parts *= fake.shape[a]
        nbytes = int(np.prod(leaf.shape)) * leaf.dtype.itemsize
        assert nbytes % parts == 0
        want += nbytes // parts
    assert per_device_bytes(
        shapes, specs.param_specs(shapes, fake, mode=mode), fake) == want


@pytest.mark.parametrize("mesh", list(FAKE_MESHES) + ["pod"])
@pytest.mark.parametrize("arch", ARCHITECTURES)
def test_pod_batch_and_cache_specs_are_the_references(arch, mesh):
    """``pod_stacked_specs`` of the fsdp specs, ``batch_specs`` of the
    train and prefill batches and ``cache_specs`` of the serving cache
    at 2080 and 4096 positions; on the pod mesh over ("pod", "data")."""
    jcfg, cfg = jax_get_config(arch), get_config(arch)
    jshapes, shapes = _shapes(arch)
    shape = {"pod": 2, "data": 16, "model": 16} if mesh == "pod" \
        else FAKE_MESHES[mesh]
    fake = FakeMesh(shape)
    baxes = ("pod", "data") if mesh == "pod" else "data"
    _assert_specs_equal(
        specs.pod_stacked_specs(specs.param_specs(shapes, fake)),
        jspecs.pod_stacked_specs(jspecs.param_specs(jshapes, fake)))
    from repro.models.api import input_specs as jax_input_specs
    from repro_torch.models import input_specs
    for mode in ("train", "prefill"):
        _assert_specs_equal(
            specs.batch_specs(input_specs(cfg, mode=mode, batch=32,
                                          seq=512), batch_axes=baxes),
            jspecs.batch_specs(jax_input_specs(jcfg, mode=mode, batch=32,
                                               seq=512), batch_axes=baxes))
    if not cfg.supports_decode:
        return
    jmodel, model = jax_build_model(jcfg), build_model(cfg)
    for seq in (2080, 4096):
        jcache = jax.eval_shape(lambda s=seq: jmodel.init_cache(32, s))
        got = specs.cache_specs(abstract_cache(model, 32, seq), fake,
                                batch_axes=baxes)
        _assert_specs_equal(got, jspecs.cache_specs(jcache, fake,
                                                    batch_axes=baxes))


def test_the_rules_keep_their_comments_true():
    """The leading layer axis is never cut; phi3's kv=10 projections
    (kv·head_dim 1280) take the output dim on model 2 and stay whole on
    model 3, which divides neither 1280 nor d_model 5120; a kv·head_dim
    of 18 on model 4 falls back to the input dim (the GQA fallback);
    MoE experts are cut on their last dim under tp; embed on d, lm_head
    on the vocabulary."""
    _, shapes = _shapes("granite_3_2b")
    for mode in MODES:
        sp = specs.param_specs(shapes, FakeMesh({"data": 16, "model": 16}),
                               mode=mode)
        for s in tree_leaves(sp["layers"]):
            assert not s or s[0] is None
        assert sp["embed"] == (None, "model")
        assert sp["lm_head"] == (None, "model")
    phi3 = abstract_params(build_model(get_config("phi3-medium-14b")))
    assert specs.param_specs(phi3, FakeMesh({"data": 1, "model": 2}),
                             mode="tp")["layers"]["attn"]["wk"] == \
        (None, None, "model")
    assert specs.param_specs(phi3, FakeMesh({"data": 1, "model": 3}),
                             mode="tp")["layers"]["attn"]["wk"] == \
        (None, None, None)
    odd = abstract_params(build_model(get_config("granite-3-2b").reduced(
        num_kv_heads=1, head_dim=18)))
    assert specs.param_specs(odd, FakeMesh({"data": 1, "model": 4}),
                             mode="tp")["layers"]["attn"]["wk"] == \
        (None, "model", None)
    _, moe = _shapes("mixtral_8x7b")
    sp = specs.param_specs(moe, FakeMesh({"data": 16, "model": 16}),
                           mode="tp")
    assert sp["layers"]["moe"]["w_down"][-1] == "model"
    with pytest.raises(ValueError, match="unknown mode"):
        specs.param_specs(shapes, FakeMesh({"data": 1, "model": 1}),
                          mode="zero")


# ----------------------------------------------------------------------
# the mesh and placement
# ----------------------------------------------------------------------


def test_meshes():
    mesh = make_test_mesh((2, 2))
    assert mesh.shape == {"data": 2, "model": 2}
    assert mesh.coords() == [(0, 0), (0, 1), (1, 0), (1, 1)]
    assert [mesh.index(c) for c in mesh.coords()] == [0, 1, 2, 3]
    assert all(d == torch.device("cpu") for d in mesh.devices)
    assert data_shards(mesh, ("data",)) == [[(0, 0), (0, 1)],
                                            [(1, 0), (1, 1)]]
    with pytest.raises(ValueError, match="batch axes"):
        data_shards(make_test_mesh((2, 2, 2), ("pod", "data", "model")),
                    ("data",))
    prod = make_production_mesh(devices=["meta"])
    assert prod.shape == {"data": 16, "model": 16} and prod.size == 256
    multi = make_production_mesh(multi_pod=True, devices=["meta"])
    assert multi.axis_names == ("pod", "data", "model") and \
        multi.size == 512
    two = make_test_mesh((1, 4), devices=["cpu", "meta"])
    assert [d.type for d in two.devices] == ["cpu", "meta", "cpu", "meta"]
    with pytest.raises(ValueError):
        DeviceMesh(("data",), (2,), (torch.device("cpu"),))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            make_mesh((2, 2))


@pytest.mark.parametrize("mesh", [(2, 2), (1, 4), (4, 1)])
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("arch", ["granite-3-2b", "zamba2-2.7b",
                                  "moonshot-v1-16b-a3b"])
def test_shard_then_gather_gives_the_tree_back(arch, mode, mesh):
    """Bit for bit; every block owns its storage; each coordinate holds
    ``per_device_bytes``."""
    model = build_model(get_config(arch).reduced())
    params = model.init(0, device="cpu")
    m = make_test_mesh(mesh)
    sp = specs.param_specs(params, m, mode=mode)
    sharded = shard_tree(params, sp, m)
    back = gather_tree(sharded)
    for got, want in zip(tree_leaves(back), tree_leaves(params),
                         strict=True):
        assert torch.equal(got, want)
    whole = {x.untyped_storage().data_ptr() for x in tree_leaves(params)}
    for c in m.coords():
        for x in tree_leaves(sharded.at(c)):
            assert x.untyped_storage().data_ptr() not in whole
        assert tree_bytes_at(sharded, c) == per_device_bytes(params, sp, m)


def test_a_cache_on_a_pod_mesh_goes_back_whole():
    """A cache cut over ("pod", "data") and model, put back together
    whole and, with ``keep``, as one data shard's block."""
    model = build_model(get_config("zamba2-2.7b").reduced())
    cache = model.init_cache(8, 16, device="cpu")
    gen = torch.Generator().manual_seed(0)
    cache = tree_map(lambda x: torch.randn(x.shape, generator=gen)
                     if isinstance(x, torch.Tensor) else 7, cache)
    mesh = make_test_mesh((2, 2, 2), ("pod", "data", "model"))
    cs = specs.cache_specs(cache, mesh, batch_axes=("pod", "data"))
    sharded = shard_tree(cache, cs, mesh)
    back = gather_tree(sharded)
    assert back["pos"] == 7
    for got, want in zip(tree_leaves(back), tree_leaves(cache),
                         strict=True):
        if isinstance(want, torch.Tensor):
            assert torch.equal(got, want)
    block = gather_tree(sharded, at=(1, 0, 0), keep=("pod", "data"))
    assert torch.equal(block["k"], cache["k"][:, 4:6])


# ----------------------------------------------------------------------
# serving the reduced granite
# ----------------------------------------------------------------------


@pytest.fixture(scope="module")
def granite():
    """The reduced granite of both packages on the reference's seed-0
    weights; the JAX package's prefill and greedy decode (jitted) and
    the port's unsharded ones, on one prompt."""
    jcfg = jax_get_config("granite-3-2b").reduced()
    cfg = get_config("granite-3-2b").reduced()
    jmodel, model = jax_build_model(jcfg), build_model(cfg)
    jparams = jax.device_get(jax.jit(jmodel.init)(jax.random.PRNGKey(0)))
    params = lm_params_from_numpy(jparams, cfg, device="cpu")
    tokens = np.random.default_rng(7).integers(0, cfg.vocab_size, (B, S))
    prefill = jax.jit(lambda p, t: jmodel.prefill(p, {"tokens": t},
                                                  MAX_SEQ))
    step = jax.jit(jmodel.decode_step)
    logits, jcache = prefill(jparams, jnp.asarray(tokens, jnp.int32))
    jax_logits, greedy = [np.asarray(logits)], []
    for _ in range(STEPS):
        tok = np.array(jnp.argmax(logits[:, -1], -1))[:, None]
        greedy.append(tok)
        logits, jcache = step(jparams, jnp.asarray(tok, jnp.int32), jcache)
        jax_logits.append(np.asarray(logits))
    port_logits = []
    with torch.no_grad():
        lg, cache = model.prefill(params, {"tokens": torch.from_numpy(
            tokens)}, MAX_SEQ)
        port_logits.append(lg)
        for tok in greedy:
            lg, cache = model.decode_step(params, torch.from_numpy(tok),
                                          cache)
            port_logits.append(lg)
    return dict(cfg=cfg, model=model, jparams=jparams, params=params,
                tokens=tokens, greedy=greedy, jax_logits=jax_logits,
                port_logits=port_logits)


def _serve_on_mesh(model, params, tokens, greedy, mesh, mode, jparams=None):
    """Prefill and the greedy decode steps through the mesh steps →
    (logits per step, the prefill's cache ShardedTree, the bytes each
    collective kind moved in the prefill)."""
    pre, pargs = make_prefill_step(model, mesh, batch=B, seq=MAX_SEQ,
                                   mode=mode)
    dec, dargs = make_decode_step(model, mesh, batch=B, seq=MAX_SEQ,
                                  mode=mode)
    if jparams is not None:
        sharded = lm_params_from_numpy(jparams, model.config, mesh=mesh,
                                       specs=pargs.in_specs[0])
    else:
        sharded = shard_tree(params, pargs.in_specs[0], mesh)
    batch = shard_tree({"tokens": torch.from_numpy(tokens)},
                       pargs.in_specs[1], mesh)
    moved = {}

    def count(kind, t):
        moved[kind] = moved.get(kind, 0) + t.numel() * t.element_size()

    collectives.listeners.append(count)
    try:
        logits, cache = pre(sharded, batch)
    finally:
        collectives.listeners.remove(count)
    out = [logits]
    for tok in greedy:
        logits, cache = dec(sharded, shard_tree(
            torch.from_numpy(tok), dargs.in_specs[1], mesh), cache)
        out.append(logits)
    return out, cache, moved


@pytest.mark.parametrize("mesh", [(2, 2), (1, 4)])
@pytest.mark.parametrize("mode", ["fsdp", "tp"])
def test_granite_on_a_mesh_matches_the_port_and_jax(granite, mode, mesh):
    m = make_test_mesh(mesh)
    got, cache, _ = _serve_on_mesh(
        granite["model"], granite["params"], granite["tokens"],
        granite["greedy"], m, mode, jparams=granite["jparams"])
    assert len(got) == STEPS + 1
    for g, p, j in zip(got, granite["port_logits"], granite["jax_logits"],
                       strict=True):
        assert g.shape == (B, 1, granite["cfg"].vocab_size)
        torch.testing.assert_close(g, p, **PORT_TOL)
        np.testing.assert_allclose(g.numpy(), j, **JAX_TOL)
    assert all(b["pos"] == S + STEPS for b in cache.blocks)


def test_the_fsdp_cache_follows_cache_specs(granite):
    """Under fsdp the prefill's cache is cut by ``cache_specs`` (the
    sequence over model at 16 positions) and goes back to the unsharded
    prefill's cache bit for bit."""
    model, params = granite["model"], granite["params"]
    mesh = make_test_mesh((2, 2))
    pre, pargs = make_prefill_step(model, mesh, batch=B, seq=MAX_SEQ)
    logits, cache = pre(shard_tree(params, pargs.in_specs[0], mesh),
                        shard_tree({"tokens": torch.from_numpy(
                            granite["tokens"])}, pargs.in_specs[1], mesh))
    assert cache.specs == pargs.out_specs[1]
    assert cache.specs["k"] == (None, "data", "model", None, None)
    _, want = model.prefill(params, {"tokens": torch.from_numpy(
        granite["tokens"])}, MAX_SEQ)
    back = gather_tree(cache)
    for key in ("k", "v"):
        assert torch.equal(back[key], want[key])
    assert cache.at((1, 1))["k"].shape == (2, 2, 8, 2, 32)


def test_the_tp_cache_keeps_each_shards_kv_heads(granite):
    """Under tp on (2, 2) each model shard's cache holds its own kv
    head (ROADMAP D14), which go back to the unsharded cache; on (1, 4)
    each shard holds the kv head of its one query head."""
    model, params = granite["model"], granite["params"]
    tokens = {"tokens": torch.from_numpy(granite["tokens"])}
    _, want = model.prefill(params, tokens, MAX_SEQ)
    for shape, heads in (((2, 2), 1), ((1, 4), 1)):
        mesh = make_test_mesh(shape)
        pre, pargs = make_prefill_step(model, mesh, batch=B, seq=MAX_SEQ,
                                       mode="tp")
        _, cache = pre(shard_tree(params, pargs.in_specs[0], mesh),
                       shard_tree(tokens, pargs.in_specs[1], mesh))
        assert cache.specs["k"] == (None, "data", None, "model", None)
        assert cache.blocks[0]["k"].shape[3] == heads
        back = gather_tree(cache)
        if shape == (2, 2):
            torch.testing.assert_close(back["k"], want["k"], **PORT_TOL)
        else:  # query head j takes kv head j // 2
            torch.testing.assert_close(back["k"], want["k"][:, :, :, [
                0, 0, 1, 1]], **PORT_TOL)


@pytest.mark.parametrize("kw,mesh,source", [
    (dict(num_kv_heads=1, head_dim=18), (1, 4), "row"),
    (dict(num_heads=3, num_kv_heads=1, d_ff=252), (1, 3), "whole"),
    (dict(num_heads=8, num_kv_heads=2, head_dim=16), (2, 4), "column")])
def test_tp_takes_kv_heads_from_any_wk_layout(kw, mesh, source):
    """wk / wv cut on their input dim (the specs' GQA fallback: 18 does
    not split over 4), replicated (a model axis of 3 divides neither
    dim; the embedding and the head stay whole too), or in column
    blocks that split a kv head: each shard gets the kv heads its query
    heads need, one per query head, against the unsharded port."""
    cfg = get_config("granite-3-2b").reduced(**kw)
    model = build_model(cfg)
    params = model.init(0, device="cpu")
    tokens = np.random.default_rng(1).integers(0, cfg.vocab_size, (B, S))
    m = make_test_mesh(mesh)
    lay = TpLayout(cfg, specs.param_specs(params, m, mode="tp"), m)
    assert lay.source == source and lay.kv_heads == lay.heads
    greedy, want = [], []
    with torch.no_grad():
        lg, cache = model.prefill(params, {"tokens": torch.from_numpy(
            tokens)}, MAX_SEQ)
        want.append(lg)
        for _ in range(2):
            tok = lg[:, -1].argmax(-1)[:, None]
            greedy.append(tok.numpy())
            lg, cache = model.decode_step(params, tok, cache)
            want.append(lg)
    got, _, _ = _serve_on_mesh(model, params, tokens, greedy, m, "tp")
    for g, w in zip(got, want, strict=True):
        torch.testing.assert_close(g, w, **PORT_TOL)


def test_tp_collectives_move_the_bytes_megatron_moves(granite):
    """Per tp prefill on (1, 4): two all-reduces a layer of (B, S, d)
    fp32 — the three partials to shard 0 and the sum back to three
    shards —; all-gathers: the embedding's rows to each shard (three of
    its four blocks each), the kv heads' column blocks (wk and wv, each
    shard three blocks a layer) and the vocabulary slices (three);
    nothing else moves but the batch's scatter."""
    cfg = granite["cfg"]
    _, _, moved = _serve_on_mesh(
        granite["model"], granite["params"], granite["tokens"], [],
        make_test_mesh((1, 4)), "tp")
    m, act = 4, B * S * cfg.d_model * 4
    kv_cols = B * S * cfg.num_kv_heads * cfg.head_dim * 4 // m
    assert moved["all-reduce"] == cfg.num_layers * 2 * 2 * (m - 1) * act
    assert moved["all-gather"] == (
        m * (m - 1) * act // m
        + cfg.num_layers * 2 * m * (m - 1) * kv_cols
        + (m - 1) * B * cfg.vocab_padded * 4 // m)
    assert set(moved) == {"all-reduce", "all-gather"}


def test_the_mesh_steps_carry_the_specs_and_refuse_others(granite):
    model, params = granite["model"], granite["params"]
    mesh = make_test_mesh((2, 2))
    pre, pargs = make_prefill_step(model, mesh, batch=B, seq=MAX_SEQ,
                                   mode="tp")
    assert isinstance(pargs, MeshArgs) and len(pargs) == 2
    p_abs = abstract_params(model)
    assert pargs.in_specs[0] == specs.param_specs(p_abs, mesh, mode="tp")
    assert pargs.out_specs[1] == specs.cache_specs(
        abstract_cache(model, B, MAX_SEQ), mesh, batch_axes="data")
    _, dargs = make_decode_step(model, mesh, batch=B, seq=MAX_SEQ)
    assert dargs.in_specs[1] == ("data", None) and len(dargs) == 3
    fsdp = shard_tree(params, specs.param_specs(params, mesh), mesh)
    batch = shard_tree({"tokens": torch.from_numpy(granite["tokens"])},
                       pargs.in_specs[1], mesh)
    with pytest.raises(ValueError, match="param_specs"):
        pre(fsdp, batch)
    with pytest.raises(ValueError, match="does not split"):
        make_prefill_step(model, mesh, batch=3, seq=MAX_SEQ)
    with pytest.raises(ValueError, match="modes"):
        make_prefill_step(model, mesh, batch=B, seq=MAX_SEQ, mode="zero")
    step, args = make_prefill_step(model, batch=B, seq=MAX_SEQ)
    assert type(args) is tuple and len(args) == 2


@pytest.mark.parametrize("mode", ["fsdp", "tp"])
def test_the_plain_input_steps_serve_as_the_sharded_ones(granite, mode):
    """make_mesh_serve_steps cuts whole batches and tokens as the
    steps' in_specs say: its logits equal the ShardedTree steps'."""
    model, mesh = granite["model"], make_test_mesh((2, 2))
    want, _, _ = _serve_on_mesh(model, granite["params"], granite["tokens"],
                                granite["greedy"], mesh, mode)
    prefill, decode, pargs = make_mesh_serve_steps(
        model, mesh, batch=B, seq=MAX_SEQ, mode=mode)
    assert pargs.in_specs[0] == specs.param_specs(
        abstract_params(model), mesh, mode=mode)
    sharded = shard_tree(granite["params"], pargs.in_specs[0], mesh)
    logits, cache = prefill(sharded, {"tokens": torch.from_numpy(
        granite["tokens"])})
    got = [logits]
    for tok in granite["greedy"]:
        logits, cache = decode(sharded, torch.from_numpy(tok), cache)
        got.append(logits)
    for g, w in zip(got, want, strict=True):
        assert torch.equal(g, w)


def test_profile_serve_runs_on_a_mesh(capsys):
    from repro_torch.launch import profile_serve
    profile_serve.main(["--arch", "granite-3-2b", "--reduced", "--device",
                        "cpu", "--batch", "2", "--prompt-len", "16",
                        "--decode-steps", "2", "--mesh", "2,2", "--mode",
                        "tp"])
    out = capsys.readouterr().out
    assert "mesh 2,2 tp, on cpu" in out
    assert "prefill (per call, 1 calls)" in out
    assert "decode step (per call, 2 calls)" in out


def test_lm_params_from_numpy_shards_the_references_weights(granite):
    mesh = make_test_mesh((1, 4))
    sp = specs.param_specs(granite["params"], mesh, mode="tp")
    got = lm_params_from_numpy(granite["jparams"], granite["cfg"],
                               mesh=mesh, specs=sp)
    want = shard_tree(granite["params"], sp, mesh)
    assert isinstance(got, ShardedTree) and got.specs == sp
    for g, w in zip(got.blocks, want.blocks, strict=True):
        for a, b in zip(tree_leaves(g), tree_leaves(w), strict=True):
            assert torch.equal(a, b)
    with pytest.raises(ValueError, match="specs"):
        lm_params_from_numpy(granite["jparams"], granite["cfg"], mesh=mesh)


# ----------------------------------------------------------------------
# the other serving families
# ----------------------------------------------------------------------


FSDP_ARCHS = ("zamba2-2.7b", "mamba2-2.7b", "phi3-medium-14b",
              "moonshot-v1-16b-a3b", "mixtral-8x7b", "paligemma-3b")


@pytest.mark.parametrize("mesh", [(2, 2), (1, 4)])
@pytest.mark.parametrize("arch", FSDP_ARCHS)
def test_fsdp_serves_every_family_as_the_unsharded_port(arch, mesh):
    """Prefill and 4 greedy decode steps on the mesh (zamba2's hybrid
    stack and shared block, mamba2's ssm cache, moonshot's and
    mixtral's MoE — mixtral's window of 16 on a ring cache —,
    paligemma's patches) against the unsharded port at 1e-5."""
    cfg = get_config(arch).reduced()
    model = build_model(cfg)
    params = model.init(0, device="cpu")
    rng = np.random.default_rng(3)
    batch = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                                     (B, S)))}
    if cfg.family == "vlm":
        batch["patches"] = torch.from_numpy(rng.normal(size=(
            B, cfg.prefix_tokens, cfg.frontend_dim)).astype(np.float32))
    seq = MAX_SEQ + 8 + cfg.prefix_tokens * (cfg.family == "vlm")
    m = make_test_mesh(mesh)
    pre, pargs = make_prefill_step(model, m, batch=B, seq=seq)
    dec, dargs = make_decode_step(model, m, batch=B, seq=seq)
    sharded = shard_tree(params, pargs.in_specs[0], m)
    with torch.no_grad():
        want, cache = model.prefill(params, batch, seq)
    got, mcache = pre(sharded, shard_tree(batch, pargs.in_specs[1], m))
    torch.testing.assert_close(got, want, **PORT_TOL)
    for _ in range(STEPS):
        tok = want[:, -1].argmax(-1)[:, None]
        with torch.no_grad():
            want, cache = model.decode_step(params, tok, cache)
        got, mcache = dec(sharded, shard_tree(tok, dargs.in_specs[1], m),
                          mcache)
        torch.testing.assert_close(got, want, **PORT_TOL)
    back = gather_tree(mcache)
    for g, w in zip(tree_leaves(back), tree_leaves(cache), strict=True):
        if isinstance(w, torch.Tensor):
            torch.testing.assert_close(g, w, **PORT_TOL)


def test_tp_needs_the_query_heads_to_split():
    # heads that straddle the shards in spans of one width are served
    # (tests/test_torch_tp_heads.py); 3 of 32 over 4 shards are not
    cfg = dataclasses.replace(get_config("granite-3-2b").reduced(),
                              num_heads=3, num_kv_heads=1)
    with pytest.raises(ValueError, match="query heads"):
        make_prefill_step(build_model(cfg), make_test_mesh((1, 4)), batch=2,
                          seq=8, mode="tp")

"""Query heads that straddle the model shards' column blocks of wq.

The sharding rules cut wq on its columns wherever H·hd splits over the
model axis, also where the H heads do not (phi3-medium-14b's 40 and
paligemma-3b's 8 on the reference's axis of 16): a shard's columns then
straddle heads.  The tp executor (``sharding/serve.py::TpLayout``)
gathers the shards' q columns, each shard attends over the heads its
columns touch and keeps its own columns of their output for its rows of
wo.  Held here on CPU meshes of 4 model shards against the unsharded
port in fp32: prefill and decode logits, the training step's loss,
first moment and bytes by collective kind (``step_bytes``).
"""
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.launch.serve_lm import cache_len, make_request
from repro_torch.launch.steps import make_mesh_serve_steps, \
    make_train_step
from repro_torch.models import build_model
from repro_torch.models.api import abstract_params, input_specs
from repro_torch.optim.adam import adam_init
from repro_torch.sharding.clients import collectives
from repro_torch.sharding.params import ShardedTree, gather_tree, \
    shard_tree
from repro_torch.sharding.serve import TpLayout
from repro_torch.sharding.specs import param_specs
from repro_torch.sharding.train import step_bytes
from repro_torch.utils.pytree import tree_leaves
from torch_threads import _one_torch_thread  # noqa: F401

# heads that do not split over 4 model shards, H·hd that does
STRADDLED = {
    "granite-3-2b": dict(num_heads=6, num_kv_heads=2, head_dim=16,
                         d_model=96),
    "paligemma-3b": dict(num_heads=2, num_kv_heads=1),
    "zamba2-2.7b": dict(num_heads=6, num_kv_heads=6, head_dim=16),
}
MESHES = (("tp", (1, 4)), ("fsdp_tp", (2, 4)))
B, S, NEW = 2, 16, 4


def _cfg(arch):
    return get_config(arch).reduced(dtype="float32", **STRADDLED[arch])


@pytest.mark.parametrize("arch,heads,model,spans", [
    ("phi3-medium-14b", 3, 16, [(0, 3), (2, 5), (5, 8), (7, 10)]),
    ("paligemma-3b", 1, 16, [(0, 1), (0, 1), (1, 2), (1, 2)])])
def test_the_references_widths_take_the_heads_they_straddle(arch, heads,
                                                           model, spans):
    from repro_torch.launch.mesh import make_production_mesh

    cfg = get_config(arch)
    mesh = make_production_mesh(devices=["meta"])
    assert cfg.num_heads % model and mesh.shape["model"] == model
    for mode in ("tp", "fsdp_tp"):
        lay = TpLayout(cfg, param_specs(abstract_params(build_model(cfg)),
                                        mesh, mode=mode), mesh)
        assert lay.heads == lay.kv_heads == heads
        assert lay.q_spans[:4] == spans and len(lay.q_spans) == model
        assert lay.cols == cfg.num_heads * cfg.head_dim // model


@pytest.mark.parametrize("mode,shape", MESHES)
@pytest.mark.parametrize("arch", STRADDLED)
def test_serving_with_straddled_heads(arch, mode, shape):
    cfg = _cfg(arch)
    model = build_model(cfg)
    params = model.init(0, device="cpu")
    req = make_request(cfg, B, S, 0, "cpu")
    seq = cache_len(cfg, S, NEW)
    want, cache = model.prefill(params, req, seq)
    token = want[:, -1].argmax(-1)[:, None]
    want_next, _ = model.decode_step(params, token, cache)
    mesh = make_test_mesh(shape)
    prefill, decode, pargs = make_mesh_serve_steps(model, mesh, batch=B,
                                                   seq=seq, mode=mode)
    assert TpLayout(cfg, pargs.in_specs[0], mesh).q_spans
    sharded = shard_tree(params, pargs.in_specs[0], mesh)
    got, got_cache = prefill(sharded, req)
    torch.testing.assert_close(got, want, rtol=2e-4, atol=2e-4)
    got_next, _ = decode(sharded, token, got_cache)
    torch.testing.assert_close(got_next, want_next, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("mode,shape", MESHES)
@pytest.mark.parametrize("arch", STRADDLED)
def test_training_with_straddled_heads(arch, mode, shape):
    cfg = _cfg(arch)
    model = build_model(cfg)
    params = model.init(0, device="cpu")
    gen = torch.Generator().manual_seed(1)
    batch = {k: torch.randint(0, cfg.vocab_size, tuple(v.shape),
                              generator=gen) if v.dtype == torch.int64
             else torch.randn(tuple(v.shape), generator=gen)
             for k, v in input_specs(cfg, mode="train", batch=B,
                                     seq=S).items()}
    step, _ = make_train_step(model, batch=B, seq=S)
    _, want_opt, want_loss = step(params, adam_init(params), params, batch)
    mesh = make_test_mesh(shape)
    mstep, args = make_train_step(model, mesh, batch=B, seq=S, mode=mode)
    sp = shard_tree(params, args.in_specs[0], mesh)
    so = ShardedTree(tuple(adam_init(b) for b in sp.blocks),
                     args.in_specs[1], mesh)
    sb = shard_tree(batch, args.in_specs[3], mesh)
    moved = {}

    def count(kind, t):
        moved[kind] = moved.get(kind, 0) + t.numel() * t.element_size()

    collectives.listeners.append(count)
    try:
        _, opt, loss = mstep(sp, so, sp, sb)
    finally:
        collectives.listeners.remove(count)
    torch.testing.assert_close(loss, want_loss, rtol=1e-5, atol=0)
    mu = gather_tree(ShardedTree(tuple(o.mu for o in opt.blocks),
                                 args.in_specs[0], mesh))
    for a, b in zip(tree_leaves(mu), tree_leaves(want_opt.mu), strict=True):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-7)
    assert moved == {k: v for k, v in step_bytes(
        cfg, args[0], args.in_specs[0], mesh, mode, batch=B,
        seq=S).items() if v}

"""The training step on a model mesh in modes tp, fsdp_tp and ep
(``sharding/train.py``'s tp executor) and the MoE family on a data axis
above 1, against the port's unsharded step, on the CPU.

* Every family (granite, mamba2, zamba2, moonshot, paligemma, hubert
  ``.reduced()``) on (1, 4) tp and (2, 2) fsdp_tp, moonshot also on
  (1, 4) ep and (2, 2) fsdp, with grad_accum 1 and 2: the loss at rtol
  1e-5, the first moment within 1e-5 of each leaf's largest magnitude
  (+ 1e-9; the shards' partial products add the same fp32 terms in
  another order, ~1e-6 of a leaf's scale; an element that cancels to
  near 0 takes that absolute gap), the parameters at the solve grade
  where the gradient is firm and within 2·lr elsewhere, the step count
  1.
* A leaf the specs replicate over the model axis (the norms) takes the
  sum of the model shards' gradients: one shard's is off.
* The MoE's load-balance loss on two data shards is the whole batch's,
  in value and in gradient (aux_coef 1, so that it moves the router).
* Bytes by collective kind equal ``step_bytes``' formula, with and
  without remat and a chunked loss, in every mode and family.
* Each coordinate holds ``per_device_bytes`` of the parameters.
* ``matmul_fp32``'s backward is autograd of the widened product;
  ``all_reduce`` and ``all_gather`` under autograd report their
  backward's copies as ``"all-reduce"`` and ``"reduce-scatter"``.
* Refusals name the four modes, or the leaf and its spec.
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.kernels import ops
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.launch.steps import make_train_step
from repro_torch.models import build_model
from repro_torch.models.api import abstract_params
from repro_torch.models.layers import matmul_fp32
from repro_torch.models.moe import load_balance
from repro_torch.models.transformer import loss_fn, loss_terms
from repro_torch.optim.adam import adam_init
from repro_torch.sharding import train as mesh_train
from repro_torch.sharding.clients import collectives
from repro_torch.sharding.params import ShardedTree, all_gather, \
    all_reduce, gather_tree, per_device_bytes, shard_tree, tree_bytes_at
from repro_torch.sharding.serve import data_shards
from repro_torch.sharding.specs import param_specs
from repro_torch.sharding.train import _microbatches, \
    make_train_step_on_mesh, step_bytes, train_layout, value_and_grad
from repro_torch.utils.pytree import tree_leaves, tree_map
from torch_threads import _one_torch_thread  # noqa: F401

B, SEQ, RHO, LR = 4, 16, 1e-2, 1e-3
ARCHS = ("granite-3-2b", "mamba2-2.7b", "zamba2-2.7b",
         "moonshot-v1-16b-a3b", "paligemma-3b", "hubert-xlarge")
CASES = [(a, m, s) for a in ARCHS
         for m, s in (("tp", (1, 4)), ("fsdp_tp", (2, 2)))] + [
    ("moonshot-v1-16b-a3b", "ep", (1, 4)),
    ("moonshot-v1-16b-a3b", "fsdp", (2, 2))]


@pytest.fixture(autouse=True)
def _counts_stay_zero():
    ops.reset_launch_counts()
    yield
    assert ops.launch_counts() == {k: 0 for k in ops.KERNELS}


def _inputs(cfg, seed=0):
    """Parameters, a centre 0.01·N(0, 1) off them and a batch, on the
    CPU, made with numpy from seeds."""
    model = build_model(cfg)
    params = model.init(seed, device="cpu")
    rng = np.random.default_rng(2)
    center = tree_map(lambda x: x + 0.01 * torch.from_numpy(rng.normal(
        size=tuple(x.shape)).astype(np.float32)), params)
    rng = np.random.default_rng(9)
    if cfg.family == "audio":
        labels = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, SEQ)))
        labels[:, ::3] = -100
        return model, params, center, {
            "features": torch.from_numpy(rng.normal(
                size=(B, SEQ, cfg.frontend_dim)).astype(np.float32)),
            "labels": labels}
    text = SEQ - cfg.prefix_tokens
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, text + 1)))
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if cfg.family == "vlm":
        batch["patches"] = torch.from_numpy(rng.normal(size=(
            B, cfg.prefix_tokens, cfg.frontend_dim)).astype(np.float32))
    return model, params, center, batch


def _steps(model, params, center, batch, shape, mode, grad_accum=1):
    """(the unsharded step's (params, opt, loss), the mesh step's, its
    MeshArgs), the mesh's trees gathered."""
    kw = dict(batch=B, seq=SEQ, rho=RHO, lr=LR, grad_accum=grad_accum)
    step, _ = make_train_step(model, **kw)
    one = step(params, adam_init(params), center, batch)
    mesh = make_test_mesh(shape)
    mstep, args = make_train_step(model, mesh, mode=mode, **kw)
    p, o, loss = mstep(*(shard_tree(x, s, mesh) for x, s in zip(
        (params, adam_init(params), center, batch), args.in_specs,
        strict=True)))
    assert p.specs == args.out_specs[0] and o.specs == args.out_specs[1]
    return one, (gather_tree(p), gather_tree(o), loss), args


def _leaf_grade(got, want):
    """Each leaf within 1e-5 of its largest magnitude (+ 1e-9)."""
    for g, w in zip(got, want, strict=True):
        scale = float(w.abs().max())
        torch.testing.assert_close(g, w, rtol=0, atol=1e-5 * scale + 1e-9)


@pytest.mark.parametrize("grad_accum", [1, 2])
@pytest.mark.parametrize("arch,mode,shape", CASES)
def test_mesh_step_against_the_unsharded_step(arch, mode, shape,
                                              grad_accum):
    model, params, center, batch = _inputs(get_config(arch).reduced())
    (p1, o1, l1), (p, o, loss), _ = _steps(model, params, center, batch,
                                           shape, mode, grad_accum)
    torch.testing.assert_close(loss, l1, rtol=1e-5, atol=0)
    _leaf_grade(tree_leaves(o.mu), tree_leaves(o1.mu))
    assert int(o.step) == 1
    # the parameters where the gradient is firm; elsewhere Adam's first
    # step moves a weight by ±lr·g/(|g| + ε) with the sign of a gradient
    # within its rounding of 0, so the two steps are within 2·lr
    for g, w, m in zip(tree_leaves(p), tree_leaves(p1), tree_leaves(o1.mu),
                       strict=True):
        firm = m.abs() > 1e-7
        torch.testing.assert_close(g[firm], w[firm], rtol=1e-4, atol=1e-6)
        assert float((g - w).abs().max()) <= 2 * LR * 1.0001


def test_a_model_replicated_leafs_gradient_is_the_sum_over_the_shards(
        monkeypatch):
    """granite on (1, 4) tp: the norms are replicated over the model
    axis and each shard's replica sees only the part of dh that flows
    through its own columns.  With the shards' gradients added the
    norms' first moments are the unsharded step's; with the first
    shard's taken for every replica they are far off."""
    model, params, center, batch = _inputs(
        get_config("granite-3-2b").reduced())
    (_, o1, _), (_, o, _), _ = _steps(model, params, center, batch, (1, 4),
                                      "tp")
    norms = [o.mu["final_ln"], o.mu["layers"]["ln1"], o.mu["layers"]["ln2"]]
    want = [o1.mu["final_ln"], o1.mu["layers"]["ln1"],
            o1.mu["layers"]["ln2"]]
    _leaf_grade(norms, want)

    def one_shard(params, grads):
        for k, spec in enumerate(tree_leaves(params.specs)):
            if "model" not in spec:
                for gs in grads[1:]:
                    gs[k] = grads[0][k]

    monkeypatch.setattr(mesh_train, "_sync_replicas", one_shard)
    (_, o1, _), (_, o, _), _ = _steps(model, params, center, batch, (1, 4),
                                      "tp")
    for g, w in zip([o.mu["final_ln"], o.mu["layers"]["ln1"],
                     o.mu["layers"]["ln2"]], want, strict=True):
        gap = float((g - w).abs().max()) / float(w.abs().max())
        assert gap > 1e-2, gap


@pytest.mark.parametrize("mode", ["fsdp", "fsdp_tp"])
def test_moe_aux_on_two_data_shards_is_the_whole_batchs(mode):
    """moonshot (aux_coef 1) on (2, 2): the shards' load statistics
    added give the whole batch's aux, and ``value_and_grad``'s loss and
    gradient are the unsharded loss's and gradient (each leaf within
    1e-5 of its largest magnitude); a data shard's own aux would be
    neither."""
    cfg = get_config("moonshot-v1-16b-a3b").reduced(aux_coef=1.0)
    model, params, _, batch = _inputs(cfg)
    _, _, aux = loss_terms(cfg, params, batch)
    halves = [tree_map(lambda x, i=i: x[2 * i:2 * i + 2], batch)
              for i in range(2)]
    stats = [loss_terms(cfg, params, h, True)[2] for h in halves]
    whole = load_balance(stats[0] + stats[1], B * SEQ)
    torch.testing.assert_close(whole, aux, rtol=1e-6, atol=0)
    own = load_balance(stats[0], B * SEQ // 2)
    assert abs(float(own) / float(aux) - 1) > 1e-4

    leaves = [x.detach().requires_grad_(True) for x in tree_leaves(params)]
    it = iter(leaves)
    live = tree_map(lambda _: next(it), params)
    want_loss = loss_fn(cfg, live, batch)
    want = torch.autograd.grad(want_loss, leaves)

    mesh = make_test_mesh((2, 2))
    pspec = param_specs(abstract_params(model), mesh, mode=mode)
    sharded = shard_tree(params, pspec, mesh)
    live = ShardedTree(tuple(
        tree_map(lambda p: p.detach().requires_grad_(True), b)
        for b in sharded.blocks), pspec, mesh)
    groups = data_shards(mesh, ("data",))
    lay = train_layout(cfg, pspec, mesh, mode)
    bspec = tree_map(lambda x: ("data",) + (None,) * (x.dim() - 1), batch)
    micro = _microbatches(shard_tree(batch, bspec, mesh), groups, 1,
                          lay is not None)
    loss, grads = value_and_grad(cfg, live, micro[0], groups, lay)
    torch.testing.assert_close(loss, want_loss.detach(), rtol=1e-6, atol=0)
    got = gather_tree(ShardedTree(tuple(
        mesh_train._build(sharded.blocks[0], g) for g in grads), pspec,
        mesh))
    _leaf_grade(tree_leaves(got), list(want))
    want = mesh_train._build(params, want)
    router = want["layers"]["moe"]["router"]
    assert float(router.abs().max()) > 0
    torch.testing.assert_close(got["layers"]["moe"]["router"], router,
                               rtol=0, atol=1e-5 * float(router.abs().max()))


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("mode,shape", [("tp", (1, 4)),
                                        ("fsdp_tp", (2, 2)),
                                        ("ep", (1, 4)), ("fsdp", (2, 2))])
@pytest.mark.parametrize("arch", ARCHS)
def test_collectives_move_the_formulas_bytes(arch, mode, shape, remat):
    """Bytes by kind over one step equal ``step_bytes``: under remat
    with the loss in chunks of 4, each group's recompute again (but for
    the collectives after its last saved tensor) and each chunk's."""
    over = dict(remat=True, loss_chunk=4) if remat else {}
    cfg = get_config(arch).reduced(**over)
    model, params, center, batch = _inputs(cfg)
    mesh = make_test_mesh(shape)
    step, args = make_train_step(model, mesh, batch=B, seq=SEQ, mode=mode)
    inputs = [shard_tree(x, s, mesh) for x, s in zip(
        (params, adam_init(params), center, batch), args.in_specs,
        strict=True)]
    seen: dict = {}

    def listen(kind, t):
        seen[kind] = seen.get(kind, 0) + t.numel() * t.element_size()

    collectives.listeners.append(listen)
    try:
        step(*inputs)
    finally:
        collectives.listeners.remove(listen)
    want = step_bytes(cfg, abstract_params(model), args.in_specs[0], mesh,
                      mode, batch=B, seq=SEQ)
    assert seen == {k: v for k, v in want.items() if v}
    if remat:
        plain = step_bytes(get_config(arch).reduced(),
                           abstract_params(model), args.in_specs[0], mesh,
                           mode, batch=B, seq=SEQ)
        assert want["all-gather"] > plain["all-gather"]


@pytest.mark.parametrize("mode", ["tp", "fsdp_tp", "ep"])
def test_each_coordinate_holds_per_device_bytes(mode):
    model, params, _, _ = _inputs(get_config("moonshot-v1-16b-a3b")
                                  .reduced())
    mesh = make_test_mesh((2, 2))
    pspec = param_specs(abstract_params(model), mesh, mode=mode)
    sharded = shard_tree(params, pspec, mesh)
    want = per_device_bytes(abstract_params(model), pspec, mesh)
    assert all(tree_bytes_at(sharded, c) == want for c in mesh.coords())


def test_matmul_fp32_backward_is_the_widened_products():
    gen = torch.Generator().manual_seed(3)
    x = torch.randn((2, 5, 16), generator=gen).to(torch.bfloat16)
    w = torch.randn((16, 8), generator=gen).to(torch.bfloat16)
    g = torch.randn((2, 5, 8), generator=gen)
    xs = [x.clone().requires_grad_(True) for _ in range(2)]
    ws = [w.clone().requires_grad_(True) for _ in range(2)]
    got = matmul_fp32(xs[0], ws[0])
    want = xs[1].to(torch.float32) @ ws[1].to(torch.float32)
    assert got.dtype == torch.float32 and torch.equal(got, want.detach())
    got.backward(g)
    want.backward(g)
    assert xs[0].grad.dtype == torch.bfloat16
    assert torch.equal(xs[0].grad, xs[1].grad)
    assert torch.equal(ws[0].grad, ws[1].grad)


def test_collectives_carry_gradients_and_report_the_backwards_copies():
    gen = torch.Generator().manual_seed(4)
    parts = [torch.randn((3, 4), generator=gen).requires_grad_(True)
             for _ in range(4)]
    seen: dict = {}

    def listen(kind, t):
        seen[kind] = seen.get(kind, 0) + t.numel() * t.element_size()

    collectives.listeners.append(listen)
    try:
        out = all_reduce(parts, ["cpu"] * 4)
        sum(o.sum() * (i + 1) for i, o in enumerate(out)).backward()
        assert all(float(p.grad.max()) == float(p.grad.min()) == 10.0
                   for p in parts)
        assert seen == {"all-reduce": 2 * (2 * 3 * 12 * 4)}
        seen.clear()
        blocks = [p.detach().clone().requires_grad_(True) for p in parts]
        out = all_gather(blocks, -1, ["cpu"] * 4)
        weight = torch.randn((3, 16), generator=gen)
        sum((o * weight).sum() * (i + 1) for i, o in enumerate(out)
            ).backward()
        for j, b in enumerate(blocks):
            assert torch.allclose(b.grad, 10 * weight[:, 4 * j:4 * j + 4])
        assert seen == {"all-gather": 12 * 48, "reduce-scatter": 12 * 48}
    finally:
        collectives.listeners.remove(listen)
    with torch.no_grad():
        same = all_reduce([p.detach() for p in parts], ["cpu"] * 4)
    assert all(x is same[0] for x in same)


def test_an_unknown_mode_lists_the_four():
    model = build_model(get_config("granite-3-2b").reduced())
    with pytest.raises(ValueError, match="fsdp, tp, fsdp_tp, ep"):
        make_train_step(model, make_test_mesh((2, 2)), batch=B, seq=SEQ,
                        mode="zero3")


def test_a_cut_the_executor_cannot_train_names_its_leaf():
    model = build_model(get_config("granite-3-2b").reduced())
    mesh = make_test_mesh((1, 4))
    pspec = param_specs(abstract_params(model), mesh, mode="tp")
    pspec["layers"]["ln1"] = (None, "model")
    specs = (pspec, mesh_train.adam_specs(pspec), pspec, None)
    with pytest.raises(ValueError, match="layers/ln1.*'model'"):
        make_train_step_on_mesh(model.config, mesh, specs, rho=RHO, lr=LR,
                                grad_accum=1, batch_axes=("data",),
                                mode="tp")

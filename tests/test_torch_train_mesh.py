"""The training step on a model mesh (``launch.steps.make_train_step``
with ``mesh=``; ``sharding/train.py``) against the unsharded step and
against the JAX package's jitted sharded step, on the CPU.

One subprocess forces 4 host devices before it imports ``jax`` and,
for the dense (granite), ssm (mamba2) and hybrid (zamba2) families
``.reduced()`` from their seed-0 inits, jits the reference's
``make_train_step(model, make_test_mesh((2, 2)), batch=4, seq=16,
grad_accum=g, rho=1e-2, lr=1e-3)`` with its ``in_shardings`` /
``out_shardings`` for g = 1 and 2, on a centre 0.01·N(0, 1) off the
parameters; it writes the inputs and the outputs to an npz and the
steps' shardings (built, not compiled) as JSON.

* The step's ``MeshArgs`` equal the reference's shardings' specs.
* Against the unsharded port: on (1, 2) (one data shard) the loss, the
  parameters and the AdamW state bit for bit; on (2, 2) the loss at
  rtol 1e-6, the first moment at rtol 1e-5 / atol 1e-9 and the
  parameters at the solve grade where the gradient is firm (Adam's
  first step moves a weight by lr·g/(|g| + ε), whose sign is not
  determined where |g| is within its rounding of 0; there within lr).
  The same on (2, 2) for the vlm and audio families, whose loss is a
  ratio over the text positions or the frames.
* Against the reference: the loss at rtol 2e-5, the first moment at
  the gradient grade (rtol 1e-4 / atol 1e-7), the parameters as above.
* The MoE family: on one data shard exact; on two (its load-balance
  loss from the data shards' load statistics added) at the (2, 2)
  grades above.  The other modes: tests/test_torch_train_tp*.py.
* The gradient's copies are reported as ``"reduce-scatter"``, and
  under ``remat`` backward gathers every layer again.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.convert import lm_params_from_numpy
from repro_torch.kernels import ops
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.launch.steps import make_train_step
from repro_torch.models import build_model
from repro_torch.optim.adam import adam_init
from repro_torch.sharding.clients import collectives
from repro_torch.sharding.params import gather_tree, shard_tree, _axes
from repro_torch.utils.pytree import is_record, tree_leaves, tree_map
from torch_threads import _one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, SEQ, RHO, LR = 4, 16, 1e-2, 1e-3
ARCHS = {"dense": "granite-3-2b", "ssm": "mamba2-2.7b",
         "hybrid": "zamba2-2.7b"}

_SCRIPT = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import json
import jax, jax.numpy as jnp, numpy as np
from repro.configs import get_config
from repro.launch.mesh import make_test_mesh
from repro.launch.steps import make_train_step
from repro.models.api import build_model
from repro.optim.adam import adam_init

B, SEQ, RHO, LR = %d, %d, %r, %r
ARCHS = %r
mesh = make_test_mesh((2, 2))
out, specs = {}, {}

def put(prefix, tree):
    for path, x in jax.tree_util.tree_flatten_with_path(tree)[0]:
        key = prefix + "".join(
            "/" + str(getattr(p, "key", getattr(p, "name", None))) for p in path)
        out[key] = np.asarray(x)

def listed(tree):
    return jax.tree.map(lambda s: [list(e) if isinstance(e, tuple) else e
                                   for e in s.spec], tree,
                        is_leaf=lambda x: hasattr(x, "spec"))

for family, arch in ARCHS.items():
    model = build_model(get_config(arch).reduced())
    cfg = model.config
    params = jax.device_get(jax.jit(model.init)(jax.random.PRNGKey(0)))
    rng = np.random.default_rng(2)
    center = jax.tree.map(lambda x: x + 0.01 * rng.normal(
        size=x.shape).astype(np.float32), params)
    toks = np.random.default_rng(9).integers(0, cfg.vocab_size,
                                             (B, SEQ + 1))
    batch = {"tokens": jnp.asarray(toks[:, :-1], jnp.int32),
             "labels": jnp.asarray(toks[:, 1:], jnp.int32)}
    put(f"{family}/params", params)
    put(f"{family}/center", center)
    for g in (1, 2):
        fn, in_sh, out_sh, _ = make_train_step(
            model, mesh, batch=B, seq=SEQ, grad_accum=g, rho=RHO, lr=LR)
        if family == "dense" and g == 1:
            specs = {"in_specs": listed(in_sh), "out_specs": listed(out_sh)}
        step = jax.jit(fn, in_shardings=in_sh, out_shardings=out_sh)
        p, opt, loss = step(jax.device_put(params, in_sh[0]),
                            jax.device_put(adam_init(params), in_sh[1]),
                            jax.device_put(center, in_sh[2]),
                            jax.device_put(batch, in_sh[3]))
        put(f"{family}/{g}/params", jax.device_get(p))
        put(f"{family}/{g}/mu", jax.device_get(opt.mu))
        out[f"{family}/{g}/loss"] = np.asarray(loss)
np.savez(sys.argv[1], **out)
print(json.dumps(specs))
""" % (B, SEQ, RHO, LR, ARCHS)


@pytest.fixture(autouse=True)
def _counts_stay_zero():
    ops.reset_launch_counts()
    yield
    assert ops.launch_counts() == {k: 0 for k in ops.KERNELS}


def _nest(flat: dict, prefix: str) -> dict:
    """The npz's ``prefix/a/b`` entries as a nested dict."""
    out: dict = {}
    n = len(prefix.split("/"))
    for key, v in flat.items():
        parts = key.split("/")
        if parts[:n] != prefix.split("/"):
            continue
        node = out
        for p in parts[n:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return out


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    path = tmp_path_factory.mktemp("train_mesh") / "ref.npz"
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", _SCRIPT, str(path)],
                         env=env, capture_output=True, text=True,
                         timeout=300, cwd=REPO)
    assert out.returncode == 0, out.stderr[-3000:]
    with np.load(path) as f:
        flat = dict(f)
    path.unlink()
    return flat, json.loads(out.stdout.strip().splitlines()[-1])


def _listed(tree):
    if isinstance(tree, dict):
        return {k: _listed(v) for k, v in tree.items()}
    if is_record(tree):
        return [_listed(x) for x in tree]
    if tree is None:
        return None
    return [list(e) if isinstance(e, tuple) else e for e in tree]


def _inputs(cfg, seed=0):
    """Parameters, a centre 0.01·N(0, 1) off them and a batch, on the
    CPU, made with numpy from seeds (the audio family's frames too)."""
    model = build_model(cfg)
    params = model.init(seed, device="cpu")
    rng = np.random.default_rng(2)
    center = tree_map(lambda x: x + 0.01 * torch.from_numpy(rng.normal(
        size=tuple(x.shape)).astype(np.float32)), params)
    rng = np.random.default_rng(9)
    if cfg.family == "audio":
        batch = {"features": torch.from_numpy(rng.normal(
            size=(B, SEQ, cfg.frontend_dim)).astype(np.float32)),
                 "labels": torch.from_numpy(rng.integers(
                     0, cfg.vocab_size, (B, SEQ)))}
        batch["labels"][:, ::3] = -100  # unmasked frames: no label
        return model, params, center, batch
    text = SEQ - cfg.prefix_tokens
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, text + 1)))
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if cfg.family == "vlm":
        batch["patches"] = torch.from_numpy(rng.normal(size=(
            B, cfg.prefix_tokens, cfg.frontend_dim)).astype(np.float32))
    return model, params, center, batch


def _mesh_step(model, params, center, batch, shape, grad_accum=1):
    mesh = make_test_mesh(shape)
    step, args = make_train_step(model, mesh, batch=B, seq=SEQ, rho=RHO,
                                 lr=LR, grad_accum=grad_accum)
    p, opt, loss = step(*(shard_tree(x, s, mesh) for x, s in zip(
        (params, adam_init(params), center, batch), args.in_specs,
        strict=True)))
    assert p.specs == args.out_specs[0] and opt.specs == args.out_specs[1]
    return gather_tree(p), gather_tree(opt), loss


def _unsharded_step(model, params, center, batch, grad_accum=1):
    step, _ = make_train_step(model, batch=B, seq=SEQ, rho=RHO, lr=LR,
                              grad_accum=grad_accum)
    return step(params, adam_init(params), center, batch)


def _held(params, mu, want_params, want_mu, mu_tol):
    """The first moment at ``mu_tol``; the parameters at the solve
    grade where the reference's gradient is firm, within lr elsewhere."""
    for g, w in zip(mu, want_mu, strict=True):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w), **mu_tol)
    for g, w, m in zip(params, want_params, want_mu, strict=True):
        g, w, firm = np.asarray(g), np.asarray(w), np.abs(np.asarray(m)) \
            > 1e-7
        np.testing.assert_allclose(g[firm], w[firm], rtol=1e-4, atol=1e-6)
        assert np.abs(g - w).max() <= LR * 1.0001


def test_the_steps_mesh_args_are_the_references_shardings(reference):
    _, want = reference
    model = build_model(get_config(ARCHS["dense"]).reduced())
    _, args = make_train_step(model, make_test_mesh((2, 2)), batch=B,
                              seq=SEQ)
    assert [_listed(s) for s in args.in_specs] == want["in_specs"]
    assert [_listed(s) for s in args.out_specs] == want["out_specs"]


@pytest.mark.parametrize("grad_accum", [1, 2])
@pytest.mark.parametrize("family", list(ARCHS))
def test_mesh_step_against_the_unsharded_step(family, grad_accum):
    model, params, center, batch = _inputs(
        get_config(ARCHS[family]).reduced())
    p1, o1, l1 = _unsharded_step(model, params, center, batch, grad_accum)
    p, o, loss = _mesh_step(model, params, center, batch, (1, 2),
                            grad_accum)
    assert torch.equal(loss, l1)
    for a, b in zip(tree_leaves(p) + tree_leaves(o),
                    tree_leaves(p1) + tree_leaves(o1), strict=True):
        assert torch.equal(a, b)
    p, o, loss = _mesh_step(model, params, center, batch, (2, 2),
                            grad_accum)
    torch.testing.assert_close(loss, l1, rtol=1e-6, atol=0)
    _held(tree_leaves(p), tree_leaves(o.mu), tree_leaves(p1),
          tree_leaves(o1.mu), dict(rtol=1e-5, atol=1e-9))
    assert int(o.step) == 1


@pytest.mark.parametrize("grad_accum", [1, 2])
@pytest.mark.parametrize("family", list(ARCHS))
def test_mesh_step_matches_the_references_sharded_step(reference, family,
                                                       grad_accum):
    flat, _ = reference
    cfg = get_config(ARCHS[family]).reduced()
    model = build_model(cfg)
    params = lm_params_from_numpy(_nest(flat, f"{family}/params"), cfg,
                                  device="cpu")
    center = lm_params_from_numpy(_nest(flat, f"{family}/center"), cfg,
                                  device="cpu")
    toks = np.random.default_rng(9).integers(0, cfg.vocab_size,
                                             (B, SEQ + 1))
    batch = {"tokens": torch.from_numpy(toks[:, :-1]),
             "labels": torch.from_numpy(toks[:, 1:])}
    p, o, loss = _mesh_step(model, params, center, batch, (2, 2),
                            grad_accum)
    g = f"{family}/{grad_accum}"
    np.testing.assert_allclose(float(loss), float(flat[f"{g}/loss"]),
                               rtol=2e-5)
    want_p = lm_params_from_numpy(_nest(flat, f"{g}/params"), cfg,
                                  device="cpu")
    want_mu = lm_params_from_numpy(_nest(flat, f"{g}/mu"), cfg,
                                   device="cpu")
    _held(tree_leaves(p), tree_leaves(o.mu), tree_leaves(want_p),
          tree_leaves(want_mu), dict(rtol=1e-4, atol=1e-7))


@pytest.mark.parametrize("arch", ["paligemma-3b", "hubert-xlarge"])
def test_ratio_losses_are_the_whole_batchs(arch):
    """The vlm's loss over the text positions and the audio family's
    over its labelled frames (a third unlabelled here): on two data
    shards the sums and counts are added, not the shards' means."""
    model, params, center, batch = _inputs(get_config(arch).reduced())
    p1, o1, l1 = _unsharded_step(model, params, center, batch)
    p, o, loss = _mesh_step(model, params, center, batch, (2, 2))
    torch.testing.assert_close(loss, l1, rtol=1e-6, atol=0)
    _held(tree_leaves(p), tree_leaves(o.mu), tree_leaves(p1),
          tree_leaves(o1.mu), dict(rtol=1e-5, atol=1e-9))


def test_moe_is_exact_on_one_data_shard_and_refused_on_two():
    """On one data shard bit for bit; on two (no longer refused) the
    whole batch's loss and gradient at the (2, 2) grades."""
    model, params, center, batch = _inputs(
        get_config("mixtral-8x7b").reduced())
    p1, o1, l1 = _unsharded_step(model, params, center, batch)
    p, o, loss = _mesh_step(model, params, center, batch, (1, 2))
    assert torch.equal(loss, l1)
    for a, b in zip(tree_leaves(p) + tree_leaves(o),
                    tree_leaves(p1) + tree_leaves(o1), strict=True):
        assert torch.equal(a, b)
    p, o, loss = _mesh_step(model, params, center, batch, (2, 2))
    torch.testing.assert_close(loss, l1, rtol=1e-6, atol=0)
    _held(tree_leaves(p), tree_leaves(o.mu), tree_leaves(p1),
          tree_leaves(o1.mu), dict(rtol=1e-5, atol=1e-9))


def _copied_bytes(cfg, shape=(2, 2)):
    model, params, center, batch = _inputs(cfg)
    mesh = make_test_mesh(shape)
    step, args = make_train_step(model, mesh, batch=B, seq=SEQ)
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
    return seen, args.in_specs[0], params, mesh


def _moved(x, spec, mesh) -> int:
    """Bytes a gather of ``x`` moves to one coordinate: every block of
    the axes that cut it but its own."""
    n = _parts(spec, mesh)
    return x.numel() * x.element_size() * (n - 1) // n


def test_gradient_copies_and_regathers_under_remat():
    cfg = get_config(ARCHS["dense"]).reduced()
    plain, pspec, params, mesh = _copied_bytes(cfg)
    remat, _, _, _ = _copied_bytes(cfg.reduced(remat=True))
    n_data = mesh.shape["data"]
    gathered = sum(_moved(x, s, mesh) for x, s in zip(
        tree_leaves(params), tree_leaves(pspec), strict=True))
    layers = sum(_moved(x, s, mesh) for x, s in zip(
        tree_leaves(params["layers"]), tree_leaves(pspec["layers"]),
        strict=True))
    # every leaf gathered once a data shard; under remat every layer
    # again in backward
    assert plain["all-gather"] == n_data * gathered
    assert remat["all-gather"] == plain["all-gather"] + n_data * layers
    # each data shard sends every other coordinate its share of each
    # leaf's gradient
    shares = sum(x.numel() * x.element_size() // _parts(s, mesh)
                 for x, s in zip(tree_leaves(params), tree_leaves(pspec),
                                 strict=True))
    assert plain["reduce-scatter"] == n_data * (mesh.size - 1) * shares
    assert remat["reduce-scatter"] == plain["reduce-scatter"]


def _parts(spec, mesh) -> int:
    """The number of blocks a leaf cut by ``spec`` is cut into."""
    n = 1
    for e in spec:
        for a in _axes(e):
            n *= mesh.shape[a]
    return n

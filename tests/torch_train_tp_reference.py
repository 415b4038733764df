"""The reference's jitted sharded training step in modes tp, fsdp_tp and
ep, and the helpers that hold the port's mesh step against it
(tests/test_torch_train_tp_reference_*.py, which split the cases so
that ``--dist loadfile`` runs them side by side).

One subprocess forces 8 host devices before it imports ``jax`` and, for
each case (a name of :data:`CONFIGS`: an architecture ``.reduced()``
with its overrides, from its seed-0 init; mode,
``make_test_mesh`` shape, grad_accum), jits the reference's
``make_train_step(model, mesh, batch=4, seq=32, mode=..., grad_accum=g,
rho=1e-2, lr=1e-3)`` with its ``in_shardings`` / ``out_shardings`` on a
centre 0.01·N(0, 1) off the parameters and a batch made with numpy from
seed 9 (the audio family's frames with a third of them unlabelled, the
vlm's patches and text).  It writes the inputs and the outputs to an npz
and each case's shardings as JSON.
"""
import json
import os
import subprocess
import sys

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.convert import lm_params_from_numpy
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.launch.steps import make_train_step
from repro_torch.models import build_model
from repro_torch.optim.adam import adam_init
from repro_torch.sharding.params import gather_tree, shard_tree
from repro_torch.utils.pytree import is_record, tree_leaves

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, SEQ, RHO, LR = 4, 32, 1e-2, 1e-3
IGNORE = -100
# name → (architecture, overrides of its reduced configuration); any
# other name is an architecture as it is.  These have query heads that
# straddle 4 model shards' column blocks of wq (granite and zamba2 with
# 6 heads, paligemma with 2: the port's TpLayout.q_spans)
CONFIGS = {
    "granite-3-2b/6-heads": ("granite-3-2b", dict(
        num_heads=6, num_kv_heads=2, head_dim=16, d_model=96)),
    "paligemma-3b/2-heads": ("paligemma-3b", dict(num_heads=2,
                                                  num_kv_heads=1)),
    "zamba2-2.7b/6-heads": ("zamba2-2.7b", dict(
        num_heads=6, num_kv_heads=6, head_dim=16)),
}


def config_of(name):
    """The reduced configuration a case's name stands for."""
    arch, kw = CONFIGS.get(name, (name, {}))
    return get_config(arch).reduced(**kw)

_SCRIPT = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import json
import jax, jax.numpy as jnp, numpy as np
from repro.configs import get_config
from repro.launch.mesh import make_test_mesh
from repro.launch.steps import make_train_step
from repro.models.api import build_model
from repro.optim.adam import adam_init

B, SEQ, RHO, LR, IGNORE = %d, %d, %r, %r, %d
CASES, CONFIGS = %r, %r
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

for arch in dict.fromkeys(c[0] for c in CASES):
    name, kw = CONFIGS.get(arch, (arch, {}))
    model = build_model(get_config(name).reduced(**kw))
    cfg = model.config
    params = jax.device_get(jax.jit(model.init)(jax.random.PRNGKey(0)))
    rng = np.random.default_rng(2)
    center = jax.tree.map(lambda x: x + 0.01 * rng.normal(
        size=x.shape).astype(np.float32), params)
    rng = np.random.default_rng(9)
    if cfg.family == "audio":
        labels = rng.integers(0, cfg.vocab_size, (B, SEQ))
        labels[:, ::3] = IGNORE
        batch = {"features": rng.normal(
            size=(B, SEQ, cfg.frontend_dim)).astype(np.float32),
                 "labels": labels.astype(np.int32)}
    else:
        text = SEQ - cfg.prefix_tokens
        toks = rng.integers(0, cfg.vocab_size, (B, text + 1))
        batch = {"tokens": toks[:, :-1].astype(np.int32),
                 "labels": toks[:, 1:].astype(np.int32)}
        if cfg.family == "vlm":
            batch["patches"] = rng.normal(size=(
                B, cfg.prefix_tokens, cfg.frontend_dim)).astype(np.float32)
    put(f"{arch}/params", params)
    put(f"{arch}/center", center)
    put(f"{arch}/batch", batch)
    for a, mode, shape, g in CASES:
        if a != arch:
            continue
        name = f"{arch}/{mode}/{shape[0]}x{shape[1]}/{g}"
        fn, in_sh, out_sh, _ = make_train_step(
            model, make_test_mesh(tuple(shape)), batch=B, seq=SEQ,
            mode=mode, grad_accum=g, rho=RHO, lr=LR)
        specs[name] = {"in_specs": listed(in_sh), "out_specs": listed(out_sh)}
        step = jax.jit(fn, in_shardings=in_sh, out_shardings=out_sh)
        p, opt, loss = step(jax.device_put(params, in_sh[0]),
                            jax.device_put(adam_init(params), in_sh[1]),
                            jax.device_put(center, in_sh[2]),
                            jax.device_put(jax.tree.map(jnp.asarray, batch),
                                           in_sh[3]))
        put(f"{name}/params", jax.device_get(p))
        put(f"{name}/mu", jax.device_get(opt.mu))
        out[f"{name}/loss"] = np.asarray(loss)
np.savez(sys.argv[1], **out)
print(json.dumps(specs))
"""


def case_name(arch, mode, shape, grad_accum):
    return f"{arch}/{mode}/{shape[0]}x{shape[1]}/{grad_accum}"


def run_reference(cases, path):
    """The reference's outputs of ``cases`` (arch, mode, mesh shape,
    grad_accum): (the npz's arrays by key, each case's shardings)."""
    script = _SCRIPT % (B, SEQ, RHO, LR, IGNORE,
                        [(a, m, list(s), g) for a, m, s, g in cases],
                        CONFIGS)
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", script, str(path)],
                         env=env, capture_output=True, text=True,
                         timeout=400, cwd=REPO)
    assert out.returncode == 0, out.stderr[-3000:]
    with np.load(path) as f:
        flat = dict(f)
    path.unlink()
    return flat, json.loads(out.stdout.strip().splitlines()[-1])


def nest(flat: dict, prefix: str) -> dict:
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


def listed(tree):
    """A spec tree as the reference's JSON gives it (records as lists,
    tuple entries as lists)."""
    if isinstance(tree, dict):
        return {k: listed(v) for k, v in tree.items()}
    if is_record(tree):
        return [listed(x) for x in tree]
    if tree is None:
        return None
    return [list(e) if isinstance(e, tuple) else e for e in tree]


def mesh_step(model, params, center, batch, shape, mode, grad_accum=1):
    """The port's mesh step on ``make_test_mesh(shape)`` → (params,
    AdamW state, gathered; the loss; the step's MeshArgs)."""
    mesh = make_test_mesh(shape)
    step, args = make_train_step(model, mesh, batch=B, seq=SEQ, rho=RHO,
                                 lr=LR, grad_accum=grad_accum, mode=mode)
    p, opt, loss = step(*(shard_tree(x, s, mesh) for x, s in zip(
        (params, adam_init(params), center, batch), args.in_specs,
        strict=True)))
    assert p.specs == args.out_specs[0] and opt.specs == args.out_specs[1]
    return gather_tree(p), gather_tree(opt), loss, args


def held(params, mu, want_params, want_mu, mu_tol):
    """The first moment at ``mu_tol``; the parameters at the solve grade
    where the gradient is firm, within lr elsewhere (Adam's first step
    moves a weight by lr·g/(|g| + ε), whose sign is not determined
    where |g| is within its rounding of 0)."""
    for g, w in zip(mu, want_mu, strict=True):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w), **mu_tol)
    for g, w, m in zip(params, want_params, want_mu, strict=True):
        g, w, firm = np.asarray(g), np.asarray(w), np.abs(np.asarray(m)) \
            > 1e-7
        np.testing.assert_allclose(g[firm], w[firm], rtol=1e-4, atol=1e-6)
        assert np.abs(g - w).max() <= LR * 1.0001


def check_case(reference, arch, mode, shape, grad_accum):
    """The port's mesh step against the reference's, from its inputs:
    the loss at rtol 2e-5, the first moment at rtol 1e-4 / atol 1e-7,
    the parameters as :func:`held` says, the shardings equal."""
    flat, specs = reference
    cfg = config_of(arch)
    model = build_model(cfg)
    params = lm_params_from_numpy(nest(flat, f"{arch}/params"), cfg,
                                  device="cpu")
    center = lm_params_from_numpy(nest(flat, f"{arch}/center"), cfg,
                                  device="cpu")
    batch = {k: torch.from_numpy(v).to(torch.int64 if v.dtype.kind == "i"
                                       else torch.float32)
             for k, v in nest(flat, f"{arch}/batch").items()}
    p, o, loss, args = mesh_step(model, params, center, batch, shape, mode,
                                 grad_accum)
    name = case_name(arch, mode, shape, grad_accum)
    want = specs[name]
    assert [listed(s) for s in args.in_specs] == want["in_specs"]
    assert [listed(s) for s in args.out_specs] == want["out_specs"]
    np.testing.assert_allclose(float(loss), float(flat[f"{name}/loss"]),
                               rtol=2e-5)
    want_p = lm_params_from_numpy(nest(flat, f"{name}/params"), cfg,
                                  device="cpu")
    want_mu = lm_params_from_numpy(nest(flat, f"{name}/mu"), cfg,
                                   device="cpu")
    held(tree_leaves(p), tree_leaves(o.mu), tree_leaves(want_p),
         tree_leaves(want_mu), dict(rtol=1e-4, atol=1e-7))
    assert int(o.step) == 1

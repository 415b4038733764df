"""The reference's own tensor-parallel serving steps against the port's,
on the CPU, for the families beyond the dense one.

One subprocess forces 8 host devices before it imports ``jax`` and runs
the JAX package's ``launch.steps.make_prefill_step(model, mesh,
mode=...)`` under ``jax.jit`` with its ``in_shardings`` /
``out_shardings`` for the reduced zamba2, mamba2, moonshot, mixtral and
paligemma in modes tp, fsdp_tp and ep on ``launch.mesh.make_test_mesh``
(1, 4) and (2, 2), and its ``make_decode_step`` on (1, 4) in tp and ep
for the four without mixtral, one greedy token (the reference's) against
the prefill's cache.  Three more reduced configurations have query heads
that straddle the model shards' column blocks of wq (granite and zamba2
with 6 heads, paligemma with 2, on 4 model shards: the port's
``sharding/serve.py::TpLayout.q_spans``; the reference's GSPMD shards
any head count): their prefill and decode in tp on (1, 4) and fsdp_tp on
(2, 4).  All on seed-0 weights (as
tests/test_torch_model_mesh_reference.py runs granite).  It prints the
logits and each step's specs.  The port's mesh steps on the same
weights, request, mesh shape and mode give those logits at the logits
grade (rtol/atol 2e-4); their ``MeshArgs.in_specs`` / ``out_specs``
equal the reference's shardings' specs element by element.  The cache a
port step returns keeps each shard's kv heads (ROADMAP D14); its
``out_specs`` say the reference's layout.
"""
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models.api import build_model as jax_build_model
from repro_torch.configs import get_config
from repro_torch.convert import lm_params_from_numpy
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.launch.steps import make_decode_step, make_prefill_step
from repro_torch.models import build_model
from repro_torch.sharding.params import shard_tree
from repro_torch.sharding.serve import TpLayout
from torch_threads import _one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, TEXT, SEQ = 4, 12, 16  # SEQ cache positions beyond a vlm's prefix
ARCHS = ("zamba2-2.7b", "mamba2-2.7b", "moonshot-v1-16b-a3b",
         "mixtral-8x7b", "paligemma-3b")
MODES = ("tp", "fsdp_tp", "ep")
# name → (architecture, overrides of its reduced configuration): the
# architectures above as they are, and query heads that do not split
# over 4 model shards where H·hd does
CONFIGS = {
    **{a: (a, {}) for a in ARCHS},
    "granite-3-2b/6-heads": ("granite-3-2b", dict(
        num_heads=6, num_kv_heads=2, head_dim=16, d_model=96)),
    "paligemma-3b/2-heads": ("paligemma-3b", dict(num_heads=2,
                                                  num_kv_heads=1)),
    "zamba2-2.7b/6-heads": ("zamba2-2.7b", dict(
        num_heads=6, num_kv_heads=6, head_dim=16)),
}
STRADDLED = [(n, m, s) for n in CONFIGS if "/" in n
             for m, s in (("tp", (1, 4)), ("fsdp_tp", (2, 4)))]
PREFILLS = [(a, m, s) for a in ARCHS for m in MODES
            for s in ((1, 4), (2, 2))] + STRADDLED
DECODES = [(a, m, (1, 4)) for a in ARCHS if a != "mixtral-8x7b"
           for m in ("tp", "ep")] + STRADDLED
TOL = dict(rtol=2e-4, atol=2e-4)

_SCRIPT = r"""
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import json
import jax, jax.numpy as jnp, numpy as np
from repro.configs import get_config
from repro.launch.mesh import make_test_mesh
from repro.launch.steps import make_decode_step, make_prefill_step
from repro.models.api import build_model

B, TEXT, SEQ = %d, %d, %d
CONFIGS, PREFILLS, DECODES = %r, %r, %r

def specs(tree):
    return jax.tree.map(lambda s: [list(e) if isinstance(e, tuple) else e
                                   for e in s.spec], tree,
                        is_leaf=lambda x: hasattr(x, "spec"))

out = {}
for arch in dict.fromkeys(a for a, _, _ in PREFILLS):
    name, kw = CONFIGS[arch]
    cfg = get_config(name).reduced(**kw)
    model = build_model(cfg)
    params = jax.jit(model.init)(jax.random.PRNGKey(0))
    rng = np.random.default_rng(11)
    batch = {"tokens": jnp.asarray(rng.integers(0, cfg.vocab_size,
                                                (B, TEXT)), jnp.int32)}
    seq = SEQ
    if cfg.family == "vlm":
        batch["patches"] = jnp.asarray(rng.normal(size=(
            B, cfg.prefix_tokens, cfg.frontend_dim)), jnp.float32)
        seq += cfg.prefix_tokens
    for a, mode, shape in PREFILLS:
        if a != arch:
            continue
        mesh = make_test_mesh(shape)
        fn, in_sh, out_sh, _ = make_prefill_step(model, mesh, batch=B,
                                                 seq=seq, mode=mode)
        placed = jax.device_put(params, in_sh[0])
        logits, cache = jax.jit(fn, in_shardings=in_sh,
                                out_shardings=out_sh)(placed, batch)
        key = f"{arch} {mode} {shape}"
        out[key] = dict(logits=np.asarray(logits).tolist(),
                        in_specs=specs(in_sh), cache_specs=specs(out_sh[1]))
        if (arch, mode, shape) not in DECODES:
            continue
        token = jnp.argmax(logits[:, -1], -1).astype(jnp.int32)[:, None]
        fn, in_sh, out_sh, _ = make_decode_step(model, mesh, batch=B,
                                                seq=seq, mode=mode)
        logits, _ = jax.jit(fn, in_shardings=in_sh, out_shardings=out_sh)(
            placed, token, cache)
        out[key + " decode"] = dict(
            token=np.asarray(token).tolist(),
            logits=np.asarray(logits).tolist(), in_specs=specs(in_sh),
            cache_specs=specs(out_sh[1]))
print(json.dumps(out))
""" % (B, TEXT, SEQ, CONFIGS, PREFILLS, DECODES)


@pytest.fixture(scope="module")
def reference():
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", _SCRIPT], env=env,
                         capture_output=True, text=True, timeout=600,
                         cwd=REPO)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


_PORT = {}


def _port(arch):
    """(the port's model, the reference's seed-0 weights, the request,
    the cache length), once per architecture."""
    if arch not in _PORT:
        name, kw = CONFIGS[arch]
        cfg = get_config(name).reduced(**kw)
        jparams = jax.device_get(jax.jit(jax_build_model(
            jax_get_config(name).reduced(**kw)).init)(
                jax.random.PRNGKey(0)))
        rng = np.random.default_rng(11)
        batch = {"tokens": torch.from_numpy(rng.integers(
            0, cfg.vocab_size, (B, TEXT)))}
        seq = SEQ
        if cfg.family == "vlm":
            batch["patches"] = torch.from_numpy(rng.normal(size=(
                B, cfg.prefix_tokens, cfg.frontend_dim)).astype(np.float32))
            seq += cfg.prefix_tokens
        _PORT[arch] = (build_model(cfg), jparams, batch, seq)
    return _PORT[arch]


def _listed(tree):
    """A spec tree with tuple entries as lists (as JSON gives them), the
    cache's ``pos`` (a host int) left out."""
    if isinstance(tree, dict):
        return {k: _listed(v) for k, v in tree.items() if k != "pos"}
    return [list(e) if isinstance(e, tuple) else e for e in tree]


def _without_pos(tree):
    return {k: v for k, v in tree.items() if k != "pos"}


@pytest.mark.parametrize("arch,mode,shape", PREFILLS)
def test_the_references_sharded_prefill_agrees(reference, arch, mode,
                                               shape):
    model, jparams, batch, seq = _port(arch)
    want = reference[f"{arch} {mode} {shape}"]
    mesh = make_test_mesh(shape)
    step, args = make_prefill_step(model, mesh, batch=B, seq=seq, mode=mode)
    assert _listed(args.in_specs[0]) == want["in_specs"][0]
    assert _listed(args.in_specs[1]) == want["in_specs"][1]
    assert args.out_specs[0] is None
    assert _listed(args.out_specs[1]) == _without_pos(want["cache_specs"])
    if (arch, mode, shape) in STRADDLED:
        assert TpLayout(model.config, args.in_specs[0], mesh).q_spans
    params = lm_params_from_numpy(jparams, model.config, mesh=mesh,
                                  specs=args.in_specs[0])
    logits, _ = step(params, shard_tree(batch, args.in_specs[1], mesh))
    np.testing.assert_allclose(logits.numpy(), np.asarray(want["logits"]),
                               **TOL)


@pytest.mark.parametrize("arch,mode,shape", DECODES)
def test_the_references_sharded_decode_agrees(reference, arch, mode,
                                              shape):
    model, jparams, batch, seq = _port(arch)
    want = reference[f"{arch} {mode} {shape} decode"]
    mesh = make_test_mesh(shape)
    pre, pargs = make_prefill_step(model, mesh, batch=B, seq=seq, mode=mode)
    dec, dargs = make_decode_step(model, mesh, batch=B, seq=seq, mode=mode)
    assert [_listed(s) for s in dargs.in_specs[:2]] == want["in_specs"][:2]
    assert _listed(dargs.in_specs[2]) == _without_pos(want["in_specs"][2])
    assert _listed(dargs.out_specs[1]) == _without_pos(want["cache_specs"])
    params = lm_params_from_numpy(jparams, model.config, mesh=mesh,
                                  specs=pargs.in_specs[0])
    _, cache = pre(params, shard_tree(batch, pargs.in_specs[1], mesh))
    token = torch.tensor(want["token"], dtype=torch.int64)
    logits, cache = dec(params, shard_tree(token, dargs.in_specs[1], mesh),
                        cache)
    np.testing.assert_allclose(logits.numpy(), np.asarray(want["logits"]),
                               **TOL)
    assert all(b["pos"] == TEXT + seq - SEQ + 1 for b in cache.blocks)

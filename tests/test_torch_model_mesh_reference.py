"""The reference's own sharded prefill against the port's, on the CPU.

One subprocess forces 4 host devices before it imports ``jax`` and
runs the JAX package's ``launch.steps.make_prefill_step(model, mesh,
mode=...)`` under ``jax.jit`` with its ``in_shardings`` /
``out_shardings``, on ``launch.mesh.make_test_mesh`` meshes (2, 2) and
(1, 4), in fsdp and tp mode, for the reduced granite on its seed-0
weights (as tests/test_distributed.py runs its mesh script).  It
prints the last position's logits and each step's input specs.  The
port's mesh step on the same weights, prompt, mesh shape and mode gives
those logits at the logits grade (rtol/atol 2e-4), and its
``MeshArgs.in_specs`` / ``out_specs`` equal the reference's shardings'
specs element by element.
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
from repro_torch.launch.steps import make_prefill_step
from repro_torch.models import build_model
from repro_torch.sharding.params import shard_tree
from torch_threads import _one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, SEQ = 4, 16
CASES = [(mode, shape) for mode in ("fsdp", "tp")
         for shape in ((2, 2), (1, 4))]

_SCRIPT = r"""
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import json
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import PartitionSpec as P
from repro.configs import get_config
from repro.launch.mesh import make_test_mesh
from repro.launch.steps import make_prefill_step
from repro.models.api import build_model

B, SEQ = %d, %d
cfg = get_config("granite-3-2b").reduced()
model = build_model(cfg)
params = model.init(jax.random.PRNGKey(0))
tokens = np.random.default_rng(11).integers(0, cfg.vocab_size, (B, SEQ))

def specs(tree):
    return jax.tree.map(lambda s: [list(e) if isinstance(e, tuple) else e
                                   for e in s.spec], tree,
                        is_leaf=lambda x: hasattr(x, "spec"))

out = {}
for mode, shape in %r:
    mesh = make_test_mesh(shape)
    fn, in_sh, out_sh, _ = make_prefill_step(model, mesh, batch=B, seq=SEQ,
                                             mode=mode)
    step = jax.jit(fn, in_shardings=in_sh, out_shardings=out_sh)
    logits, cache = step(jax.device_put(params, in_sh[0]),
                         {"tokens": jnp.asarray(tokens, jnp.int32)})
    out[f"{mode} {shape}"] = dict(
        logits=np.asarray(logits).tolist(), in_specs=specs(in_sh),
        cache_specs=specs(out_sh[1]))
print(json.dumps(out))
""" % (B, SEQ, CASES)


@pytest.fixture(scope="module")
def reference():
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", _SCRIPT], env=env,
                         capture_output=True, text=True, timeout=300,
                         cwd=REPO)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def port():
    jcfg, cfg = (jax_get_config("granite-3-2b").reduced(),
                 get_config("granite-3-2b").reduced())
    jparams = jax.device_get(jax.jit(jax_build_model(jcfg).init)(
        jax.random.PRNGKey(0)))
    tokens = np.random.default_rng(11).integers(0, cfg.vocab_size,
                                                (B, SEQ))
    return build_model(cfg), jparams, torch.from_numpy(tokens)


def _listed(tree):
    """A spec tree with tuple entries as lists (as JSON gives them)."""
    if isinstance(tree, dict):
        return {k: _listed(v) for k, v in tree.items()}
    return [list(e) if isinstance(e, tuple) else e for e in tree]


@pytest.mark.parametrize("mode,shape", CASES)
def test_the_references_sharded_prefill_agrees(reference, port, mode,
                                               shape):
    model, jparams, tokens = port
    want = reference[f"{mode} {shape}"]
    mesh = make_test_mesh(shape)
    step, args = make_prefill_step(model, mesh, batch=B, seq=SEQ, mode=mode)
    assert _listed(args.in_specs[0]) == want["in_specs"][0]
    assert _listed(args.in_specs[1]) == want["in_specs"][1]
    cache_specs = dict(_listed(args.out_specs[1]))
    assert cache_specs.pop("pos") == []
    assert cache_specs == {k: v for k, v in want["cache_specs"].items()
                           if k != "pos"}
    params = lm_params_from_numpy(jparams, model.config, mesh=mesh,
                                  specs=args.in_specs[0])
    logits, _ = step(params, shard_tree({"tokens": tokens},
                                        args.in_specs[1], mesh))
    np.testing.assert_allclose(logits.numpy(), np.asarray(want["logits"]),
                               rtol=2e-4, atol=2e-4)

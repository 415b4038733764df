"""K2a and K3a, the bf16 forms of ``admm_update`` and ``fused_gss``, on
the CPU against the JAX package's Pallas kernels in interpret mode.

The same fp32 numpy draws are rounded to bf16 on both sides (both round
to nearest even), and every output is compared bit for bit: the
reference's bf16 kernels round after each operation — λ⁺ =
bf16(bf16(λ + θ) − ω), z = bf16(θ + λ⁺), c = bf16(ω − λ⁺) — and so do
the port's plain versions, which the CUDA instances are held to on the
card (``tests/test_torch_cuda.py``, ``chip_smoke.py`` phase 10a).

The Pallas ``fused_gss`` grid covers ⌊D'/1024⌋ column blocks of the
lane-padded D' (``src/repro/kernels/fused_gss.py:150``): where D' > 1024
is not a multiple of 1024 its last columns are never committed
(ROADMAP D12), so K3a is held at widths the reference covers whole.
K2b (``admm_update_sharded``) is held against the reference's
``admm_update_sharded`` on 2 and 4 forced host devices in one
subprocess.
"""
import json
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.kernels import admm_update as k2
from repro_torch.kernels import fused_gss as k3
from repro_torch.kernels import ops
from repro_torch.sharding import make_client_mesh, replicate_data, \
    shard_rows

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# The reference test's shapes (tests/test_kernels.py:59) and an odd row.
ADMM_SHAPES = [(4, 64), (8, 1024), (5, 2049), (3, 7)]
GSS_SHAPES = [(16, 8, 130), (64, 24, 1000), (9, 3, 7), (12, 5, 2048)]
SHARDED_SHAPES = [(2, 8, 300), (4, 12, 1030)]


@pytest.fixture(autouse=True)
def _counts_stay_zero():
    ops.reset_launch_counts()
    yield
    assert ops.launch_counts() == {k: 0 for k in ops.KERNELS}, \
        "a CPU tensor must never reach a kernel launch"


def _mk(rng, *shape):
    return rng.normal(size=shape).astype(np.float32)


def _jb(x):
    return jnp.asarray(x).astype(jnp.bfloat16)


def _tb(x):
    return torch.from_numpy(np.ascontiguousarray(x)).to(torch.bfloat16)


def _bits(x) -> bytes:
    """The bf16 values of a torch or JAX array, widened exactly."""
    if isinstance(x, torch.Tensor):
        assert x.dtype == torch.bfloat16
        return x.float().numpy().tobytes()
    assert x.dtype == jnp.bfloat16
    return np.asarray(x.astype(jnp.float32)).tobytes()


@pytest.mark.parametrize("n,d", ADMM_SHAPES)
@pytest.mark.parametrize("with_z", [True, False])
def test_admm_update_bf16_bit_equal(n, d, with_z):
    rng = np.random.default_rng(n + d)
    th, la, w = _mk(rng, n, d), _mk(rng, n, d), _mk(rng, d)
    want = jops.admm_update(_jb(th), _jb(la), _jb(w), interpret=True,
                            with_z=with_z)
    got = ops.admm_update(_tb(th), _tb(la), _tb(w), with_z=with_z)
    assert len(got) == len(want) == (3 if with_z else 2)
    for g, x in zip(got, want, strict=True):
        assert _bits(g) == _bits(x)


def test_admm_update_bf16_rounds_each_operation():
    """Rounding λ + θ − ω once from fp32 gives other bits than the
    reference: the per-operation rounding is what is pinned."""
    rng = np.random.default_rng(3)
    th, la, w = _mk(rng, 5, 2049), _mk(rng, 5, 2049), _mk(rng, 2049)
    lam_new = ops.admm_update(_tb(th), _tb(la), _tb(w), with_z=False)[0]
    once = (_tb(la).float() + _tb(th).float() - _tb(w).float()
            ).to(torch.bfloat16)
    assert not torch.equal(lam_new, once)


@pytest.mark.parametrize("n,c,d", GSS_SHAPES)
@pytest.mark.parametrize("with_z", [True, False])
def test_fused_gss_bf16_bit_equal(n, c, d, with_z):
    rng = np.random.default_rng(7 * n + c + d)
    th, la, z, w, solved = (_mk(rng, n, d), _mk(rng, n, d), _mk(rng, n, d),
                            _mk(rng, d), _mk(rng, c, d))
    idx = rng.permutation(n)[:c].astype(np.int32)
    valid = rng.random(c) < 0.7
    valid[0] = True
    if c > 1:
        valid[-1] = False
    want = jops.fused_gss(jnp.asarray(idx), jnp.asarray(valid), _jb(solved),
                          _jb(w), _jb(th), _jb(la),
                          _jb(z) if with_z else None, interpret=True,
                          with_z=with_z)
    tt, tl, tz = _tb(th), _tb(la), _tb(z)
    got = ops.fused_gss(torch.from_numpy(idx), torch.from_numpy(valid),
                        _tb(solved), _tb(w), tt, tl, tz if with_z else None,
                        with_z=with_z)
    assert got[0] is tt and got[1] is tl
    for g, x in zip(got, want, strict=True):
        assert _bits(g) == _bits(x)


_JAX_SCRIPT = r"""
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import json, sys
import jax, jax.numpy as jnp, numpy as np
from repro.kernels.admm_update import admm_update_sharded
from repro.sharding.clients import make_client_mesh
from jax.sharding import NamedSharding, PartitionSpec as P

out = []
for p, n, d in json.loads(sys.argv[1]):
    rng = np.random.default_rng(p * 100 + n + d)
    th, la = (rng.normal(size=(n, d)).astype(np.float32) for _ in range(2))
    w = rng.normal(size=(d,)).astype(np.float32)
    mesh = make_client_mesh(p)
    put = lambda x: jax.device_put(jnp.asarray(x).astype(jnp.bfloat16),
                                   NamedSharding(mesh, P("clients")))
    res = {"theta": th.tolist(), "lam": la.tolist(), "w": w.tolist()}
    for with_z in (True, False):
        outs = admm_update_sharded(put(th), put(la),
                                   jnp.asarray(w).astype(jnp.bfloat16), mesh,
                                   interpret=True, with_z=with_z)
        res[f"admm_{with_z}"] = [np.asarray(o.astype(jnp.float32)).tolist()
                                 for o in outs]
    out.append(res)
print("RESULT:" + json.dumps(out))
"""


@pytest.fixture(scope="module")
def jax_sharded():
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", _JAX_SCRIPT,
                          json.dumps(SHARDED_SHAPES)], env=env,
                         capture_output=True, text=True, timeout=300,
                         cwd=REPO)
    assert out.returncode == 0, out.stderr[-3000:]
    line = [x for x in out.stdout.splitlines() if x.startswith("RESULT:")]
    return json.loads(line[-1][len("RESULT:"):])


@pytest.mark.parametrize("case", range(len(SHARDED_SHAPES)))
def test_admm_update_sharded_bf16_bit_equal(case, jax_sharded):
    p, n, d = SHARDED_SHAPES[case]
    res = jax_sharded[case]
    mesh = make_client_mesh(p, ["cpu"])
    th, la, w = (_tb(np.asarray(res[k], np.float32))
                 for k in ("theta", "lam", "w"))
    for with_z in (True, False):
        outs = ops.admm_update(shard_rows(th, mesh), shard_rows(la, mesh),
                               replicate_data(mesh, w), with_z=with_z,
                               mesh=mesh)
        want = ops.admm_update(th, la, w, with_z=with_z)
        for got, x, jx in zip(outs, want, res[f"admm_{with_z}"],
                              strict=True):
            assert torch.equal(torch.cat(got), x)
            assert torch.cat(got).float().numpy().tobytes() == \
                np.asarray(jx, np.float32).tobytes()


def test_bf16_access_widths():
    """K2a's 16-byte groups need every base 16-byte aligned; K3a's pairs
    (4 bytes in bf16, 8 in fp32) need an even D and aligned bases."""
    assert k2.bf16_vector_width([0, 16, 4096]) == 8
    assert k2.bf16_vector_width([0, 16, 4098]) == 1
    assert k3.check_kernel_args(16, 159010, 132, (0, 4, 8),
                                elem_bytes=2)[2] == 2
    assert k3.check_kernel_args(16, 159010, 132, (0, 4, 8))[2] == 1
    assert k3.check_kernel_args(16, 159010, 132, (0, 2),
                                elem_bytes=2)[2] == 1
    assert k3.check_kernel_args(16, 159011, 132, (0, 4),
                                elem_bytes=2)[2] == 1


def test_kernel_operands_share_one_dtype():
    """The kernel path takes all-fp32 or all-bf16 operands; the checks
    run before anything touches a card, so they raise here too."""
    th, w = torch.zeros(2, 8, dtype=torch.bfloat16), torch.zeros(8)
    with pytest.raises(TypeError, match="omega: expected bfloat16"):
        k2._kernel(th, th, w, True)
    with pytest.raises(TypeError, match="theta: expected float32 or "
                                        "bfloat16"):
        k2._kernel(th.half(), th.half(), w.half(), True)


def test_traffic_models_in_bf16():
    assert ops.admm_update_hbm_bytes(100, 159010, with_z=False,
                                     dtype_bytes=2) == \
        2 * (4 * 100 * 159010 + 159010)
    assert ops.fused_gss_hbm_bytes(14, 159010, dtype_bytes=2) == \
        2 * (6 * 14 * 159010 + 159010)

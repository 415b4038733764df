"""Every kernel wrapper refuses an input that requires grad (ROADMAP F3).

No hand-written kernel has a backward, and a wrapper's kernel path
fills its outputs with no autograd node: a loss through one would lose
that term's gradient on the card and keep it on the CPU.  So each
wrapper — K1, K1b, K1c, K2, K2b, K3, K4, K5 — refuses, on both paths, an
operand that requires grad, and a differentiable caller takes the plain
version by name.  Here on the CPU (the plain path);
``tests/test_torch_cuda.py::test_kernel_wrappers_refuse_grad_on_the_card``
holds the same cases on the card.
"""
import pytest
import torch

from repro_torch.kernels import ops
from repro_torch.sharding import make_client_mesh


def refuse_cases(dev):
    """name → (call, operands): ``call(*operands)`` runs the wrapper on
    small fp32 operands on ``dev`` (a shard list where it takes one)."""
    def randn(*shape):
        return torch.randn(shape, generator=gen).to(dev)

    gen = torch.Generator().manual_seed(0)
    n, d, c = 4, 40, 2
    z, w, th, lam = randn(n, d), randn(d), randn(n, d), randn(n, d)
    mesh = make_client_mesh(2, [dev])
    halves = lambda x: [x[:n // 2].clone(), x[n // 2:].clone()]  # noqa: E731
    idx = torch.tensor([3, 0], dtype=torch.int32, device=dev)
    valid = torch.tensor([True, True], device=dev)
    q, k, v = (randn(1, 32, 2, 16) for _ in range(3))
    states, decays = randn(1, 3, 2, 4, 8), torch.rand(1, 3, 2).to(dev)
    return {
        "trigger_sq_norms": (ops.trigger_sq_norms, (z, w)),
        "trigger_sq_norms_sharded": (
            lambda zs, ws: ops.trigger_sq_norms_sharded(zs, ws, mesh),
            (halves(z), [w.clone(), w.clone()])),
        "trigger_sq_norms_pytree": (
            ops.trigger_sq_norms_pytree,
            ({"a": z[:, :8].reshape(n, 2, 4).contiguous(),
              "b": z[:, 8:].contiguous()},
             {"a": w[:8].reshape(2, 4).contiguous(),
              "b": w[8:].contiguous()})),
        "admm_update": (lambda t, la, o: ops.admm_update(t, la, o,
                                                         with_z=False),
                        (th, lam, w)),
        "admm_update_sharded": (
            lambda t, la, o: ops.admm_update_sharded(t, la, o, mesh,
                                                     with_z=False),
            (halves(th), halves(lam), [w.clone(), w.clone()])),
        "fused_gss": (lambda s, o, t, la, zz: ops.fused_gss(
            idx, valid, s, o, t, la, zz),
            (randn(c, d), w, th.clone(), lam.clone(), z.clone())),
        "flash_attention": (lambda *qkv: ops.flash_attention(
            *qkv, layout="bshd"), (q, k, v)),
        "ssd_scan": (ops.ssd_scan, (states, decays)),
    }


def leaves(x):
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, dict):
        return [t for k in sorted(x) for t in leaves(x[k])]
    return [t for v in x for t in leaves(v)]


def check_refusals(dev, name):
    """The wrapper runs on the operands as they are, then refuses each
    operand in turn made a leaf that requires grad (for a tree or shard
    list: its last leaf), launching nothing."""
    call, operands = refuse_cases(dev)[name]
    call(*operands)
    launched = ops.launch_counts()[name]
    for i, x in enumerate(operands):
        leaf = leaves(x)[-1]
        leaf.requires_grad_(True)
        with pytest.raises(ValueError, match=f"{name} has no backward"):
            call(*operands)
        leaf.requires_grad_(False)
        assert ops.launch_counts()[name] == launched, (name, i)


@pytest.mark.parametrize("name", list(ops.KERNELS))
def test_kernel_wrappers_refuse_grad(name):
    assert len(ops.KERNELS) == 8
    ops.reset_launch_counts()
    check_refusals("cpu", name)
    assert ops.launch_counts()[name] == 0


def test_the_refusal_names_the_plain_version():
    q = torch.zeros((1, 8, 2, 16), requires_grad=True)
    with pytest.raises(ValueError, match="blockwise_attention"):
        ops.flash_attention(q, q.detach(), q.detach(), layout="bshd")
    st = torch.zeros((1, 2, 1, 2, 2), requires_grad=True)
    with pytest.raises(ValueError, match="ssd_scan_ref"):
        ops.ssd_scan(st, torch.ones((1, 2, 1)))
    # Under no_grad nothing requires grad, and the plain path runs.
    with torch.no_grad():
        h_prev, _ = ops.ssd_scan(st * 1, torch.ones((1, 2, 1)))
    assert not h_prev.requires_grad

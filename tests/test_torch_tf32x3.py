"""The arithmetic and layout of K4's tf32x3 instance, on the CPU.

``flash_attention_tf32x3_kernel`` (``csrc/model_kernels.cu``) runs fp32
attention on the tensor cores in 3×TF32: every operand x is split into
big = tf32(x) and small = tf32(x − big), and each product is
small·big + big·small + big·big with fp32 accumulators.  Here a plain
emulation of that arithmetic — the split as the kernel does it, TF32
products exact in fp32 as on the tensor cores, P unnormalised with the
scale folded into an exp2 — is held to the fp32 checks' tolerance
(rtol 1e-4, atol 1e-5) against the port's plain version, and one TF32
product is shown to miss it, which is why the kernel issues three.
The emulation is also held against the JAX package's Pallas kernel in
interpret mode at the tolerance of ``tests/test_torch_lm_kernels.py``
(2e-4).  Last, the layout that lets P feed the second product from the
accumulator: Vᵀ's keys in ``tf32_key_order`` within each group of 8,
as the pre-pass writes them (:func:`tf32x3_vt`).
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.kernels import flash_attention as fa

RTOL, ATOL = 1e-4, 1e-5  # the fp32 checks of the card tests


def _mm(a, b, products):
    """a @ b as the tensor cores compute it from TF32 operands (the
    products exact in fp32, the sums in fp32): three products with the
    small cross terms first, or one."""
    if products == 1:
        return fa.tf32_round(a) @ fa.tf32_round(b)
    ab, as_ = fa.tf32_split(a)
    bb, bs = fa.tf32_split(b)
    return as_ @ bb + ab @ bs + ab @ bb


def emulate(q, k, v, *, causal=True, window=0, products=3):
    """K4's tf32x3 instance, written out for (B, H, S, hd) fp32 inputs."""
    b, h, s, hd = q.shape
    g = h // k.shape[1]
    k, v = (t.repeat_interleave(g, dim=1) for t in (k, v))
    scale_log2 = torch.tensor(hd ** -0.5 * math.log2(math.e),
                              dtype=torch.float32)
    sc = _mm(q, k.transpose(-1, -2), products)  # unscaled scores
    qa = torch.arange(s)[:, None]
    ka = torch.arange(s)[None, :]
    ok = torch.ones((s, s), dtype=torch.bool)
    if causal:
        ok &= ka <= qa
    if window:
        ok &= ka > qa - window
    sc = sc.masked_fill(~ok, -math.inf)
    m = sc.amax(-1, keepdim=True) * scale_log2
    p = torch.exp2(sc * scale_log2 - m)
    out = _mm(p, v, products)
    return out / p.sum(-1, keepdim=True).clamp_min(1e-30)


def _inputs(seed, b, h, kvh, s, hd):
    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy(rng.normal(size=shp).astype(np.float32))
                 for shp in ((b, h, s, hd), (b, kvh, s, hd), (b, kvh, s, hd)))


CASES = [  # b, h, kvh, s, hd, causal, window
    (1, 4, 4, 256, 80, True, 0),     # the serve head dim, causal
    (1, 4, 1, 256, 80, True, 64),    # GQA 4:1 with a window
    (1, 4, 2, 200, 64, True, 50),    # GQA 2:1, ragged, another hd
    (1, 2, 2, 129, 128, False, 0),   # the widest instance, no mask
]


@pytest.mark.parametrize("b,h,kvh,s,hd,causal,window", CASES)
def test_three_tf32_products_hold_the_fp32_tolerance(b, h, kvh, s, hd,
                                                     causal, window):
    q, k, v = _inputs(s + hd, b, h, kvh, s, hd)
    want = fa.flash_attention_ref(q, k, v, causal=causal, window=window)
    got = emulate(q, k, v, causal=causal, window=window)
    torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("b,h,kvh,s,hd,causal,window", CASES[:2])
def test_one_tf32_product_misses_the_fp32_tolerance(b, h, kvh, s, hd,
                                                    causal, window):
    """TF32 keeps 10 mantissa bits: one product errs by ~1e-3 of each
    score, tens of times what the fp32 checks allow."""
    q, k, v = _inputs(s + hd, b, h, kvh, s, hd)
    want = fa.flash_attention_ref(q, k, v, causal=causal, window=window)
    got = emulate(q, k, v, causal=causal, window=window, products=1)
    excess = ((got - want).abs() / (ATOL + RTOL * want.abs())).max()
    assert excess > 10, f"one TF32 product used {excess:.2f}× the allowance"


def test_emulation_matches_the_pallas_kernel():
    b, h, kvh, s, hd = 1, 4, 2, 128, 80
    q, k, v = _inputs(7, b, h, kvh, s, hd)
    want = np.asarray(jops.flash_attention(
        jnp.asarray(q.numpy()), jnp.asarray(k.numpy()),
        jnp.asarray(v.numpy()), causal=True, window=32, block_q=32,
        block_k=32, interpret=True))
    got = emulate(q, k, v, window=32).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)


def test_tf32_split_is_exact_and_rounds_to_nearest():
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=4096).astype(np.float32)
                         * np.float32(2.0) ** rng.integers(-20, 20, 4096))
    big, small = fa.tf32_split(x)
    for part in (big, small):
        assert not (part.view(torch.int32) & 0x1FFF).any()
    # big is the nearest TF32 value: within half a TF32 ulp of x
    ulp = torch.ldexp(torch.ones_like(x), torch.frexp(x)[1] - 11)
    assert ((x - big).abs() <= ulp / 2).all()
    # big + small carries 22 bits: within 2^-22 of x, relatively
    assert ((x - (big + small)).abs() <= x.abs() * 2.0 ** -21).all()
    # ties go away from zero, as cvt.rna
    tie = torch.tensor([1 + 2.0 ** -11, -(1 + 2.0 ** -11)])
    assert fa.tf32_round(tie).tolist() == [1 + 2.0 ** -10, -(1 + 2.0 ** -10)]


def _acc_cols(lane):
    """Columns of an 8-wide block of a wgmma fp32 accumulator that a lane
    holds (PTX ISA, wgmma register fragments, matrix D): 2t, 2t + 1."""
    t = lane % 4
    return [2 * t, 2 * t + 1]


def _a_tf32_cols(lane):
    """Columns of an 8-wide k-slice of a TF32 A fragment that a lane holds
    (PTX ISA, wgmma .m64nNk8 A for .tf32: a0/a1 at t, a2/a3 at t + 4)."""
    t = lane % 4
    return [t, t + 4]


def test_key_order_maps_accumulator_columns_to_a_fragment_columns():
    """The kernel feeds accumulator element 4j (key 2t) as a0 and 4j + 1
    (key 2t + 1) as a2 of k-slice j: Vᵀ's position t must hold key 2t and
    position t + 4 key 2t + 1."""
    order = fa.tf32_key_order()
    assert sorted(order) == list(range(8))
    for lane in range(32):
        keys = _acc_cols(lane)
        positions = _a_tf32_cols(lane)
        assert [order[p] for p in positions] == keys


def tf32x3_vt(v):
    """Vᵀ as the tf32x3 pre-pass writes it, from v (B, KvH, S, hd):
    (2, B·KvH, hd, S8) fp32 — big then small — with S8 = S rounded up to
    8, the keys of each group of 8 in ``tf32_key_order`` and the
    keys past S zero."""
    b, kvh, s, hd = v.shape
    s8 = -(-s // 8) * 8
    vp = torch.zeros((b * kvh, s8, hd), dtype=torch.float32,
                     device=v.device)
    vp[:, :s] = v.reshape(b * kvh, s, hd)
    order = torch.tensor(fa.tf32_key_order(), device=v.device)
    idx = (torch.arange(0, s8, 8, device=v.device)[:, None]
           + order[None]).reshape(-1)
    return torch.stack(fa.tf32_split(vp[:, idx].transpose(1, 2)))


@pytest.mark.parametrize("s", [64, 37, 200])
def test_vt_layout_gives_p_v(s):
    """P·V over Vᵀ as the pre-pass lays it out, with P read in the
    accumulator order the kernel uses, equals P·V: big + small of Vᵀ
    restore V to 22 bits, the keys past S are zero."""
    rng = np.random.default_rng(s)
    b, kvh, hd = 2, 3, 48
    v = torch.from_numpy(rng.normal(size=(b, kvh, s, hd)).astype(np.float32))
    p = torch.from_numpy(rng.random((b * kvh, 16, s)).astype(np.float32))
    vt = tf32x3_vt(v)
    s8 = -(-s // 8) * 8
    assert vt.shape == fa.tf32x3_scratch_shapes(b, kvh, s, hd)[1]
    # position j of Vᵀ holds key (j // 8) * 8 + order[j % 8]
    order = torch.tensor(fa.tf32_key_order())
    keys = (torch.arange(0, s8, 8)[:, None] + order[None]).reshape(-1)
    p_pad = torch.zeros(b * kvh, 16, s8)
    p_pad[..., :s] = p
    got = p_pad[..., keys] @ (vt[0] + vt[1]).transpose(1, 2)
    want = p @ v.reshape(b * kvh, s, hd)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    assert not vt[..., keys >= s].any()

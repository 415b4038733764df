"""The port's K4 (flash_attention) and K5 (ssd_scan) on the CPU against
the JAX package's Pallas kernels in interpret mode and the model
functions they stand for, on the same numpy inputs.

On CPU tensors each op runs its plain PyTorch version (the CUDA kernels
are held against those on the card by ``chip_smoke.py`` and
``tests/test_torch_cuda.py``).  Tolerances:

* flash_attention: rtol/atol 2e-4 (fp32; the Pallas kernel's online
  softmax over 32-key blocks against one softmax over the whole row, as
  ``tests/test_kernels.py`` holds the Pallas kernel to its oracle);
* ssd_scan: rtol 1e-6 against the Pallas kernel (the same arithmetic,
  but XLA's CPU backend may contract ``carry·a + s`` into an FMA,
  ROADMAP Queue 3 D1), with atol 1e-6: the contraction's error is half
  an ulp of the product ``carry·a`` (|carry·a| < 8 here, so < 4.8e-7),
  which is not small against a sum that cancels to near 0; its fp32
  ``h_last`` against ``ssd_chunked``'s
  final state at rtol/atol 1e-4 (the states are rebuilt by einsums
  summed in another order).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.models.attention import blockwise_attention
from repro.models.ssm import ssd_chunked
from repro_torch.kernels import ops


def _mk(rng, *shape):
    return rng.normal(size=shape).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(autouse=True)
def _counts_stay_zero():
    ops.reset_launch_counts()
    yield
    assert ops.launch_counts() == {k: 0 for k in ops.KERNELS}, \
        "a CPU tensor must never reach a kernel launch"


# The shapes of tests/test_kernels.py::TestFlashAttention plus hd 80.
FA_SHAPES = [
    (1, 4, 4, 128, 64),   # MHA
    (2, 8, 2, 256, 64),   # GQA 4:1
    (1, 4, 1, 128, 128),  # MQA
    (1, 2, 2, 100, 32),   # ragged seq
    (1, 2, 1, 37, 16),    # small ragged
    (1, 4, 2, 70, 80),    # zamba2's head_dim, ragged
]


@pytest.mark.parametrize("b,h,kvh,s,hd", FA_SHAPES)
def test_flash_attention_matches_pallas(b, h, kvh, s, hd):
    rng = np.random.default_rng(s + hd)
    q, k, v = _mk(rng, b, h, s, hd), _mk(rng, b, kvh, s, hd), \
        _mk(rng, b, kvh, s, hd)
    want = np.asarray(jops.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
        block_q=32, block_k=32, interpret=True))
    got = ops.flash_attention(_t(q), _t(k), _t(v), causal=True).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("window", [16, 64])
@pytest.mark.parametrize("hd", [32, 80])
def test_flash_attention_window_matches_pallas(window, hd):
    rng = np.random.default_rng(window + hd)
    q, k, v = _mk(rng, 1, 4, 128, hd), _mk(rng, 1, 2, 128, hd), \
        _mk(rng, 1, 2, 128, hd)
    want = np.asarray(jops.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
        window=window, block_q=32, block_k=32, interpret=True))
    got = ops.flash_attention(_t(q), _t(k), _t(v), causal=True,
                              window=window).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("window", [0, 24])
def test_flash_attention_model_layout_matches_blockwise(window):
    """On the model's (B, S, H, hd) layout, against the model function
    the kernel stands for (``models/attention.py::blockwise_attention``)."""
    rng = np.random.default_rng(3 + window)
    b, s, h, kvh, hd = 2, 96, 4, 2, 32
    q, k, v = _mk(rng, b, s, h, hd), _mk(rng, b, s, kvh, hd), \
        _mk(rng, b, s, kvh, hd)
    pos = jnp.arange(s)
    want = np.asarray(blockwise_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), q_positions=pos,
        kv_positions=pos, mask_mode="causal", window=window, kv_block=32))
    got = ops.flash_attention(_t(q), _t(k), _t(v), causal=True,
                              window=window, layout="bshd")
    assert got.shape == (b, s, h, hd)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-4)
    # the two layouts are the same function
    got_bhsd = ops.flash_attention(*(_t(a).transpose(1, 2)
                                     for a in (q, k, v)),
                                   causal=True, window=window)
    np.testing.assert_array_equal(got_bhsd.transpose(1, 2).numpy(),
                                  got.numpy())


def test_flash_attention_bf16_keeps_dtype():
    rng = np.random.default_rng(9)
    q, k, v = (_t(_mk(rng, 1, 2, 64, 32)).to(torch.bfloat16)
               for _ in range(3))
    got = ops.flash_attention(q, k, v)
    assert got.dtype == torch.bfloat16
    want = ops.flash_attention(q.float(), k.float(), v.float())
    torch.testing.assert_close(got.float(), want, rtol=3e-2, atol=3e-2)


def test_flash_attention_flop_count():
    """The bound's operation count: 4·B·H·hd per allowed (q, kv) pair."""
    assert ops.flash_attention_flops(1, 1, 4, 16) == 4 * 16 * 10
    assert ops.flash_attention_flops(1, 1, 4, 16, window=2) == 4 * 16 * 7
    assert ops.flash_attention_flops(1, 1, 4, 16, causal=False) == \
        4 * 16 * 16
    assert ops.flash_attention_flops(4, 32, 2048, 80) == \
        4 * 4 * 32 * 80 * 2048 * 2049 // 2


# The shapes of tests/test_kernels.py::TestSsdScan.
@pytest.mark.parametrize("b,c,h,p,n", [
    (1, 4, 2, 8, 16), (2, 16, 3, 64, 128), (1, 1, 1, 8, 8)])
def test_ssd_scan_matches_pallas(b, c, h, p, n):
    rng = np.random.default_rng(c)
    states = _mk(rng, b, c, h, p, n)
    decays = rng.uniform(0.2, 0.99, (b, c, h)).astype(np.float32)
    want_prev, want_last = jops.ssd_scan(jnp.asarray(states),
                                         jnp.asarray(decays),
                                         interpret=True)
    got_prev, got_last = ops.ssd_scan(_t(states), _t(decays))
    assert got_last.dtype == torch.float32
    np.testing.assert_allclose(got_prev.numpy(), np.asarray(want_prev),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got_last.numpy(), np.asarray(want_last),
                               rtol=1e-6, atol=1e-6)
    assert float(np.abs(np.asarray(want_prev)).max()) < 8


def test_ssd_scan_bf16_states_keep_an_fp32_carry():
    """h_prev in the states' dtype, h_last in fp32: the carry is never
    rounded to bf16 between chunks."""
    rng = np.random.default_rng(4)
    states = _t(_mk(rng, 1, 6, 2, 4, 8)).to(torch.bfloat16)
    decays = _t(rng.uniform(0.2, 0.99, (1, 6, 2)).astype(np.float32))
    h_prev, h_last = ops.ssd_scan(states, decays)
    assert h_prev.dtype == torch.bfloat16 and h_last.dtype == torch.float32
    _, want_last = ops.ssd_scan(states.float(), decays)
    torch.testing.assert_close(h_last, want_last, rtol=0, atol=0)


def test_ssd_scan_matches_model_ssd_chunked_state():
    """The scan reproduces ``ssd_chunked``'s final state, as
    ``tests/test_kernels.py`` checks for the Pallas kernel."""
    rng = np.random.default_rng(0)
    b, s, h, p, n, q = 2, 64, 2, 4, 8, 8
    x = rng.normal(size=(b, s, h, p)).astype(np.float32)
    dt = rng.uniform(0.01, 0.3, (b, s, h)).astype(np.float32)
    a_log = rng.uniform(-1, 1, (h,)).astype(np.float32)
    bm = rng.normal(size=(b, s, n)).astype(np.float32)
    cm = rng.normal(size=(b, s, n)).astype(np.float32)
    _, h_last = ssd_chunked(jnp.asarray(x), jnp.asarray(dt),
                            jnp.asarray(a_log), jnp.asarray(bm),
                            jnp.asarray(cm), chunk=q)
    xt, dtt, bmt = _t(x), _t(dt), _t(bm)
    loga = (dtt * -torch.exp(_t(a_log))).reshape(b, s // q, q, h)
    cum = torch.cumsum(loga, dim=2)
    xdt = (xt * dtt[..., None]).reshape(b, s // q, q, h, p)
    bc = bmt.reshape(b, s // q, q, n)
    decay_to_end = torch.exp(cum[:, :, -1:, :] - cum)
    states = torch.einsum("bcjhp,bcjn->bchpn",
                          xdt * decay_to_end[..., None], bc).contiguous()
    chunk_decay = torch.exp(cum[:, :, -1, :]).contiguous()
    _, k_last = ops.ssd_scan(states, chunk_decay)
    np.testing.assert_allclose(k_last.numpy(), np.asarray(h_last),
                               rtol=1e-4, atol=1e-4)


def test_ssd_scan_hbm_bytes():
    """The bound's byte count at zamba2's prefill: bf16 states in and
    h_prev out, fp32 decays and h_last."""
    b, c, h, p, n = 4, 32, 80, 64, 64
    assert ops.ssd_scan_hbm_bytes(b, c, h, p, n) == \
        2 * b * c * h * p * n * 2 + 4 * b * c * h + 4 * b * h * p * n

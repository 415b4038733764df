"""The CUDA kernels against their plain versions, on the card.

Marked ``cuda``: each test skips where no CUDA device is visible.  Run
on a machine with an H100 with ``python -m pytest -m cuda
tests/test_torch_cuda.py``.  Elementwise kernels must be bit-exact;
the trigger kernel sums in another order (and contracts each
square-and-add into an FMA), so it is held at rtol 1e-5.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import ops

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _mk(rng, *shape):
    return torch.from_numpy(rng.normal(size=shape).astype(np.float32))


@pytest.mark.parametrize("n,d", [(1, 130), (7, 1001), (100, 4099)])
def test_trigger_kernel(dev, n, d):
    rng = np.random.default_rng(n + d)
    z, w = _mk(rng, n, d), _mk(rng, d)
    want = ops.trigger_sq_norms_ref(z, w)
    before = ops.trigger_sq_norms.launches
    got = ops.trigger_sq_norms(z.to(dev), w.to(dev))
    torch.cuda.synchronize()
    assert ops.trigger_sq_norms.launches == before + 1
    torch.testing.assert_close(got.cpu(), want, rtol=1e-5, atol=0)
    # Row starts off every alignment (a view at a 4-byte offset).
    zz = torch.cat([torch.zeros(1), z.reshape(-1)]).to(dev)[1:].view(n, d)
    torch.testing.assert_close(ops.trigger_sq_norms(zz, w.to(dev)).cpu(),
                               want, rtol=1e-5, atol=0)


@pytest.mark.parametrize("d", [130, 1001, 4099])
def test_trigger_kernel_sums_identical_rows_identically(dev, d):
    """The sum's order follows the row's own indices, not its address:
    identical rows at every alignment give bit-equal distances, as in
    the reference, so ties in the compact plan break by client index."""
    rng = np.random.default_rng(d)
    z, w = _mk(rng, d)[None].repeat(8, 1), _mk(rng, d).to(dev)
    got = ops.trigger_sq_norms(z.to(dev), w)
    shifted = torch.cat([torch.zeros(1), z.reshape(-1)]).to(dev)[1:]
    got_shifted = ops.trigger_sq_norms(shifted.view(8, d), w)
    assert torch.equal(got, got[:1].expand(8))
    assert torch.equal(got_shifted, got)


# D spanning several segments, with a ragged last segment and a tail
# that is not a multiple of 4: the paper width, 8·4096 + 6, and 1001.
SEGMENT_DIMS = [159010, 8 * 4096 + 6, 1001]


@pytest.mark.parametrize("d", SEGMENT_DIMS)
def test_trigger_kernel_segments(dev, d):
    rng = np.random.default_rng(d)
    z, w = _mk(rng, 3, d), _mk(rng, d)
    got = ops.trigger_sq_norms(z.to(dev), w.to(dev))
    torch.testing.assert_close(got.cpu(), ops.trigger_sq_norms_ref(z, w),
                               rtol=1e-5, atol=0)


@pytest.mark.parametrize("d", SEGMENT_DIMS)
def test_trigger_kernel_same_row_same_bits(dev, d):
    """One row's distance depends on its values and D alone: at N = 1,
    at N = 100, at a 4-byte-offset view and with ω off a 16-byte
    boundary it is the same float."""
    rng = np.random.default_rng(d + 1)
    row, w = _mk(rng, d).to(dev), _mk(rng, d).to(dev)
    z = row[None].repeat(100, 1)
    got = ops.trigger_sq_norms(z, w)
    assert torch.equal(got, got[:1].expand(100))
    one = ops.trigger_sq_norms(row[None].contiguous(), w)
    flat = torch.empty(100 * d + 1, device=dev)
    flat[1:] = z.reshape(-1)
    shifted = ops.trigger_sq_norms(flat[1:].view(100, d), w)
    w_flat = torch.empty(d + 1, device=dev)
    w_flat[1:] = w
    assert w_flat[1:].data_ptr() % 16
    w_off = ops.trigger_sq_norms(z, w_flat[1:])
    assert torch.equal(one, got[:1])
    assert torch.equal(shifted, got)
    assert torch.equal(w_off, got)


@pytest.mark.parametrize("d", [130, 1001, 159010])
def test_trigger_kernel_misaligned_omega(dev, d):
    rng = np.random.default_rng(d + 2)
    z, w = _mk(rng, 5, d), _mk(rng, d)
    w_flat = torch.cat([torch.zeros(1), w]).to(dev)
    got = ops.trigger_sq_norms(z.to(dev), w_flat[1:])
    torch.testing.assert_close(got.cpu(), ops.trigger_sq_norms_ref(z, w),
                               rtol=1e-5, atol=0)


@pytest.mark.parametrize("with_z", [True, False])
@pytest.mark.parametrize("n,d", [(1, 130), (9, 1001)])
def test_admm_kernel_bit_exact(dev, with_z, n, d):
    rng = np.random.default_rng(d)
    th, la, w = _mk(rng, n, d), _mk(rng, n, d), _mk(rng, d)
    want = ops.admm_update_ref(th, la, w, with_z=with_z)
    got = ops.admm_update(th.to(dev), la.to(dev), w.to(dev), with_z=with_z)
    for g, x in zip(got, want, strict=True):
        assert torch.equal(g.cpu(), x)


@pytest.mark.parametrize("with_z", [True, False])
def test_fused_gss_kernel_bit_exact(dev, with_z):
    rng = np.random.default_rng(1)
    n, c, d = 20, 8, 2050
    th, la, z, w, s = (_mk(rng, n, d), _mk(rng, n, d), _mk(rng, n, d),
                       _mk(rng, d), _mk(rng, c, d))
    idx = torch.from_numpy(rng.permutation(n)[:c].astype(np.int32))
    valid = torch.from_numpy(rng.random(c) < 0.6)
    want = ops.fused_gss_ref(idx, valid, s, w, th.clone(), la.clone(),
                             z.clone(), with_z=with_z)
    got = ops.fused_gss(idx.to(dev), valid.to(dev), s.to(dev), w.to(dev),
                        th.to(dev), la.to(dev), z.to(dev), with_z=with_z)
    for g, x in zip(got, want, strict=True):
        assert torch.equal(g.cpu(), x)


@pytest.mark.parametrize("with_z", [True, False])
@pytest.mark.parametrize("n,c,d,invalid", [
    (100, 16, 159010, (0, 15)),   # the round, first and last slot invalid
    (100, 1, 159010, ()),         # C = 1
    (100, 7, 159010, (3,)),       # C not a divisor of the block count
    (100, 16, 159011, (0, 15)),   # odd D: the 4-byte path
    (20, 5, 1001, (4,))])
def test_fused_gss_kernel_geometry_bit_exact(dev, with_z, n, c, d, invalid):
    """Bit-exact against the plain version over the whole state: rows
    outside the plan and the rows of invalid slots keep their bytes."""
    rng = np.random.default_rng(c + d)
    th, la, z, w, s = (_mk(rng, n, d), _mk(rng, n, d), _mk(rng, n, d),
                       _mk(rng, d), _mk(rng, c, d))
    idx = torch.from_numpy(rng.permutation(n)[:c].astype(np.int32))
    valid = torch.ones(c, dtype=torch.bool)
    valid[list(invalid)] = False
    want = ops.fused_gss_ref(idx, valid, s, w, th.clone(), la.clone(),
                             z.clone(), with_z=with_z)
    got = ops.fused_gss(idx.to(dev), valid.to(dev), s.to(dev), w.to(dev),
                        th.to(dev), la.to(dev), z.to(dev), with_z=with_z)
    torch.cuda.synchronize()
    for g, x in zip(got, want, strict=True):
        assert torch.equal(g.cpu(), x)
    untouched = np.setdiff1d(np.arange(n), idx[valid].numpy())
    for g, before in zip(got, (th, la, z), strict=False):
        assert torch.equal(g.cpu()[untouched].view(torch.int32),
                           before[untouched].view(torch.int32))


def test_fused_gss_kernel_misaligned_base_bit_exact(dev):
    """θ one element into its storage at an even D: the 4-byte path."""
    rng = np.random.default_rng(7)
    n, c, d = 12, 4, 2050
    th, la, z, w, s = (_mk(rng, n, d), _mk(rng, n, d), _mk(rng, n, d),
                       _mk(rng, d), _mk(rng, c, d))
    idx = torch.from_numpy(rng.permutation(n)[:c].astype(np.int32))
    valid = torch.tensor([True, False, True, True])
    want = ops.fused_gss_ref(idx, valid, s, w, th.clone(), la.clone(),
                             z.clone())
    th_dev = torch.cat([torch.zeros(1), th.reshape(-1)]).to(dev)[1:]
    th_dev = th_dev.view(n, d)
    assert th_dev.data_ptr() % 8
    got = ops.fused_gss(idx.to(dev), valid.to(dev), s.to(dev), w.to(dev),
                        th_dev, la.to(dev), z.to(dev))
    for g, x in zip(got, want, strict=True):
        assert torch.equal(g.cpu(), x)


# K2a and K3a: the bf16 instances, bit-equal to the plain versions' bf16
# ops (each add or subtract rounded), over the whole outputs and state.
def _bf16(t):
    return t.to(torch.bfloat16)


@pytest.mark.parametrize("with_z", [True, False])
@pytest.mark.parametrize("n,d,offset", [
    (4, 64, 0), (8, 1024, 0), (5, 2049, 0),  # the reference test's shapes
    (100, 159010, 0),                         # the dense round's width
    (3, 7, 0), (9, 1001, 1)])                 # a tail; θ off 16 bytes
def test_admm_kernel_bf16_bit_exact(dev, with_z, n, d, offset):
    rng = np.random.default_rng(n + d)
    th, la, w = (_bf16(_mk(rng, n, d)), _bf16(_mk(rng, n, d)),
                 _bf16(_mk(rng, d)))
    want = ops.admm_update_ref(th, la, w, with_z=with_z)
    th_dev = torch.cat([torch.zeros(offset, dtype=torch.bfloat16),
                        th.reshape(-1)]).to(dev)[offset:].view(n, d)
    before = ops.admm_update.launches
    got = ops.admm_update(th_dev, la.to(dev), w.to(dev), with_z=with_z)
    torch.cuda.synchronize()
    assert ops.admm_update.launches == before + 1
    for g, x in zip(got, want, strict=True):
        assert g.dtype == torch.bfloat16 and torch.equal(g.cpu(), x)


@pytest.mark.parametrize("p", [2, 4])
def test_admm_sharded_kernel_bf16_bit_exact(dev, p):
    from repro_torch.sharding import make_client_mesh, replicate_data, \
        shard_rows

    rng = np.random.default_rng(p)
    th, la, w = (_bf16(_mk(rng, 100, 159010)).to(dev),
                 _bf16(_mk(rng, 100, 159010)).to(dev),
                 _bf16(_mk(rng, 159010)).to(dev))
    mesh = make_client_mesh(p, [dev])
    before = ops.admm_update_sharded.launches
    got = ops.admm_update(shard_rows(th, mesh), shard_rows(la, mesh),
                          replicate_data(mesh, w), mesh=mesh)
    torch.cuda.synchronize()
    assert ops.admm_update_sharded.launches == before + p
    for part, whole in zip(got, ops.admm_update_ref(th, la, w), strict=True):
        assert torch.equal(torch.cat(part), whole)


@pytest.mark.parametrize("with_z", [True, False])
@pytest.mark.parametrize("n,c,d,invalid,offset", [
    (100, 16, 159010, (0, 15), 0),  # the round's width, C = 16, 14 valid
    (100, 7, 159011, (3,), 0),      # odd D: one element at a time
    (12, 4, 2050, (1,), 1)])        # θ 2 bytes off: one element at a time
def test_fused_gss_kernel_bf16_bit_exact(dev, with_z, n, c, d, invalid,
                                         offset):
    rng = np.random.default_rng(c + d)
    th, la, z, w, s = (_bf16(_mk(rng, n, d)), _bf16(_mk(rng, n, d)),
                       _bf16(_mk(rng, n, d)), _bf16(_mk(rng, d)),
                       _bf16(_mk(rng, c, d)))
    idx = torch.from_numpy(rng.permutation(n)[:c].astype(np.int32))
    valid = torch.ones(c, dtype=torch.bool)
    valid[list(invalid)] = False
    want = ops.fused_gss_ref(idx, valid, s, w, th.clone(), la.clone(),
                             z.clone(), with_z=with_z)
    th_dev = torch.cat([torch.zeros(offset, dtype=torch.bfloat16),
                        th.reshape(-1)]).to(dev)[offset:].view(n, d)
    before = ops.fused_gss.launches
    got = ops.fused_gss(idx.to(dev), valid.to(dev), s.to(dev), w.to(dev),
                        th_dev, la.to(dev), z.to(dev), with_z=with_z)
    torch.cuda.synchronize()
    assert ops.fused_gss.launches == before + 1
    for g, x in zip(got, want, strict=True):
        assert torch.equal(g.cpu(), x)


def test_bf16_kernels_refuse_mixed_dtypes(dev):
    th = torch.zeros(2, 8, dtype=torch.bfloat16, device=dev)
    with pytest.raises(TypeError, match="omega: expected bfloat16"):
        ops.admm_update(th, th, torch.zeros(8, device=dev))
    idx = torch.zeros(1, dtype=torch.int32, device=dev)
    valid = torch.ones(1, dtype=torch.bool, device=dev)
    with pytest.raises(TypeError, match="solved: expected bfloat16"):
        ops.fused_gss(idx, valid, torch.zeros(1, 8, device=dev),
                      th[0].clone(), th.clone(), th.clone(), th.clone())


def test_kernel_refuses_wrong_dtype(dev):
    z = torch.zeros(2, 3, dtype=torch.float64, device=dev)
    with pytest.raises(TypeError, match="float32"):
        ops.trigger_sq_norms(z, torch.zeros(3, dtype=torch.float64,
                                            device=dev))


# K4 flash_attention: fp32 against the plain version at rtol 1e-4 (the
# online softmax sums in another order; fresh fp32 tensors take the
# 3xTF32 instance); bf16 at 2e-2 (the plain version
# reads the same bf16 inputs and keeps fp32 inside; the tensor-core
# instance rounds P to bf16 before PV and the outputs round to bf16, 8
# bits of mantissa).
@pytest.mark.parametrize("b,h,kvh,s,hd,window", [
    (1, 4, 4, 128, 64, 0), (2, 8, 2, 256, 64, 0), (1, 4, 1, 128, 128, 0),
    (1, 2, 2, 100, 32, 0), (1, 2, 1, 37, 16, 0), (1, 4, 2, 200, 80, 0),
    (1, 4, 2, 300, 80, 64), (2, 2, 1, 129, 48, 16)])
def test_flash_attention_kernel(dev, b, h, kvh, s, hd, window):
    rng = np.random.default_rng(s + hd)
    q, k, v = _mk(rng, b, h, s, hd), _mk(rng, b, kvh, s, hd), \
        _mk(rng, b, kvh, s, hd)
    want = ops.flash_attention_ref(q, k, v, window=window)
    before = ops.flash_attention.launches
    got = ops.flash_attention(q.to(dev), k.to(dev), v.to(dev),
                              window=window)
    torch.cuda.synchronize()
    assert ops.flash_attention.launches == before + 1
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-5)
    qb, kb, vb = (t.to(dev, torch.bfloat16) for t in (q, k, v))
    got = ops.flash_attention(qb, kb, vb, window=window)
    want = ops.flash_attention_ref(qb, kb, vb, window=window)
    assert got.dtype == torch.bfloat16
    torch.testing.assert_close(got.float(), want.float(), rtol=2e-2,
                               atol=2e-2)


def test_flash_attention_kernel_model_layout(dev):
    """(B, S, H, hd) strided views, as the model's projections give."""
    rng = np.random.default_rng(5)
    b, s, h, kvh, hd = 2, 150, 4, 2, 80
    qkv = _mk(rng, b, s, (h + 2 * kvh) * hd).to(dev)
    q = qkv[..., :h * hd].view(b, s, h, hd)
    k = qkv[..., h * hd:(h + kvh) * hd].view(b, s, kvh, hd)
    v = qkv[..., (h + kvh) * hd:].view(b, s, kvh, hd)
    got = ops.flash_attention(q, k, v, window=32, layout="bshd")
    want = ops.flash_attention_ref(q, k, v, window=32, layout="bshd")
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)


# The bf16 instance on the tensor cores: head dims 64, 80 (not a multiple
# of the 128-byte swizzle span) and 128, causal with and without a
# window, GQA, both layouts, S off every tile boundary.
@pytest.mark.parametrize("hd", [64, 80, 128])
@pytest.mark.parametrize("b,h,kvh,s,window,causal,layout", [
    (2, 4, 4, 1000, 0, True, "bshd"), (2, 8, 2, 300, 100, True, "bhsd"),
    (1, 4, 1, 2000, 0, True, "bshd"), (1, 2, 2, 64, 0, True, "bhsd"),
    (1, 2, 1, 129, 16, True, "bshd"), (1, 4, 2, 200, 50, False, "bhsd"),
    (4, 32, 8, 2048, 0, True, "bshd")])  # granite-3-2b's GQA 32:8
def test_flash_attention_bf16_tensor_core_kernel(dev, hd, b, h, kvh, s,
                                                 window, causal, layout):
    rng = np.random.default_rng(s + hd)
    kv_shape = (b, kvh, s, hd) if layout == "bhsd" else (b, s, kvh, hd)
    q_shape = (b, h, s, hd) if layout == "bhsd" else (b, s, h, hd)
    q, k, v = (_mk(rng, *shp).to(dev, torch.bfloat16)
               for shp in (q_shape, kv_shape, kv_shape))
    before = ops.flash_attention.launches
    got = ops.flash_attention(q, k, v, causal=causal, window=window,
                              layout=layout)
    torch.cuda.synchronize()
    assert ops.flash_attention.launches == before + 1
    want = ops.flash_attention_ref(q, k, v, causal=causal, window=window,
                                   layout=layout)
    assert got.dtype == torch.bfloat16 and got.shape == q.shape
    torch.testing.assert_close(got.float(), want.float(), rtol=2e-2,
                               atol=2e-2)


def test_flash_attention_bf16_refuses_misaligned_inputs(dev):
    """TMA tensor maps: a view off a 16-byte boundary raises, never a
    quiet copy; fp32 (the SIMT instance) takes it."""
    b, h, s, hd = 1, 2, 64, 16
    flat = torch.zeros(1 + b * h * s * hd, device=dev, dtype=torch.bfloat16)
    q = flat[1:].view(b, h, s, hd)
    k = torch.zeros(b, h, s, hd, device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="16-byte boundary"):
        ops.flash_attention(q, k, k)
    flat32 = torch.zeros(1 + b * h * s * hd, device=dev)
    q32 = flat32[1:].view(b, h, s, hd)
    out = ops.flash_attention(q32, k.float(), k.float())
    assert torch.isfinite(out).all()


# The fp32 instance on the tensor cores (3xTF32): head dims 16, 64, 80
# and 128 (the 32-key tiles), GQA 4:1, windows 100 and 1024, a ragged
# S = 2000, no mask, both layouts; rtol 1e-4 / atol 1e-5 as every fp32
# check of K4.
@pytest.mark.parametrize("hd", [16, 64, 80, 128])
@pytest.mark.parametrize("b,h,kvh,s,window,causal,layout", [
    (2, 8, 2, 300, 100, True, "bhsd"), (1, 4, 4, 2000, 0, True, "bshd"),
    (1, 4, 1, 2000, 1024, True, "bshd"), (1, 2, 2, 64, 0, True, "bhsd"),
    (1, 4, 2, 200, 50, False, "bhsd"), (1, 2, 1, 37, 16, True, "bshd")])
def test_flash_attention_tf32x3_kernel(dev, hd, b, h, kvh, s, window,
                                       causal, layout):
    rng = np.random.default_rng(s + hd + 1)
    kv_shape = (b, kvh, s, hd) if layout == "bhsd" else (b, s, kvh, hd)
    q_shape = (b, h, s, hd) if layout == "bhsd" else (b, s, h, hd)
    q, k, v = (_mk(rng, *shp) for shp in (q_shape, kv_shape, kv_shape))
    want = ops.flash_attention_ref(q, k, v, causal=causal, window=window,
                                   layout=layout)
    before = ops.flash_attention.launches
    by_instance = dict(ops.flash_attention.instance_launches)
    got = ops.flash_attention(q.to(dev), k.to(dev), v.to(dev),
                              causal=causal, window=window, layout=layout)
    torch.cuda.synchronize()
    assert ops.flash_attention.launches == before + 1
    assert ops.flash_attention.instance_launches["tf32x3"] == \
        by_instance["tf32x3"] + 1
    assert got.dtype == torch.float32 and got.shape == q.shape
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("offset,which", [(1, 0), (2, 1), (3, 2)])
def test_flash_attention_fp32_off_tma_takes_the_simt_instance(dev, offset,
                                                              which):
    """An fp32 view 4, 8 or 12 bytes into its storage suits no tensor
    map: the rule sends it to the SIMT instance, at the same tolerance."""
    rng = np.random.default_rng(offset)
    b, h, s, hd = 1, 4, 300, 80
    ts = [_mk(rng, b, h, s, hd) for _ in range(3)]
    want = ops.flash_attention_ref(*ts, window=100)
    flat = torch.zeros(offset + b * h * s * hd, device=dev)
    flat[offset:] = ts[which].reshape(-1).to(dev)
    args = [t.to(dev) for t in ts]
    args[which] = flat[offset:].view(b, h, s, hd)
    simt = ops.flash_attention.instance_launches["simt"]
    got = ops.flash_attention(*args, window=100)
    torch.cuda.synchronize()
    assert ops.flash_attention.instance_launches["simt"] == simt + 1
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("b,c,h,p,n", [(1, 4, 2, 8, 16), (2, 16, 3, 64, 128),
                                       (1, 1, 1, 8, 8), (2, 5, 3, 7, 9),
                                       (2, 3, 2, 3, 4), (1, 70, 2, 8, 16)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_scan_kernel_bit_exact(dev, b, c, h, p, n, dtype):
    rng = np.random.default_rng(c)
    states = _mk(rng, b, c, h, p, n).to(dtype)
    decays = torch.from_numpy(rng.uniform(0.2, 0.99, (b, c, h)).astype(
        np.float32))
    want_prev, want_last = ops.ssd_scan_ref(states, decays)
    before = ops.ssd_scan.launches
    got_prev, got_last = ops.ssd_scan(states.to(dev), decays.to(dev))
    torch.cuda.synchronize()
    assert ops.ssd_scan.launches == before + 1
    assert got_prev.dtype == dtype and got_last.dtype == torch.float32
    assert torch.equal(got_prev.cpu(), want_prev)
    assert torch.equal(got_last.cpu(), want_last)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_scan_kernel_unaligned_base_bit_exact(dev, dtype):
    """States starting off a 16-byte boundary take the one-element path
    and give the same bits."""
    rng = np.random.default_rng(3)
    b, c, h, p, n = 2, 6, 3, 8, 16
    flat = _mk(rng, 1 + b * c * h * p * n).to(dtype)
    states = flat[1:].view(b, c, h, p, n)
    decays = torch.from_numpy(rng.uniform(0.2, 0.99, (b, c, h)).astype(
        np.float32))
    want_prev, want_last = ops.ssd_scan_ref(states, decays)
    dev_states = flat.to(dev)[1:].view(b, c, h, p, n)
    assert dev_states.data_ptr() % 16
    got_prev, got_last = ops.ssd_scan(dev_states, decays.to(dev))
    assert torch.equal(got_prev.cpu(), want_prev)
    assert torch.equal(got_last.cpu(), want_last)


@pytest.mark.parametrize("algorithm,compact,expect", [
    ("fedadmm", True, {"trigger_sq_norms": 1, "fused_gss": 1,
                       "admm_update": 0}),
    ("fedavg", False, {"trigger_sq_norms": 1, "fused_gss": 0,
                       "admm_update": 0}),
])
def test_baseline_round_matches_the_cpu(dev, algorithm, compact, expect):
    """One FedADMM round (compact, fused commit) and one FedAvg round
    (dense) on the card against the same round on the CPU: the random
    selection's events and the committed set equal, the state at rtol
    1e-4, and FedAvg's ω — a mean over the committed rows — at rtol
    1e-6 / atol 1e-7."""
    from repro_torch.convert import state_from_numpy, state_to_numpy
    from repro_torch.core import FLConfig, init_state, make_round_fn
    from repro_torch.models import init_mlp, make_loss_fn
    from repro_torch.prng import PRNGKey
    from repro_torch.utils import make_flat_spec

    rng = np.random.default_rng(0)
    n, n_pts = 16, 24
    data = {"x": rng.random((n, n_pts, 32)).astype(np.float32),
            "y": rng.integers(0, 4, (n, n_pts)).astype(np.int32)}
    cfg = FLConfig(algorithm=algorithm, n_clients=n, participation=0.25,
                   rho=0.01, lr=0.05, epochs=2, batch_size=8,
                   compact=compact, fused_gss=compact)
    params = init_mlp(PRNGKey(0, device="cpu"), 32, 16, 4, device="cpu")
    spec = make_flat_spec(params)
    cpu_round = make_round_fn(cfg, make_loss_fn(), data, spec=spec,
                              device="cpu")
    gpu_round = make_round_fn(cfg, make_loss_fn(), data, spec=spec,
                              device=dev)
    state, _ = cpu_round(init_state(cfg, params, spec=spec, device="cpu"))
    start = state_to_numpy(state)
    want, wm = cpu_round(state_from_numpy(start, device="cpu"))
    ops.reset_launch_counts()
    got, gm = gpu_round(state_from_numpy(start, device=dev))
    torch.cuda.synchronize()
    assert {k: ops.launch_counts()[k] for k in expect} == expect
    assert torch.equal(gm.events.cpu(), wm.events)
    assert torch.equal(gm.committed.cpu(), wm.committed)
    got, want = state_to_numpy(got), state_to_numpy(want)
    for f in ("theta", "lam", "z_prev", "omega"):
        np.testing.assert_allclose(getattr(got, f), getattr(want, f),
                                   rtol=1e-4, atol=1e-6, err_msg=f)
    if algorithm == "fedavg":
        np.testing.assert_allclose(got.omega, want.omega, rtol=1e-6,
                                   atol=1e-7)


@pytest.mark.parametrize("compact,expect", [
    (True, {"trigger_sq_norms": 1, "fused_gss": 1, "admm_update": 0}),
    (False, {"trigger_sq_norms": 1, "fused_gss": 0, "admm_update": 1}),
])
def test_pooled_round_matches_the_cpu(dev, compact, expect):
    """One FedBack round on ragged clients (16 clients of 9–24 pooled
    rows in padded size buckets; compact + fused, or dense) on the card
    against the same round on the CPU: launches as the rectangular
    round's, events and the committed set equal, the state at rtol
    1e-4."""
    from repro_torch.convert import state_from_numpy, state_to_numpy
    from repro_torch.core import FLConfig, init_state, make_round_fn
    from repro_torch.models import init_mlp, make_loss_fn
    from repro_torch.prng import PRNGKey
    from repro_torch.utils import make_flat_spec, pool_data

    rng = np.random.default_rng(0)
    n = 16
    sizes = rng.integers(9, 25, n)
    data, ragged = pool_data(
        [rng.random((s, 32)).astype(np.float32) for s in sizes],
        [rng.integers(0, 4, s).astype(np.int32) for s in sizes],
        device="cpu")
    assert any(b.padded for b in ragged.buckets)
    cfg = FLConfig(n_clients=n, participation=0.25, rho=0.01, lr=0.05,
                   epochs=2, batch_size=8, compact=compact, fused_gss=compact)
    params = init_mlp(PRNGKey(0, device="cpu"), 32, 16, 4, device="cpu")
    spec = make_flat_spec(params)
    cpu_round = make_round_fn(cfg, make_loss_fn(), data, spec=spec,
                              device="cpu", ragged=ragged)
    gpu_round = make_round_fn(cfg, make_loss_fn(), data, spec=spec,
                              device=dev, ragged=ragged)
    state, _ = cpu_round(init_state(cfg, params, spec=spec, device="cpu"))
    start = state_to_numpy(state)
    want, wm = cpu_round(state_from_numpy(start, device="cpu"))
    ops.reset_launch_counts()
    got, gm = gpu_round(state_from_numpy(start, device=dev))
    torch.cuda.synchronize()
    assert {k: ops.launch_counts()[k] for k in expect} == expect
    assert torch.equal(gm.events.cpu(), wm.events)
    assert torch.equal(gm.committed.cpu(), wm.committed)
    assert int(wm.committed.sum()) > 0
    got, want = state_to_numpy(got), state_to_numpy(want)
    for f in ("theta", "lam", "z_prev", "omega"):
        np.testing.assert_allclose(getattr(got, f), getattr(want, f),
                                   rtol=1e-4, atol=1e-6, err_msg=f)


def _stacked(rng, shapes, n, bf16=()):
    """A stacked tree (n, ...) and its ω of the given leaf shapes, the
    leaves named in ``bf16`` in bf16."""
    z, w = {}, {}
    for layer, leaves in shapes.items():
        z[layer], w[layer] = {}, {}
        for k, shape in leaves.items():
            dtype = torch.bfloat16 if (layer, k) in bf16 else torch.float32
            z[layer][k] = _mk(rng, n, *shape).to(dtype)
            w[layer][k] = _mk(rng, *shape).to(dtype)
    return z, w


# The paper models' leaves: the CIFAR CNN's 12 (HWIO kernels) and the
# MNIST MLP's 4.
CNN_LEAVES = {"conv1": {"w": (3, 3, 3, 32), "b": (32,)},
              "conv2": {"w": (3, 3, 32, 64), "b": (64,)},
              "conv3": {"w": (3, 3, 64, 64), "b": (64,)},
              "fc1": {"w": (1024, 128), "b": (128,)},
              "fc2": {"w": (128, 64), "b": (64,)},
              "fc3": {"w": (64, 10), "b": (10,)}}
MLP_LEAVES = {"fc1": {"w": (784, 200), "b": (200,)},
              "fc2": {"w": (200, 10), "b": (10,)}}


def _to(tree, dev):
    from repro_torch.utils.pytree import tree_map
    return tree_map(lambda t: t.to(dev), tree)


def _k1_on_the_concatenation(z, w):
    """K1's kernel on the fp32 matrix the reference's front end builds."""
    from repro_torch.utils.pytree import flatten, flatten_stacked
    return ops.trigger_sq_norms(flatten_stacked(z), flatten(w))


@pytest.mark.parametrize("shapes,bf16", [
    (CNN_LEAVES, ()), (MLP_LEAVES, ()), (MLP_LEAVES, (("fc1", "w"),))],
    ids=["cnn", "mlp", "mlp_bf16_leaf"])
def test_trigger_pytree_kernel(dev, shapes, bf16):
    """K1c: one launch of the leaf-table kernel over the stacked tree's
    leaves in place (K1 not launched), bit-equal to K1 on the
    concatenated fp32 copy, and within rtol 1e-5 of the plain version."""
    rng = np.random.default_rng(len(shapes))
    z, w = _stacked(rng, shapes, 100, bf16)
    want = ops.trigger_sq_norms_pytree_ref(z, w)
    zd, wd = _to(z, dev), _to(w, dev)
    ops.reset_launch_counts()
    got = ops.trigger_sq_norms_pytree(zd, wd)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    assert (counts["trigger_sq_norms_pytree"], counts["trigger_sq_norms"],
            ops.trigger_sq_norms_pytree.leaf_copies) == (1, 0, 0)
    assert torch.equal(got, _k1_on_the_concatenation(zd, wd))
    torch.testing.assert_close(got.cpu(), want, rtol=1e-5, atol=0)


# Leaf widths whose groups of 4 straddle leaves (1, 3, 5, 4097 columns),
# one a bf16 leaf, and an ω leaf in bf16 beside an fp32 z leaf.
ODD_LEAVES = {"a": {"w": (1,)}, "b": {"w": (3,)}, "c": {"w": (5,)},
              "d": {"w": (4097,)}, "e": {"w": (2, 7)}}


@pytest.mark.parametrize("n,bf16", [
    (1, ()), (7, ()), (30, (("d", "w"),)), (30, (("c", "w"), ("e", "w")))])
def test_trigger_table_straddling_odd_widths(dev, n, bf16):
    rng = np.random.default_rng(n + len(bf16))
    z, w = _stacked(rng, ODD_LEAVES, n, bf16)
    w["b"]["w"] = w["b"]["w"].to(torch.bfloat16)  # ω bf16, z fp32
    zd, wd = _to(z, dev), _to(w, dev)
    got = ops.trigger_sq_norms_pytree(zd, wd)
    assert torch.equal(got, _k1_on_the_concatenation(zd, wd))
    torch.testing.assert_close(got.cpu(), ops.trigger_sq_norms_pytree_ref(
        z, w), rtol=1e-5, atol=0)


def test_trigger_table_reads_leaf_views_off_alignment(dev):
    """Leaves that are views 4 bytes into their storage, and one whose
    rows are padded (a column slice: unit inner stride, a longer row
    stride), are read in place — no copy — with K1's bits."""
    rng = np.random.default_rng(11)
    z, w = _stacked(rng, MLP_LEAVES, 100)
    zd, wd = _to(z, dev), _to(w, dev)
    for layer, leaf in (("fc1", "w"), ("fc2", "b")):
        x = zd[layer][leaf]
        buf = torch.empty(x.numel() + 1, device=dev)
        buf[1:] = x.reshape(-1)
        zd[layer][leaf] = buf[1:].view(x.shape)
        assert zd[layer][leaf].data_ptr() % 16 == 4
    wide = torch.zeros(100, 204, device=dev)
    wide[:, :200] = zd["fc1"]["b"]
    zd["fc1"]["b"] = wide[:, :200]
    ops.reset_launch_counts()
    got = ops.trigger_sq_norms_pytree(zd, wd)
    assert ops.trigger_sq_norms_pytree.leaf_copies == 0
    assert torch.equal(got, _k1_on_the_concatenation(zd, wd))


def test_trigger_table_copies_a_leaf_it_cannot_read_in_place(dev):
    rng = np.random.default_rng(12)
    z, w = _stacked(rng, MLP_LEAVES, 10)
    zd, wd = _to(z, dev), _to(w, dev)
    zd["fc1"]["w"] = zd["fc1"]["w"].transpose(1, 2).contiguous() \
        .transpose(1, 2)  # same values, inner stride 200
    ops.reset_launch_counts()
    got = ops.trigger_sq_norms_pytree(zd, wd)
    assert ops.trigger_sq_norms_pytree.leaf_copies == 1
    assert torch.equal(got, _k1_on_the_concatenation(zd, wd))


@pytest.mark.parametrize("n,d", [(100, 159010), (7, 1001), (1, 130)])
def test_trigger_kernel_bf16(dev, n, d):
    """K1a: bf16 z and ω (and each alone) take the leaf-table kernel,
    counted under K1, bit-equal to K1 on fp32 copies."""
    rng = np.random.default_rng(n + d)
    z, w = _mk(rng, n, d).to(dev), _mk(rng, d).to(dev)
    zb, wb = z.to(torch.bfloat16), w.to(torch.bfloat16)
    for a, b in ((zb, wb), (zb, w), (z, wb)):
        before = ops.trigger_sq_norms.launches
        got = ops.trigger_sq_norms(a, b)
        assert ops.trigger_sq_norms.launches == before + 1
        assert torch.equal(got, ops.trigger_sq_norms(a.float(), b.float()))
        torch.testing.assert_close(got.cpu(), ops.trigger_sq_norms_ref(
            a.cpu(), b.cpu()), rtol=1e-5, atol=0)


def test_trigger_pytree_kernel_reads_the_flat_matrix_in_place(dev):
    """One (N, D) leaf goes to K1 as it is; K1c counts nothing."""
    rng = np.random.default_rng(0)
    z, w = _mk(rng, 100, 4099).to(dev), _mk(rng, 4099).to(dev)
    before = (ops.trigger_sq_norms_pytree.launches,
              ops.trigger_sq_norms.launches)
    got = ops.trigger_sq_norms_pytree(z, w)
    assert (ops.trigger_sq_norms_pytree.launches,
            ops.trigger_sq_norms.launches) == (before[0], before[1] + 1)
    assert torch.equal(got, ops.trigger_sq_norms(z, w))


@pytest.mark.parametrize("p,n,d", [(2, 100, 159010), (4, 100, 159010),
                                   (2, 14, 1001), (4, 12, 130)])
def test_sharded_kernels_equal_the_unsharded_rows(dev, p, n, d):
    """K1b and K2b on P shards of one card: each shard's rows bit-equal
    to the unsharded K1 / K2 on the same rows (a row's sum depends on its
    values and D alone); K1b in one launch for the card's P shards, K2b
    one launch per shard, counted as K1b / K2b."""
    from repro_torch.sharding import make_client_mesh, replicate_data, \
        shard_rows

    rng = np.random.default_rng(p + n + d)
    z, th, la = (_mk(rng, n, d).to(dev) for _ in range(3))
    w = _mk(rng, d).to(dev)
    mesh = make_client_mesh(p, [dev])
    ws = replicate_data(mesh, w)
    ops.reset_launch_counts()
    got = ops.trigger_sq_norms_sharded(shard_rows(z, mesh), ws, mesh)
    outs = ops.admm_update(shard_rows(th, mesh), shard_rows(la, mesh), ws,
                           with_z=False, mesh=mesh)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    assert (counts["trigger_sq_norms_sharded"], counts["admm_update_sharded"],
            counts["trigger_sq_norms"], counts["admm_update"]) == (1, p, 0, 0)
    assert [t.shape for t in got] == [(n // p,)] * p
    assert torch.equal(torch.cat(got), ops.trigger_sq_norms(z, w))
    for part, whole in zip(outs, ops.admm_update(th, la, w, with_z=False),
                           strict=True):
        assert torch.equal(torch.cat(part), whole)


@pytest.mark.parametrize("p", [2, 4])
def test_sharded_tree_kernel_one_launch_per_card(dev, p):
    """K1c with ``mesh=``: the card's P shards × leaves in one table
    launch, each shard's rows bit-equal to K1 on the whole tree's
    concatenation."""
    from repro_torch.sharding import make_client_mesh, replicate_data, \
        shard_rows

    rng = np.random.default_rng(p)
    z, w = _stacked(rng, CNN_LEAVES, 100, (("fc2", "w"),))
    zd, wd = _to(z, dev), _to(w, dev)
    mesh = make_client_mesh(p, [dev])
    ops.reset_launch_counts()
    got = ops.trigger_sq_norms_pytree(shard_rows(zd, mesh),
                                      replicate_data(mesh, wd), mesh=mesh)
    counts = ops.launch_counts()
    assert (counts["trigger_sq_norms_pytree"],
            counts["trigger_sq_norms_sharded"],
            counts["trigger_sq_norms"]) == (1, 0, 0)
    assert torch.equal(torch.cat(got), _k1_on_the_concatenation(zd, wd))


@pytest.mark.parametrize("compact", [False, True])
def test_sharded_round_matches_the_cpu(dev, compact):
    """One FedBack round on 2 shards of the card (K1b, and K2b dense or
    K3 per shard compact) against the same sharded round on the CPU."""
    from repro_torch.convert import state_from_numpy, state_to_numpy
    from repro_torch.core import FLConfig, init_state, make_round_fn
    from repro_torch.models import init_mlp, make_loss_fn
    from repro_torch.prng import PRNGKey
    from repro_torch.sharding import make_client_mesh
    from repro_torch.utils import make_flat_spec

    rng = np.random.default_rng(0)
    n, n_pts = 16, 24
    data = {"x": rng.random((n, n_pts, 32)).astype(np.float32),
            "y": rng.integers(0, 4, (n, n_pts)).astype(np.int32)}
    cfg = FLConfig(n_clients=n, participation=0.25, rho=0.01, lr=0.05,
                   epochs=2, batch_size=8, compact=compact,
                   fused_gss=compact)
    params = init_mlp(PRNGKey(0, device="cpu"), 32, 16, 4, device="cpu")
    spec = make_flat_spec(params)
    cpu_mesh, gpu_mesh = make_client_mesh(2, ["cpu"]), make_client_mesh(2)
    cpu_round = make_round_fn(cfg, make_loss_fn(), data, spec=spec,
                              mesh=cpu_mesh)
    gpu_round = make_round_fn(cfg, make_loss_fn(), data, spec=spec,
                              mesh=gpu_mesh)
    state, _ = cpu_round(init_state(cfg, params, spec=spec, mesh=cpu_mesh))
    start = state_to_numpy(state)
    want, wm = cpu_round(state_from_numpy(start, mesh=cpu_mesh))
    ops.reset_launch_counts()
    got, gm = gpu_round(state_from_numpy(start, mesh=gpu_mesh))
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    # one launch per card over its shards
    assert counts["trigger_sq_norms_sharded"] == len(set(gpu_mesh.devices))
    assert counts["fused_gss" if compact else "admm_update_sharded"] == 2
    assert torch.equal(gm.events.cpu(), wm.events)
    assert torch.equal(gm.committed.cpu(), wm.committed)
    got, want = state_to_numpy(got), state_to_numpy(want)
    for f in ("theta", "lam", "z_prev", "omega"):
        np.testing.assert_allclose(getattr(got, f), getattr(want, f),
                                   rtol=1e-4, atol=1e-6, err_msg=f)


def _mlp_problem(n=16, n_pts=24):
    from repro_torch.models import init_mlp
    from repro_torch.prng import PRNGKey
    from repro_torch.utils import make_flat_spec

    rng = np.random.default_rng(0)
    data = {"x": torch.from_numpy(rng.random((n, n_pts, 32)).astype(
        np.float32)), "y": torch.from_numpy(rng.integers(
            0, 4, (n, n_pts)).astype(np.int32))}
    params = init_mlp(PRNGKey(0, device="cpu"), 32, 16, 4, device="cpu")
    return data, params, make_flat_spec(params)


def _states_equal(a, b):
    from repro_torch.convert import state_to_numpy

    a, b = state_to_numpy(a), state_to_numpy(b)
    for f in a._fields:
        x, y = getattr(a, f), getattr(b, f)
        if isinstance(x, tuple):
            assert all(np.array_equal(u, v) for u, v in zip(x, y,
                                                            strict=True)), f
        elif x is not None:
            assert np.array_equal(x, y), f


@pytest.mark.parametrize("kw", [dict(fused_gss=True),
                                dict(fused_gss=True, max_staleness=2),
                                dict(consensus_compress="int8")])
def test_host_backend_matches_the_device_backend(dev, kw):
    """The host-offloaded round on the card (pinned matrices, the copy
    stream) against the device round of the same config, 4 rounds:
    every metric and the final state bit for bit; bytes as planned; the
    live device memory after the rounds within the working set's bound
    (the reference's tests/test_hoststate.py::
    test_live_device_memory_stays_o_cd)."""
    import dataclasses

    from repro_torch.core import FLConfig, init_state, make_round_fn
    from repro_torch.models import make_loss_fn

    data, params, spec = _mlp_problem()
    data = {k: v.to(dev) for k, v in data.items()}
    cfg = FLConfig(n_clients=16, participation=0.25, rho=0.01, lr=0.05,
                   epochs=2, batch_size=8, compact=True, **kw)
    hcfg = dataclasses.replace(cfg, state_backend="host")
    # The device form first: the process's one-time allocations (cuBLAS's
    # workspace) are made before the live-memory baseline.
    state = init_state(cfg, params, spec=spec)
    dround = make_round_fn(cfg, make_loss_fn(), data, spec=spec)
    dhist = []
    for _ in range(4):
        state, dm = dround(state)
        dhist.append(dm)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    host = init_state(hcfg, params, spec=spec)
    assert host.theta.is_pinned() and host.omega.device.type == "cuda"
    hround = make_round_fn(hcfg, make_loss_fn(), data, spec=spec)
    hist = []
    for _ in range(4):
        host, m = hround(host)
        hist.append(m)
    torch.cuda.synchronize()
    live = torch.cuda.memory_allocated() - base
    d = spec.dim
    bound = (8 * hround.static_info["capacity"] * d * 4
             + host.device_state_bytes() + (1 << 20))
    assert live <= bound, (live, bound)
    assert hround.stats["h2d_row_bytes"] == 4 * hround.planned_bytes[
        "row_stream_h2d"]
    assert hround.stats["h2d_ms"] > 0 and hround.stats["d2h_ms"] > 0
    for m, dm in zip(hist, dhist, strict=True):
        for f in dm._fields:
            assert torch.equal(getattr(m, f), getattr(dm, f)), f
    _states_equal(host, state)


def test_sweep_matches_its_runs_alone(dev):
    """A 2 × 2 sweep (seeds × gains) of the compact fused round on the
    card (odd runs' ω off 16 bytes in the stacked (R, D) tensor) against
    each run stepped alone: metrics and final state bit for bit."""
    import dataclasses

    from repro_torch.core import FLConfig, init_state, make_round_fn
    from repro_torch.launch.sweep import _run, run_sweep
    from repro_torch.models import make_loss_fn

    data, params, spec = _mlp_problem()
    data = {k: v.to(dev) for k, v in data.items()}
    cfg = FLConfig(n_clients=16, participation=0.25, rho=0.01, lr=0.05,
                   epochs=2, batch_size=8, compact=True, fused_gss=True)
    runs, final, hist = run_sweep(cfg, make_loss_fn(), data, params,
                                  rounds=3, seeds=(0, 1), gains=(2.0, 0.5),
                                  spec=spec)
    for r, (seed, k, _) in enumerate(runs):
        rcfg = dataclasses.replace(cfg, seed=seed,
                                   controller=cfg.controller._replace(K=k))
        state = init_state(rcfg, params, spec=spec)
        round_fn = make_round_fn(rcfg, make_loss_fn(), data, spec=spec)
        for i in range(3):
            state, m = round_fn(state)
            for f in m._fields:
                assert torch.equal(getattr(hist, f)[i, r], getattr(m, f))
        _states_equal(_run(final, r), state)

@pytest.fixture
def cards():
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two or more CUDA devices")
    return min(torch.cuda.device_count(), 4)


def test_sharded_kernels_on_separate_cards_equal_one_card(cards):
    """K1b and K2b with one shard per card (``make_client_mesh(P)`` on a
    node with P cards): each shard's result lies on its own card and is
    bit-equal to K1 / K2 on the same rows on cuda:0."""
    from repro_torch.sharding import make_client_mesh, replicate_data, \
        shard_rows

    n, d = 8 * cards, 159010
    mesh = make_client_mesh(cards)
    assert mesh.devices == tuple(torch.device("cuda", i)
                                 for i in range(cards))
    rng = np.random.default_rng(cards)
    z, th, la = (_mk(rng, n, d).to("cuda:0") for _ in range(3))
    w = _mk(rng, d).to("cuda:0")
    ws = replicate_data(mesh, w)
    ops.reset_launch_counts()
    got = ops.trigger_sq_norms_sharded(shard_rows(z, mesh), ws, mesh)
    outs = ops.admm_update(shard_rows(th, mesh), shard_rows(la, mesh), ws,
                           with_z=False, mesh=mesh)
    for i in range(cards):
        torch.cuda.synchronize(i)
    counts = ops.launch_counts()
    assert (counts["trigger_sq_norms_sharded"],
            counts["admm_update_sharded"]) == (cards, cards)
    assert [t.device for t in got] == list(mesh.devices)
    whole = ops.trigger_sq_norms(z, w)
    for i, part in enumerate(got):
        assert torch.equal(part.to("cuda:0"), whole[8 * i:8 * (i + 1)])
    for parts, whole in zip(outs, ops.admm_update(th, la, w, with_z=False),
                            strict=True):
        assert torch.equal(torch.cat([p.to("cuda:0") for p in parts]),
                           whole)


@pytest.mark.parametrize("compact", [False, True])
def test_sharded_round_on_separate_cards_equals_one_card(cards, compact):
    """Two FedBack rounds with one shard per card against the same
    sharded round with every shard on cuda:0: the same bits (each shard
    runs the same work, and the sums add in shard order on shard 0's
    card), with no host sync in the second round."""
    import warnings

    from repro_torch.convert import state_from_numpy, state_to_numpy
    from repro_torch.core import FLConfig, init_state, make_round_fn
    from repro_torch.models import init_mlp, make_loss_fn
    from repro_torch.prng import PRNGKey
    from repro_torch.sharding import make_client_mesh
    from repro_torch.utils import make_flat_spec

    rng = np.random.default_rng(0)
    n, n_pts = 8 * cards, 24
    data = {"x": rng.random((n, n_pts, 32)).astype(np.float32),
            "y": rng.integers(0, 4, (n, n_pts)).astype(np.int32)}
    cfg = FLConfig(n_clients=n, participation=0.25, rho=0.01, lr=0.05,
                   epochs=2, batch_size=8, compact=compact,
                   fused_gss=compact)
    params = init_mlp(PRNGKey(0, device="cpu"), 32, 16, 4, device="cpu")
    spec = make_flat_spec(params)
    results = []
    for mesh in (make_client_mesh(cards, ["cuda:0"]),
                 make_client_mesh(cards)):
        round_fn = make_round_fn(cfg, make_loss_fn(), data, spec=spec,
                                 mesh=mesh)
        state, _ = round_fn(init_state(cfg, params, spec=spec, mesh=mesh))
        for i in range(cards):
            torch.cuda.synchronize(i)
        ops.reset_launch_counts()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            state, m = round_fn(state)
            torch.cuda.set_sync_debug_mode(0)
        syncs = [str(w.message) for w in caught
                 if "synchroniz" in str(w.message).lower()
                 and "prototype" not in str(w.message)]
        assert not syncs, syncs[:3]
        counts = ops.launch_counts()
        assert counts["trigger_sq_norms_sharded"] == len(set(mesh.devices))
        assert counts["fused_gss" if compact
                      else "admm_update_sharded"] == cards
        assert [s.theta.device for s in state] == list(mesh.devices)
        results.append((m, state_to_numpy(state)))
    (one_m, one), (many_m, many) = results
    for f in ("events", "committed", "num_events", "realized_capacity"):
        assert torch.equal(getattr(many_m, f), getattr(one_m, f)), f
    for f in ("theta", "lam", "z_prev", "omega"):
        np.testing.assert_array_equal(getattr(many, f), getattr(one, f),
                                      err_msg=f)
    assert state_from_numpy(many, mesh=make_client_mesh(cards))[-1] \
        .theta.device == torch.device("cuda", cards - 1)


def test_checker_fast_matrix_passes_on_the_card(dev):
    """The static-invariant checker's fast matrix with the kernels: every
    rule passes or skips as on the CPU, no round syncs, and each leg's
    CUDA kernels in the profiler's trace are its wrappers' launches."""
    from repro_torch.analysis.artifacts import FAST_MATRIX, build_artifact
    from repro_torch.analysis.retrace import run_transfer_guard_check
    from repro_torch.analysis.rules import evaluate

    for key in FAST_MATRIX:
        art = build_artifact(key, device=dev)
        res = {r.rule: r for r in evaluate(art)}
        for r in res.values():
            assert r.status != "fail", (key.name, r.rule, r.violations)
        kp = res["fused-admm-pass"].metrics
        assert kp["kernel_calls"] == kp["expected"], key.name
        assert sum(kp["cuda_kernels"].values()) == \
            sum(kp["launches"].values()) > 0, key.name
        assert res["host-transfer-budget"].metrics["cuda_syncs"] == (
            0 if key.backend == "device" else
            res["host-transfer-budget"].metrics["plan_readbacks"])
    guard = run_transfer_guard_check(device=dev)
    assert guard.status == "pass", guard.violations


def test_checker_host_legs_pass_on_the_card(dev):
    """The full matrix's host-backend legs through the checker on the
    card (ROADMAP F4): the int8 legs' residual goes down to host memory
    on the copy stream with one event wait, so no round syncs beyond
    its plan read-back, as on the plain and uncompressed legs."""
    from repro_torch.analysis.artifacts import FULL_MATRIX, build_artifact
    from repro_torch.analysis.rules import evaluate

    legs = [k for k in FULL_MATRIX if k.backend == "host"]
    assert sum("int8" in k.name for k in legs) == 2
    for key in legs:
        res = {r.rule: r for r in evaluate(build_artifact(key, device=dev))}
        for r in res.values():
            assert r.status != "fail", (key.name, r.rule, r.violations)
        m = res["host-transfer-budget"].metrics
        assert m["syncs"] == 0 and m["cuda_syncs"] == m["plan_readbacks"], \
            (key.name, m)


def test_checker_catches_a_sync_on_the_card(dev):
    """A read-back inside a round raises under the sync debug mode's
    "error" and is counted by the op log."""
    from repro_torch.analysis.artifacts import ConfigKey, build_artifact
    from repro_torch.analysis.rules import evaluate

    def read_back(round_fn):
        def wrapped(state, *args):
            state.ctrl.delta.sum().item()
            return round_fn(state, *args)
        return wrapped

    art = build_artifact(ConfigKey("compact", "flat", "sync", "uniform", 1),
                         device=dev, body_transform=read_back)
    res = {r.rule: r for r in evaluate(art)}
    assert sorted(r for r, v in res.items() if v.status == "fail") == \
        ["host-transfer-budget"]
    assert res["host-transfer-budget"].metrics["cuda_syncs"] == 1


def _granite(**kw):
    import dataclasses

    from repro_torch.configs import get_config
    return dataclasses.replace(get_config("granite-3-2b").reduced(), **kw)


def test_dense_prefill_matches_the_cpu(dev):
    """The dense family's prefill and decode on the card (K4's 3xTF32
    instance, once a layer) against the CPU's plain path on the same
    weights: GQA 4:1 at head_dim 64, fp32, logits at rtol/atol 1e-3."""
    from repro_torch.models import build_model
    from repro_torch.utils.pytree import tree_map

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = _granite(num_heads=8, num_kv_heads=2, head_dim=64)
    model = build_model(cfg)
    params = model.init(0, device=dev)
    params_cpu = tree_map(lambda x: x.cpu(), params)
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 200)))
    ops.reset_launch_counts()
    got, cache = model.prefill(params, {"tokens": tokens.to(dev)}, 208)
    torch.cuda.synchronize()
    assert ops.flash_attention.instance_launches["tf32x3"] == cfg.num_layers
    want, cache_cpu = model.prefill(params_cpu, {"tokens": tokens}, 208)
    torch.testing.assert_close(got.cpu(), want, rtol=1e-3, atol=1e-3)
    tok = want[:, -1].argmax(-1)[:, None]
    got, _ = model.decode_step(params, tok.to(dev), cache)
    want, _ = model.decode_step(params_cpu, tok, cache_cpu)
    torch.testing.assert_close(got.cpu(), want, rtol=1e-3, atol=1e-3)


def test_crosspod_round_matches_the_cpu(dev):
    """Two cross-pod rounds of the reduced granite on the card against
    the same rounds on the CPU from the card's state: events equal, the
    state at the solve grade (rtol 1e-4 / atol 1e-6)."""
    from repro_torch.core.controller import ControllerConfig
    from repro_torch.core.crosspod import CrossPodConfig, \
        init_cross_pod_state, make_cross_pod_round
    from repro_torch.models import build_model
    from repro_torch.utils.pytree import tree_leaves, tree_map

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = _granite()
    model = build_model(cfg)
    cp = CrossPodConfig(n_pods=2, rho=1e-3, lr=5e-3, local_steps=2,
                        controller=ControllerConfig(K=0.05, alpha=0.9,
                                                    target_rate=0.5))
    round_fn = make_cross_pod_round(cp, model.loss)
    state = init_cross_pod_state(
        cp, model.init(0, device=dev), device=dev)
    rng = np.random.default_rng(0)
    for _ in range(2):
        toks = torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                             (2, 2, 8, 33)))
        batch = {"tokens": toks[..., :-1], "labels": toks[..., 1:]}
        before = state._replace(**{
            f: tree_map(lambda x: x.cpu(), getattr(state, f))
            for f in ("theta", "lam", "z_prev")},
            ctrl=type(state.ctrl)(*(x.cpu() for x in state.ctrl)),
            rng=state.rng.cpu(), round=state.round.cpu())
        state, m = round_fn(state, batch)
        want, wm = round_fn(before, batch)
        assert torch.equal(m.events.cpu(), wm.events)
        for f in ("theta", "lam", "z_prev"):
            for g, w in zip(tree_leaves(getattr(state, f)),
                            tree_leaves(getattr(want, f)), strict=True):
                torch.testing.assert_close(g.cpu(), w, rtol=1e-4, atol=1e-6)
        torch.testing.assert_close(m.train_loss.cpu(), wm.train_loss,
                                   rtol=1e-5, atol=0)


def test_adam_sqrt_is_correctly_rounded_on_the_card(dev):
    """AdamW takes its fp32 square root directly on the card, where the
    CPU takes it in float64 (``optim/adam.py::_sqrt``): torch's CUDA
    ``sqrt`` equals the correctly rounded root bit for bit on 2²² fp32
    values drawn over every finite positive bit pattern, and three
    AdamW steps on the card give the CPU's moments bit for bit and its
    weights at rtol 1e-6 (``pow`` in the bias correction may differ by
    an ulp between the two)."""
    from repro_torch.optim.adam import adam_init, adam_step
    from repro_torch.utils.pytree import tree_map

    rng = np.random.default_rng(0)
    bits = rng.integers(1, 0x7F800000, 1 << 22, dtype=np.uint32)
    x = torch.from_numpy(bits.view(np.float32))
    want = torch.sqrt(x.to(torch.float64)).to(torch.float32)
    assert torch.equal(torch.sqrt(x.to(dev)).cpu(), want)
    params = {"w": _mk(rng, 257, 129), "b": _mk(rng, 129)}
    on = {"cpu": (params, adam_init(params)),
          "card": (tree_map(lambda t: t.to(dev), params),
                   adam_init(tree_map(lambda t: t.to(dev), params)))}
    for _ in range(3):
        grads = {"w": _mk(rng, 257, 129), "b": _mk(rng, 129)}
        for k, (p, opt) in on.items():
            g = grads if k == "cpu" else tree_map(lambda t: t.to(dev), grads)
            on[k] = adam_step(p, g, opt, 1e-3, weight_decay=0.1)
    (p_cpu, o_cpu), (p_card, o_card) = on["cpu"], on["card"]
    for f in ("mu", "nu"):
        for k in ("w", "b"):
            assert torch.equal(getattr(o_card, f)[k].cpu(),
                               getattr(o_cpu, f)[k]), (f, k)
    for k in ("w", "b"):
        torch.testing.assert_close(p_card[k].cpu(), p_cpu[k], rtol=1e-6,
                                   atol=0)


@pytest.mark.parametrize("name", list(ops.KERNELS))
def test_kernel_wrappers_refuse_grad_on_the_card(dev, name):
    """ROADMAP F3: each wrapper launches its kernel on the operands as
    they are and refuses each one made to require grad, launching
    nothing (the CPU's cases of tests/test_torch_refuse_grad.py)."""
    from test_torch_refuse_grad import check_refusals

    before = ops.launch_counts()[name]
    check_refusals(dev, name)
    assert ops.launch_counts()[name] > before


@pytest.mark.parametrize("arch", ["mamba2-2.7b", "zamba2-2.7b"])
def test_ssm_loss_grads_match_the_cpu(dev, arch):
    """The ssm and hybrid training losses and their gradients on the card
    against the CPU's on the same weights, fp32, 2 × 64 tokens (8
    chunks of 8, so the inter-chunk scan carries most of the state):
    loss at rtol 1e-5, gradients at rtol 1e-4 / atol 1e-6.  The SSD
    runs ``ssd_scan_ref`` by name; had it reached K5, whose kernel path
    builds no autograd node, the inter-chunk term's gradient would be
    lost on the card only."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.utils.pytree import tree_leaves, tree_map

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(get_config(arch).reduced(), remat=True)
    model = build_model(cfg)
    params_cpu = tree_map(lambda x: x.requires_grad_(True),
                          model.init(0, device="cpu"))
    params = tree_map(lambda x: x.detach().to(dev).requires_grad_(True),
                      params_cpu)
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (2, 65)))
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    ops.reset_launch_counts()
    loss = model.loss(params, {k: v.to(dev) for k, v in batch.items()})
    grads = torch.autograd.grad(loss, tree_leaves(params))
    torch.cuda.synchronize()
    assert not any(ops.launch_counts().values())
    want = model.loss(params_cpu, batch)
    wgrads = torch.autograd.grad(want, tree_leaves(params_cpu))
    torch.testing.assert_close(loss.cpu(), want.detach(), rtol=1e-5, atol=0)
    for g, w in zip(grads, wgrads, strict=True):
        torch.testing.assert_close(g.cpu(), w, rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("arch", ["mixtral-8x7b", "moonshot-v1-16b-a3b"])
def test_moe_prefill_matches_the_cpu(dev, arch):
    """The MoE family's prefill and decode on the card against the CPU's
    plain path on the same weights, reduced, fp32 (TF32 off, so the fp32
    router picks the CPU's experts): 2 × 40 tokens (past mixtral's
    window of 16), K4's 3xTF32 instance once a layer, the routing (ids
    and keep mask of every layer) equal, logits at rtol/atol 1e-3, then
    two greedy decode steps."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model, moe, transformer
    from repro_torch.utils.pytree import tree_map

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config(arch).reduced(capacity_factor=1.25)
    model = build_model(cfg)
    params = model.init(0, device=dev)
    params_cpu = tree_map(lambda x: x.cpu(), params)
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 40)))
    plans, apply = [], transformer.moe_apply

    def recorded(p, x, *, top_k, capacity_factor, **kw):
        plans.append(moe.routing(p, x, top_k, capacity_factor))
        return apply(p, x, top_k=top_k, capacity_factor=capacity_factor,
                     **kw)

    ops.reset_launch_counts()
    transformer.moe_apply = recorded
    try:
        got, cache = model.prefill(params, {"tokens": tokens.to(dev)}, 44)
        torch.cuda.synchronize()
        assert ops.flash_attention.instance_launches["tf32x3"] == \
            cfg.num_layers
        want, cache_cpu = model.prefill(params_cpu, {"tokens": tokens}, 44)
    finally:
        transformer.moe_apply = apply
    n = cfg.num_layers
    for g, w in zip(plans[:n], plans[n:], strict=True):
        assert torch.equal(g["eids"].cpu(), w["eids"])
        assert torch.equal(g["keep"].cpu(), w["keep"])
    torch.testing.assert_close(got.cpu(), want, rtol=1e-3, atol=1e-3)
    for _ in range(2):
        tok = want[:, -1].argmax(-1)[:, None]
        got, cache = model.decode_step(params, tok.to(dev), cache)
        want, cache_cpu = model.decode_step(params_cpu, tok, cache_cpu)
        torch.testing.assert_close(got.cpu(), want, rtol=1e-3, atol=1e-3)


def test_flash_attention_at_moonshot_shape(dev):
    """K4's bf16 instance at moonshot-v1-16b-a3b's prefill shape, (4,
    2048, 16:16, 128) causal in the model's (B, S, H, hd) layout, one
    launch, against its plain version at rtol/atol 2e-2."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    q, k, v = (torch.randn((4, 2048, 16, 128), generator=gen, device=dev)
               .to(torch.bfloat16) for _ in range(3))
    ops.reset_launch_counts()
    got = ops.flash_attention(q, k, v, layout="bshd")
    torch.cuda.synchronize()
    assert ops.flash_attention.instance_launches["bf16_tc"] == 1
    want = ops.flash_attention_ref(q, k, v, layout="bshd")
    torch.testing.assert_close(got.float(), want.float(), rtol=2e-2,
                               atol=2e-2)


@pytest.mark.parametrize("b,h,kvh", [(4, 8, 2), (2, 32, 8)])
def test_flash_attention_at_the_mesh_shard_shapes(dev, b, h, kvh):
    """K4's bf16 instance at granite-3-2b's shard shapes on a model
    mesh, causal in the (B, S, H, hd) layout: (4, 2048, 8:2, 64), one
    model shard of four under tp, and (2, 2048, 32:8, 64), one data
    shard of two under fsdp; one launch each, against its plain version
    at rtol/atol 2e-2."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    q = torch.randn((b, 2048, h, 64), generator=gen, device=dev).to(
        torch.bfloat16)
    k, v = (torch.randn((b, 2048, kvh, 64), generator=gen, device=dev)
            .to(torch.bfloat16) for _ in range(2))
    ops.reset_launch_counts()
    got = ops.flash_attention(q, k, v, layout="bshd")
    torch.cuda.synchronize()
    assert ops.flash_attention.instance_launches["bf16_tc"] == 1
    want = ops.flash_attention_ref(q, k, v, layout="bshd")
    torch.testing.assert_close(got.float(), want.float(), rtol=2e-2,
                               atol=2e-2)


@pytest.mark.parametrize("mode", ["fsdp", "tp"])
def test_mesh_prefill_matches_the_cpu(dev, mode):
    """The reduced granite (8 heads of 64, 2 kv heads: K4's 3xTF32
    instance takes its shards) served on a (2, 2) mesh of the card
    against the same mesh of CPU shards: prefill and two decode steps,
    logits at rtol/atol 1e-3; K4 launched once per data shard and layer
    under fsdp, once per model shard too under tp."""
    from repro_torch.launch.mesh import make_mesh, make_test_mesh
    from repro_torch.launch.steps import make_decode_step, make_prefill_step
    from repro_torch.models import build_model
    from repro_torch.sharding.params import shard_tree

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = _granite(num_heads=8, num_kv_heads=2, head_dim=64)
    model = build_model(cfg)
    params = model.init(0, device="cpu")
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (4, 200)))
    out = {}
    for name, mesh in (("card", make_mesh((2, 2))),
                       ("cpu", make_test_mesh((2, 2)))):
        pre, pargs = make_prefill_step(model, mesh, batch=4, seq=208,
                                       mode=mode)
        dec, dargs = make_decode_step(model, mesh, batch=4, seq=208,
                                      mode=mode)
        sharded = shard_tree(params, pargs.in_specs[0], mesh)
        ops.reset_launch_counts()
        logits, cache = pre(sharded, shard_tree({"tokens": tokens},
                                                pargs.in_specs[1], mesh))
        launches = ops.flash_attention.instance_launches["tf32x3"]
        steps = [logits.cpu()]
        for i in range(2):
            tok = torch.full((4, 1), 5 * i + 3)
            logits, cache = dec(sharded, shard_tree(
                tok, dargs.in_specs[1], mesh), cache)
            steps.append(logits.cpu())
        out[name] = steps, launches
    per_layer = 4 if mode == "tp" else 2
    assert out["card"][1] == per_layer * cfg.num_layers
    assert out["cpu"][1] == 0
    for got, want in zip(out["card"][0], out["cpu"][0], strict=True):
        torch.testing.assert_close(got, want, rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("remat", [False, True])
def test_mesh_train_step_matches_the_cpu(dev, remat):
    """``make_train_step`` on a (2, 2) mesh of the card (the reduced
    granite, fp32) against the same mesh of CPU shards: the loss at rtol
    1e-5, the first moment at the solve grade, the parameters at it
    where the gradient is firm (Adam's first step) and within lr
    elsewhere; no kernel launches (training runs the plain
    differentiable paths)."""
    from repro_torch.launch.mesh import make_mesh, make_test_mesh
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import build_model
    from repro_torch.optim.adam import adam_init
    from repro_torch.sharding.params import gather_tree, shard_tree
    from repro_torch.utils.pytree import tree_leaves, tree_map

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = _granite(remat=remat)
    model = build_model(cfg)
    params = model.init(0, device="cpu")
    center = tree_map(lambda x: x + 0.01, params)
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (4, 33)))
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    out = {}
    ops.reset_launch_counts()
    for name, mesh in (("card", make_mesh((2, 2))),
                       ("cpu", make_test_mesh((2, 2)))):
        step, args = make_train_step(model, mesh, batch=4, seq=32, rho=1e-2,
                                     lr=1e-3)
        p, o, loss = step(*(shard_tree(x, s, mesh) for x, s in zip(
            (params, adam_init(params), center, batch), args.in_specs,
            strict=True)))
        out[name] = (gather_tree(p, device="cpu"),
                     gather_tree(o, device="cpu"), loss.cpu())
    assert not any(ops.launch_counts().values())
    (p, o, loss), (wp, wo, wloss) = out["card"], out["cpu"]
    torch.testing.assert_close(loss, wloss, rtol=1e-5, atol=0)
    for g, w in zip(tree_leaves(o.mu), tree_leaves(wo.mu), strict=True):
        torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-6)
    for g, w, m in zip(tree_leaves(p), tree_leaves(wp), tree_leaves(wo.mu),
                       strict=True):
        firm = m.abs() > 1e-7
        torch.testing.assert_close(g[firm], w[firm], rtol=1e-4, atol=1e-6)
        assert float((g - w).abs().max()) <= 1e-3 * 1.0001


def test_mesh_cross_pod_rounds_match_the_cpu(dev):
    """Two cross-pod rounds of the reduced granite (fp32) on a (2, 2, 2)
    pod × data × model mesh of the card against the same mesh of CPU
    shards from the same state: events equal, distances and the loss at
    rtol 1e-5, θ / λ / z_prev at the solve grade."""
    from repro_torch.core.controller import ControllerConfig
    from repro_torch.core.crosspod import CrossPodConfig
    from repro_torch.launch.mesh import make_mesh, make_test_mesh
    from repro_torch.models import build_model
    from repro_torch.sharding.params import gather_tree, shard_tree
    from repro_torch.sharding.train import cross_pod_batch_specs, \
        init_cross_pod_state_on_mesh, make_cross_pod_round_on_mesh
    from repro_torch.utils.pytree import tree_leaves

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = _granite()
    model = build_model(cfg)
    cp = CrossPodConfig(n_pods=2, rho=1e-3, lr=5e-3, local_steps=2,
                        controller=ControllerConfig(K=0.05, alpha=0.9,
                                                    target_rate=0.5))
    axes = ("pod", "data", "model")
    meshes = {"card": make_mesh((2, 2, 2), axes),
              "cpu": make_test_mesh((2, 2, 2), axes)}
    params0 = model.init(0, device="cpu")
    states = {k: init_cross_pod_state_on_mesh(cp, params0, m)
              for k, m in meshes.items()}
    rounds = {k: make_cross_pod_round_on_mesh(cp, model, m)
              for k, m in meshes.items()}
    rng = np.random.default_rng(1)
    ops.reset_launch_counts()
    for r in range(2):
        toks = torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                             (2, 2, 4, 33)))
        batch = {"tokens": toks[..., :-1], "labels": toks[..., 1:]}
        m = {}
        for k, mesh in meshes.items():
            states[k], m[k] = rounds[k](states[k], shard_tree(
                batch, cross_pod_batch_specs(batch), mesh))
        assert torch.equal(m["card"].events.cpu(), m["cpu"].events), r
        torch.testing.assert_close(m["card"].distances.cpu(),
                                   m["cpu"].distances, rtol=1e-5, atol=1e-7)
        torch.testing.assert_close(m["card"].train_loss.cpu(),
                                   m["cpu"].train_loss, rtol=1e-5, atol=0)
        got = gather_tree(states["card"], device="cpu")
        want = gather_tree(states["cpu"])
        for f in ("theta", "lam", "z_prev"):
            for g, w in zip(tree_leaves(getattr(got, f)),
                            tree_leaves(getattr(want, f)), strict=True):
                torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-6)
    assert not any(ops.launch_counts().values())


def test_matmul_fp32_backward_on_the_card(dev):
    """The CUDA branch of ``models.layers.matmul_fp32`` (one matmul with
    an fp32 output, whose overload has no derivative of its own) has a
    backward, and it is autograd of the widened product: the forward
    within fp32 rounding (the two matmuls may add the exact products in
    another order), the gradients within one bf16 ulp of their
    rounding."""
    from repro_torch.models.layers import matmul_fp32

    gen = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn((2, 64, 256), generator=gen, device=dev).to(
        torch.bfloat16)
    w = torch.randn((256, 128), generator=gen, device=dev).to(torch.bfloat16)
    g = torch.randn((2, 64, 128), generator=gen, device=dev)
    xs = [x.clone().requires_grad_(True) for _ in range(2)]
    ws = [w.clone().requires_grad_(True) for _ in range(2)]
    got = matmul_fp32(xs[0], ws[0])
    want = xs[1].to(torch.float32) @ ws[1].to(torch.float32)
    assert got.dtype == torch.float32
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    got.backward(g)
    want.backward(g)
    for a, b in ((xs[0].grad, xs[1].grad), (ws[0].grad, ws[1].grad)):
        assert a.dtype == torch.bfloat16
        torch.testing.assert_close(a, b, rtol=2 ** -7, atol=1e-6)


def test_dry_run_count_equals_the_cards_tp_prefill(dev):
    """The dry-run's count of zamba2's reduced tp prefill on mesh (1, 4)
    on the meta device against the same step on the card: K4's and K5's
    launches equal to the counted calls, the bytes by collective kind
    equal to the listener's."""
    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_mesh, make_test_mesh
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models import build_model
    from repro_torch.sharding.clients import collectives
    from repro_torch.sharding.params import shard_tree

    # zamba2's head_dim (K4's bf16 instance at a tp shard's 2:2 heads)
    cfg = get_config("zamba2-2.7b").reduced(
        dtype="bfloat16", num_heads=8, num_kv_heads=8, head_dim=80,
        kv_block=64, chunk=16)
    b, s = 2, 64
    counted = dryrun.count_cost(
        cfg, "prefill_32k", multi_pod=False, mode="tp",
        mesh=make_test_mesh((1, 4), devices=("meta",)), batch=b, seq=s)
    model = build_model(cfg)
    mesh = make_mesh((1, 4))
    step, args = make_prefill_step(model, mesh, batch=b, seq=s, mode="tp")
    params = shard_tree(model.init(0, device=dev), args.in_specs[0], mesh)
    tokens = torch.randint(0, cfg.vocab_size, (b, s), device=dev)
    batch = shard_tree({"tokens": tokens}, args.in_specs[1], mesh)
    moved = {}

    def count(kind, t):
        moved[kind] = moved.get(kind, 0) + t.numel() * t.element_size()

    ops.reset_launch_counts()
    collectives.listeners.append(count)
    try:
        step(params, batch)
        torch.cuda.synchronize()
    finally:
        collectives.listeners.remove(count)
    launches = ops.launch_counts()
    assert launches["flash_attention"] == sum(counted["flash_attention"]) > 0
    assert launches["ssd_scan"] == sum(counted["ssd_scan"]) > 0
    assert moved == {k: v for k, v in counted["collectives"].items() if v}

"""The argument rules of the K4 and K5 kernels, checked without a card.

``flash_attention.check_kernel_args`` and ``ssd_scan.check_kernel_args``
hold every rule the CUDA kernels put on their arguments, on plain
shapes, dtypes, strides and addresses; the wrappers call them for CUDA
tensors.  Here they are called directly: the bf16 flash-attention
instance reads its inputs through TMA tensor maps, so it refuses a base
off a 16-byte boundary and strides that are not multiples of 8 elements
(16 bytes), where fp32 takes them; both refuse the dtypes, head dims and
windows they always refused.  ``flash_attention.kernel_instance`` picks
the instance before the launch: fp32 tensors that suit TMA (16-byte
bases, strides in multiples of 4 elements) go to the 3xTF32 tensor-core
instance, every other fp32 tensor to the SIMT one, bf16 to its own.
"""
import pytest
import torch

from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ssd_scan as ss

BF16, F32 = torch.bfloat16, torch.float32


def _contig(shape):
    st, acc = [], 1
    for d in reversed(shape):
        st.append(acc)
        acc *= d
    return tuple(reversed(st))


def _fa_args(q_shape, kv_shape, dtype=BF16, *, strides=None, ptrs=None):
    strides = strides or tuple(_contig(x) for x in (q_shape, kv_shape,
                                                     kv_shape))
    ptrs = ptrs or (0x7f0000000000, 0x7f0000100000, 0x7f0000200000)
    return ((q_shape, kv_shape, kv_shape), (dtype,) * 3, strides, ptrs)


@pytest.mark.parametrize("dtype", [BF16, F32])
@pytest.mark.parametrize("layout,q_shape,kv_shape,dims", [
    ("bshd", (4, 2048, 32, 80), (4, 2048, 32, 80), (4, 32, 32, 2048, 80)),
    ("bhsd", (2, 8, 300, 80), (2, 2, 300, 80), (2, 8, 2, 300, 80)),
    ("bhsd", (1, 4, 37, 16), (1, 1, 37, 16), (1, 4, 1, 37, 16)),
    ("bshd", (2, 1000, 8, 128), (2, 1000, 8, 128), (2, 8, 8, 1000, 128))])
def test_flash_attention_accepts(dtype, layout, q_shape, kv_shape, dims):
    assert fa.check_kernel_args(*_fa_args(q_shape, kv_shape, dtype),
                                layout=layout) == dims


def test_flash_attention_accepts_the_serve_path_tensors():
    """q/k/v as the model makes them: (B, S, H, hd) from a projection and
    RoPE, contiguous and freshly allocated."""
    x = torch.zeros(2, 40, 4 * 80, dtype=BF16)
    q = x.reshape(2, 40, 4, 80)
    kv = torch.zeros(2, 40, 2, 80, dtype=BF16)
    got = fa.check_kernel_args(
        (q.shape, kv.shape, kv.shape), (q.dtype,) * 3,
        (q.stride(), kv.stride(), kv.stride()),
        (q.data_ptr(), kv.data_ptr(), kv.data_ptr()), layout="bshd")
    assert got == (2, 4, 2, 40, 80)


@pytest.mark.parametrize("offset_bytes", [2, 4, 8, 14])
def test_flash_attention_bf16_refuses_a_misaligned_base(offset_bytes):
    args = _fa_args((1, 2, 64, 16), (1, 2, 64, 16))
    ptrs = (0x1000 + offset_bytes, 0x2000, 0x3000)
    with pytest.raises(ValueError, match="16-byte boundary"):
        fa.check_kernel_args(*args[:3], ptrs)
    # the fp32 instance reads elements one at a time: a 4-byte step is fine
    if offset_bytes % 4 == 0:
        fa.check_kernel_args(*_fa_args((1, 2, 64, 16), (1, 2, 64, 16), F32,
                                       ptrs=ptrs))


@pytest.mark.parametrize("which", [0, 1, 2])
def test_flash_attention_bf16_refuses_a_misaligned_view(which):
    """A real tensor one element into its storage."""
    shape = (1, 2, 64, 16)
    t = torch.zeros(1 + 2 * 64 * 16, dtype=BF16)[1:].view(shape)
    ok = torch.zeros(shape, dtype=BF16)
    tensors = [ok, ok, ok]
    tensors[which] = t
    with pytest.raises(ValueError, match="16-byte boundary"):
        fa.check_kernel_args([x.shape for x in tensors], [BF16] * 3,
                             [x.stride() for x in tensors],
                             [x.data_ptr() for x in tensors])


@pytest.mark.parametrize("strides", [
    ((64 * 20 * 2, 64 * 20, 20, 1), (64 * 16 * 2, 64 * 16, 16, 1),
     (64 * 16 * 2, 64 * 16, 16, 1)),  # q rows 20 elements apart
    ((64 * 16 * 2, 64 * 16, 16, 1), (64 * 16 * 2 + 4, 64 * 16, 16, 1),
     (64 * 16 * 2, 64 * 16, 16, 1)),  # k batch stride off by 4
    ((64 * 16 * 2, 64 * 16, 16, 1), (64 * 16 * 2, 64 * 16, 16, 1),
     (64 * 16 * 2, 64 * 16 + 2, 16, 1))])  # v head stride off by 2
def test_flash_attention_bf16_refuses_strides_off_16_bytes(strides):
    shapes = ((2, 2, 64, 16),) * 3
    with pytest.raises(ValueError, match="multiples of 8"):
        fa.check_kernel_args(shapes, (BF16,) * 3, strides, (0, 0, 0))
    fa.check_kernel_args(shapes, (F32,) * 3, strides, (0, 0, 0))


@pytest.mark.parametrize("dtype", [BF16, F32])
def test_flash_attention_refuses_a_strided_head_dim(dtype):
    shapes = ((1, 2, 64, 16),) * 3
    strides = ((4096, 2048, 32, 2), (2048, 1024, 16, 1), (2048, 1024, 16, 1))
    with pytest.raises(ValueError, match="head dim must be contiguous"):
        fa.check_kernel_args(shapes, (dtype,) * 3, strides, (0, 0, 0))


@pytest.mark.parametrize("dtypes", [
    (torch.float16,) * 3, (torch.float64,) * 3, (BF16, F32, BF16),
    (F32, F32, BF16)])
def test_flash_attention_refuses_dtypes(dtypes):
    shape = (1, 2, 64, 16)
    with pytest.raises(TypeError, match="one dtype"):
        fa.check_kernel_args((shape,) * 3, dtypes, (_contig(shape),) * 3,
                             (0, 0, 0))


@pytest.mark.parametrize("hd", [0, 8, 24, 72, 144, 256])
def test_flash_attention_refuses_head_dims(hd):
    shape = (1, 2, 64, hd)
    with pytest.raises(ValueError, match="head_dim must be a multiple of 16"):
        fa.check_kernel_args(*_fa_args(shape, shape))


def test_flash_attention_refuses_a_negative_window():
    shape = (1, 2, 64, 16)
    with pytest.raises(ValueError, match="window must be >= 0"):
        fa.check_kernel_args(*_fa_args(shape, shape), window=-1)


@pytest.mark.parametrize("q_shape,kv_shape,match", [
    ((1, 6, 64, 16), (1, 4, 64, 16), "do not split"),
    ((1, 4, 64, 16), (1, 2, 63, 16), "expected"),
    ((2, 4, 64, 16), (1, 4, 64, 16), "expected"),
    ((1, 4, 64, 16), (1, 0, 64, 16), "do not split"),
    ((1, 4, 64), (1, 4, 64), "4-D")])
def test_flash_attention_refuses_shapes(q_shape, kv_shape, match):
    with pytest.raises(ValueError, match=match):
        fa.check_kernel_args(
            (q_shape, kv_shape, kv_shape), (F32,) * 3,
            tuple(_contig(x) for x in (q_shape, kv_shape, kv_shape)),
            (0, 0, 0))


def test_flash_attention_refuses_a_layout():
    shape = (1, 2, 64, 16)
    with pytest.raises(ValueError, match="layout"):
        fa.check_kernel_args(*_fa_args(shape, shape), layout="bsdh")


def test_flash_attention_refuses_too_many_batch_heads():
    shape = (65536, 1, 16, 16)
    with pytest.raises(ValueError, match="batch·heads"):
        fa.check_kernel_args(*_fa_args(shape, shape, F32))


def _instance(shapes, dtype, strides=None, ptrs=None):
    (shapes, dtypes, strides, ptrs) = _fa_args(*shapes, dtype,
                                               strides=strides, ptrs=ptrs)
    return fa.kernel_instance(dtypes[0], strides, ptrs)


@pytest.mark.parametrize("layout,q_shape,kv_shape", [
    ("bshd", (4, 2048, 32, 80), (4, 2048, 32, 80)),
    ("bhsd", (2, 8, 300, 80), (2, 2, 300, 80)),
    ("bhsd", (1, 4, 37, 16), (1, 1, 37, 16)),
    ("bshd", (2, 1000, 8, 128), (2, 1000, 8, 128))])
def test_aligned_fp32_takes_the_tensor_core_instance(layout, q_shape,
                                                      kv_shape):
    assert fa.check_kernel_args(*_fa_args(q_shape, kv_shape, F32),
                                layout=layout)
    assert _instance((q_shape, kv_shape), F32) == "tf32x3"


def test_the_model_layout_views_take_the_tensor_core_instance():
    """q, k, v cut from one fused (B, S, (H + 2 KvH) hd) projection, as
    the model makes them: every base and stride is a multiple of 16
    bytes."""
    b, s, h, kvh, hd = 2, 150, 4, 2, 80
    qkv = torch.zeros(b, s, (h + 2 * kvh) * hd)
    q = qkv[..., :h * hd].view(b, s, h, hd)
    k = qkv[..., h * hd:(h + kvh) * hd].view(b, s, kvh, hd)
    v = qkv[..., (h + kvh) * hd:].view(b, s, kvh, hd)
    assert fa.kernel_instance(
        F32, (q.stride(), k.stride(), v.stride()),
        (q.data_ptr(), k.data_ptr(), v.data_ptr())) == "tf32x3"


@pytest.mark.parametrize("which", [0, 1, 2])
@pytest.mark.parametrize("offset_bytes", [4, 8, 12])
def test_fp32_off_a_16_byte_base_takes_the_simt_instance(which,
                                                         offset_bytes):
    ptrs = [0x7f0000000000, 0x7f0000100000, 0x7f0000200000]
    ptrs[which] += offset_bytes
    shape = (1, 2, 64, 16)
    fa.check_kernel_args(*_fa_args(shape, shape, F32, ptrs=tuple(ptrs)))
    assert _instance((shape, shape), F32, ptrs=tuple(ptrs)) == "simt"


def test_an_fp32_view_off_its_storage_takes_the_simt_instance():
    """A real tensor one element into its storage."""
    shape = (1, 2, 64, 16)
    t = torch.zeros(1 + 2 * 64 * 16)[1:].view(shape)
    ok = torch.zeros(shape)
    assert fa.kernel_instance(F32, [x.stride() for x in (t, ok, ok)],
                              [x.data_ptr() for x in (t, ok, ok)]) == "simt"


@pytest.mark.parametrize("strides", [
    ((64 * 18 * 2, 64 * 18, 18, 1), (64 * 16 * 2, 64 * 16, 16, 1),
     (64 * 16 * 2, 64 * 16, 16, 1)),  # q rows 18 elements apart
    ((64 * 16 * 2, 64 * 16, 16, 1), (64 * 16 * 2 + 2, 64 * 16, 16, 1),
     (64 * 16 * 2, 64 * 16, 16, 1)),  # k batch stride off by 2
    ((64 * 16 * 2, 64 * 16, 16, 1), (64 * 16 * 2, 64 * 16, 16, 1),
     (64 * 16 * 2, 64 * 16 + 1, 16, 1))])  # v head stride off by 1
def test_fp32_strides_off_4_elements_take_the_simt_instance(strides):
    shape = (2, 2, 64, 16)
    fa.check_kernel_args((shape,) * 3, (F32,) * 3, strides, (0, 0, 0))
    assert fa.kernel_instance(F32, strides, (0, 0, 0)) == "simt"


def test_fp32_strides_of_4_elements_take_the_tensor_core_instance():
    """16 bytes is enough for fp32: strides of 4 elements that bf16 (8)
    would refuse."""
    shape = (2, 2, 64, 16)
    strides = ((64 * 20 * 2, 64 * 20, 20, 1),) * 3
    assert fa.kernel_instance(F32, strides, (0, 0, 0)) == "tf32x3"
    with pytest.raises(ValueError, match="multiples of 8"):
        fa.check_kernel_args((shape,) * 3, (BF16,) * 3, strides, (0, 0, 0))


@pytest.mark.parametrize("strides,ptrs", [
    (None, None), (((64 * 20 * 2, 64 * 20, 20, 1),) * 3, None),
    (None, (0x1004, 0x2000, 0x3000))])
def test_bf16_keeps_its_instance_and_its_rules(strides, ptrs):
    """bf16 always names its own instance; check_kernel_args still
    refuses what its tensor maps cannot read."""
    shape = (2, 2, 64, 16)
    args = _fa_args(shape, shape, BF16, strides=strides, ptrs=ptrs)
    assert _instance((shape, shape), BF16, strides, ptrs) == "bf16_tc"
    if strides is None and ptrs is None:
        fa.check_kernel_args(*args)
    else:
        with pytest.raises(ValueError):
            fa.check_kernel_args(*args)


@pytest.mark.parametrize("dtype", [BF16, F32])
def test_ssd_scan_accepts(dtype):
    assert ss.check_kernel_args((4, 32, 80, 64, 64), dtype, (4, 32, 80),
                                F32) == (4, 32, 80, 64, 64)


@pytest.mark.parametrize("states_shape,states_dtype,decays_shape,decays_dtype,"
                         "contiguous,err", [
    ((4, 32, 80, 64), BF16, (4, 32, 80), F32, True, ValueError),
    ((2, 5, 3, 7, 9), torch.float16, (2, 5, 3), F32, True, TypeError),
    ((2, 5, 3, 7, 9), BF16, (2, 5, 3), BF16, True, TypeError),
    ((2, 5, 3, 7, 9), BF16, (2, 5, 4), F32, True, TypeError),
    ((2, 5, 3, 7, 9), BF16, (2, 5, 3), F32, False, ValueError)])
def test_ssd_scan_refuses(states_shape, states_dtype, decays_shape,
                          decays_dtype, contiguous, err):
    with pytest.raises(err):
        ss.check_kernel_args(states_shape, states_dtype, decays_shape,
                             decays_dtype, contiguous)

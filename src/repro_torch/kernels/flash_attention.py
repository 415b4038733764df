"""K4: causal / sliding-window GQA flash attention (prefill).

Replaces ``src/repro/kernels/flash_attention.py::flash_attention``
(Pallas body ``_kernel``).  Softmax scale hd^−½; m, l and the
accumulator in fp32; l floored at 1e-30; output in q's dtype.  Masks are
index predicates on absolute positions 0..S−1: ``kv ≤ q`` (causal) and
``kv > q − window`` (window > 0).

The wrapper picks one of three CUDA instances (``csrc/model_kernels.cu``)
by a plain rule on dtype, strides and addresses (:func:`kernel_instance`),
before the launch; a failed launch raises and never gives way to
another instance or to the plain version:

- **bf16** — ``flash_attention_tc_kernel``, on the tensor cores: a
  block of two warpgroups owns 128 query rows of one (batch, head);
  S = QKᵀ and O += PV run as ``wgmma`` with fp32 accumulators, the
  online softmax stays in registers, P is rounded to bf16 in registers
  before PV (where the JAX ``blockwise_attention`` rounds it; ROADMAP
  D4), and 64-key K/V tiles arrive by TMA (the tensor memory
  accelerator) into a two-slot shared-memory ring, 128B-swizzled with
  the head dim padded to a multiple of 64.  A TMA tensor map needs every
  input to start on a 16-byte boundary and every stride but the head
  dim's to be a multiple of 8 elements; the wrapper raises on a tensor
  that breaks that and never copies one.
- **fp32 whose tensors suit TMA** (every base on a 16-byte boundary,
  every stride but the head dim's a multiple of 4 elements) —
  ``flash_attention_tf32x3_kernel``, on the tensor cores in 3×TF32:
  each operand x is split into big = tf32(x) and small = tf32(x − big)
  (round to nearest, :func:`tf32_round`), and each product is
  big·small + small·big + big·big as TF32 ``wgmma`` with fp32
  accumulators, which keeps the fp32 checks (rtol 1e-4) where one TF32
  product misses them by two orders of magnitude.  A pre-pass,
  ``tf32x3_split_kernel``, writes K's big and small parts and Vᵀ's
  (TF32 ``wgmma`` takes both operands K-major, so PV needs Vᵀ) into
  scratch that the wrapper allocates (:func:`tf32x3_scratch_shapes`);
  Vᵀ's keys are stored in :func:`tf32_key_order` within each group of
  8, so that P feeds the next product straight from the accumulator.
- **fp32 otherwise** — ``flash_attention_kernel``, fp32 SIMT FMAs from
  shared memory, P kept in fp32 as the Pallas kernel keeps it.

Both skip the key tiles right of the diagonal and left of the window,
as the Pallas grid's ``pl.when(reachable)`` does, map head h to kv head
h // (H/KvH) without materialising repeats, and mask the ragged edge of
S themselves.  The bound at the zamba2-2.7b prefill, (4, 32, 2048, 80)
bf16 causal, is 8.59e10 operations: 0.087 ms at 989 TFLOP/s.

Two layouts, read through strides (the head dim must be contiguous):
``"bhsd"`` — q (B, H, S, hd), k/v (B, KvH, S, hd), the Pallas kernel's;
``"bshd"`` — q (B, S, H, hd), k/v (B, S, KvH, hd), the model's, so the
prefill needs no transposes.  The output has q's layout and shape.
:func:`check_kernel_args` holds every rule the kernels put on their
arguments, on plain shapes, dtypes, strides and addresses.
"""
from __future__ import annotations

import math

import torch

from repro_torch.utils.spans import kernel_wrapper

from ._build import check_launch, load_library
from ._checks import is_cpu, refuse_grad, stream_ptr

DTYPES = (torch.float32, torch.bfloat16)
MAX_HEAD_DIM = 128  # the kernels are instantiated for hd/16 = 1 .. 8
LAYOUTS = ("bhsd", "bshd")
MAX_BATCH_HEADS = 65535  # a grid dimension of both instances
ALIGN_BYTES = 16  # a TMA tensor map's base and strides
# The instances, by the code the C entry point takes.
INSTANCES = ("simt", "bf16_tc", "tf32x3")


def _dims(q_shape, k_shape, layout):
    if layout not in LAYOUTS:
        raise ValueError(f"layout must be one of {LAYOUTS}, got {layout!r}")
    if len(q_shape) != 4 or len(k_shape) != 4:
        raise ValueError(f"q, k must be 4-D, got {tuple(q_shape)}, "
                         f"{tuple(k_shape)}")
    if layout == "bhsd":
        b, h, s, hd = q_shape
        kvh = k_shape[1]
    else:
        b, s, h, hd = q_shape
        kvh = k_shape[2]
    return b, h, kvh, s, hd


def _to_bhsd(t, layout):
    return t if layout == "bhsd" else t.transpose(1, 2)


def flash_attention_flops(b, h, s, hd, *, causal=True, window=0) -> int:
    """Multiply-adds of QKᵀ and PV counted as 2 operations each, over
    the (q, kv) pairs the mask allows."""
    pairs = 0
    for i in range(s):
        lo = max(0, i - window + 1) if window else 0
        hi = i + 1 if causal else s
        pairs += max(0, hi - lo)
    return 4 * b * h * hd * pairs


def flash_attention_hbm_bytes(b, h, kvh, s, hd, elem_bytes=2) -> int:
    """Bytes one call must move: q, k, v read once, the output written
    once."""
    return elem_bytes * s * hd * (2 * b * h + 2 * b * kvh)


def flash_attention_ref(q, k, v, *, causal=True, window=0, layout="bhsd"):
    """Plain PyTorch version: the masked softmax over the whole (S, S)
    score matrix, in fp32, then cast to q's dtype."""
    b, h, kvh, s, hd = _dims(q.shape, k.shape, layout)
    g = h // kvh
    qb, kb, vb = (_to_bhsd(t, layout) for t in (q, k, v))
    qg = qb.to(torch.float32).reshape(b, kvh, g, s, hd) * hd ** -0.5
    scores = torch.einsum("bkgqh,bkth->bkgqt", qg, kb.to(torch.float32))
    qa = torch.arange(s, device=q.device)[:, None]
    ka = torch.arange(s, device=q.device)[None, :]
    ok = torch.ones((s, s), dtype=torch.bool, device=q.device)
    if causal:
        ok &= ka <= qa
    if window:
        ok &= ka > qa - window
    scores = scores.masked_fill(~ok, -math.inf)
    w = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgqt,bkth->bkgqh", w, vb.to(torch.float32))
    out = out.reshape(b, h, s, hd).to(q.dtype)
    return out if layout == "bhsd" else out.transpose(1, 2).contiguous()


def check_kernel_args(shapes, dtypes, strides, ptrs, *, layout="bhsd",
                      window=0):
    """Every rule the CUDA kernels put on their arguments, checked on
    plain values of q, k, v (in that order): shapes, dtypes, strides in
    elements and data pointers (addresses).  Raises TypeError or
    ValueError on what the kernels do not take; returns
    (b, h, kvh, s, hd).  The wrapper calls it for CUDA tensors, then
    :func:`kernel_instance` on the same values; neither needs a card."""
    q_shape, k_shape, v_shape = (tuple(x) for x in shapes)
    b, h, kvh, s, hd = _dims(q_shape, k_shape, layout)
    dq, dk, dv = dtypes
    if dq not in DTYPES or dk != dq or dv != dq:
        raise TypeError("q, k, v must share one dtype, float32 or bfloat16;"
                        f" got {dq}, {dk}, {dv}")
    kv_shape = (b, kvh, s, hd) if layout == "bhsd" else (b, s, kvh, hd)
    if k_shape != kv_shape or v_shape != kv_shape:
        raise ValueError(f"k, v: expected {kv_shape}, got "
                         f"{k_shape}, {v_shape}")
    if kvh == 0 or h % kvh:
        raise ValueError(f"{h} heads do not split into {kvh} kv heads")
    if hd % 16 or not 0 < hd <= MAX_HEAD_DIM:
        raise ValueError(f"head_dim must be a multiple of 16 up to "
                         f"{MAX_HEAD_DIM}, got {hd}")
    if window < 0:
        raise ValueError(f"window must be >= 0, got {window}")
    if b * h > MAX_BATCH_HEADS:
        raise ValueError(f"at most {MAX_BATCH_HEADS} batch·heads per launch, "
                         f"got {b * h}")
    for name, st in zip("qkv", strides, strict=True):
        if len(st) != 4 or st[-1] != 1:
            raise ValueError(f"{name}: the head dim must be contiguous "
                             f"(stride 1), got strides {tuple(st)}")
    if dq == torch.bfloat16:
        for name, st, ptr in zip("qkv", strides, ptrs, strict=True):
            if ptr % ALIGN_BYTES:
                raise ValueError(
                    f"{name}: bf16 inputs must start on a {ALIGN_BYTES}-byte "
                    f"boundary (the kernel reads them through a TMA tensor "
                    f"map), got address {ptr:#x}")
            if any(x % 8 for x in st[:3]):
                raise ValueError(
                    f"{name}: bf16 strides must be multiples of 8 elements "
                    f"(16 bytes), got {tuple(st)}")
    return b, h, kvh, s, hd


def kernel_instance(dtype, strides, ptrs) -> str:
    """The CUDA instance that takes q, k, v of ``dtype`` with these
    strides (in elements) and data pointers: ``"bf16_tc"`` for bf16,
    ``"tf32x3"`` for fp32 whose tensors suit TMA (every base on a
    16-byte boundary, every stride but the head dim's a multiple of 4
    elements), ``"simt"`` for the other fp32 tensors.  A plain rule,
    decided before the launch."""
    if dtype == torch.bfloat16:
        return "bf16_tc"
    per = ALIGN_BYTES // dtype.itemsize
    fits = all(ptr % ALIGN_BYTES == 0 and all(x % per == 0 for x in st[:3])
               for st, ptr in zip(strides, ptrs, strict=True))
    return "tf32x3" if fits else "simt"


def tf32_key_order() -> list[int]:
    """Which key of a group of 8 the tf32x3 instance stores at each
    position of Vᵀ's rows: position t holds key 2t and position t + 4
    key 2t + 1 (t < 4).  A TF32 ``wgmma`` A fragment holds columns t and
    t + 4 of each 8-wide k-slice (t = lane % 4), and the S accumulator
    gives the lane columns 2t and 2t + 1: with this order P goes from
    the one to the other without a shuffle."""
    return [2 * (p % 4) + p // 4 for p in range(8)]


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """fp32 rounded to TF32 (10 explicit mantissa bits), to nearest with
    ties away from zero, as ``cvt.rna.tf32.f32``: the low 13 bits of
    the result are 0."""
    bits = x.to(torch.float32).contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def tf32_split(x: torch.Tensor):
    """(big, small) with big = tf32(x), small = tf32(x − big), as the
    tf32x3 instance splits every operand."""
    big = tf32_round(x)
    return big, tf32_round(x - big)


def tf32x3_scratch_shapes(b, kvh, s, hd):
    """Shapes of the tf32x3 instance's scratch: K's big and small parts
    (2, B·KvH, S, hd) and Vᵀ's (2, B·KvH, hd, S8)."""
    return (2, b * kvh, s, hd), (2, b * kvh, hd, -(-s // 8) * 8)


def _bhs_strides(st, layout):
    """(batch, head, seq) strides in elements."""
    return (st[0], st[1], st[2]) if layout == "bhsd" else (st[0], st[2],
                                                           st[1])


@kernel_wrapper("flash_attention")
def flash_attention(q, k, v, *, causal=True, window=0, layout="bhsd"):
    """Causal or sliding-window GQA attention; see the module note.

    CPU tensors take the plain version; CUDA tensors launch the instance
    that :func:`kernel_instance` names (or raise).  The kernel has no
    backward, so an input that requires grad is refused on both paths:
    a differentiable caller takes ``models.attention.blockwise_attention``
    by name.
    """
    refuse_grad("flash_attention", q, k, v,
                detail="q, k, v must not require grad (the training loss "
                "takes models.attention.blockwise_attention)")
    if is_cpu(q, k, v):
        return flash_attention_ref(q, k, v, causal=causal, window=window,
                                   layout=layout)
    b, h, kvh, s, hd = check_kernel_args(
        (q.shape, k.shape, v.shape), (q.dtype, k.dtype, v.dtype),
        (q.stride(), k.stride(), v.stride()),
        (q.data_ptr(), k.data_ptr(), v.data_ptr()), layout=layout,
        window=window)
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    instance = kernel_instance(q.dtype, (q.stride(), k.stride(),
                                         v.stride()),
                               (q.data_ptr(), k.data_ptr(), v.data_ptr()))
    scratch = ()  # K's and Vᵀ's TF32 parts, for the tf32x3 instance
    if instance == "tf32x3":
        scratch = tuple(torch.empty(shp, dtype=torch.float32,
                                    device=q.device)
                        for shp in tf32x3_scratch_shapes(b, kvh, s, hd))
    sq, sk, sv, so = (_bhs_strides(t.stride(), layout)
                      for t in (q, k, v, out))
    with torch.cuda.device(q.device):
        rc = load_library().mk_flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            *([t.data_ptr() for t in scratch] or [None, None]), *sq, *sk,
            *sv, *so, b, h, kvh, s, hd, int(causal), int(window),
            INSTANCES.index(instance), hd ** -0.5, stream_ptr(q))
    check_launch(f"flash_attention ({instance})", rc)
    flash_attention.launches += 1
    flash_attention.instance_launches[instance] += 1
    return out


flash_attention.launches = 0
# Launches by instance, beside the total.
flash_attention.instance_launches = dict.fromkeys(INSTANCES, 0)

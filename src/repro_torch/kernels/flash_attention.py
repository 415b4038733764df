"""K4: causal / sliding-window GQA flash attention (prefill).

Replaces ``src/repro/kernels/flash_attention.py::flash_attention``
(Pallas body ``_kernel``).  Softmax scale hd^−½ applied to q in fp32;
m, l and the accumulator in fp32; l floored at 1e-30; output in q's
dtype.  Masks are index predicates on absolute positions 0..S−1:
``kv ≤ q`` (causal) and ``kv > q − window`` (window > 0).

The CUDA kernel (``csrc/model_kernels.cu::flash_attention_kernel``) runs
one block per (batch·head, 64-row query tile) and loops over 64-key
tiles in shared memory with an online softmax; it skips the tiles right
of the diagonal and left of the window, as the Pallas grid's
``pl.when(reachable)`` does, maps head h to kv head h // (H/KvH) without
materialising repeats, and masks the ragged edge of S itself.  See the
source note for its bound.

Two layouts, read through strides (the head dim must be contiguous):
``"bhsd"`` — q (B, H, S, hd), k/v (B, KvH, S, hd), the Pallas kernel's;
``"bshd"`` — q (B, S, H, hd), k/v (B, S, KvH, hd), the model's, so the
prefill needs no transposes.  The output has q's layout and shape.
"""
from __future__ import annotations

import math

import torch

from ._build import check_launch, load_library
from ._checks import is_cpu, stream_ptr

DTYPES = (torch.float32, torch.bfloat16)
MAX_HEAD_DIM = 128  # the kernel keeps hd/16 accumulators per row group
LAYOUTS = ("bhsd", "bshd")


def _dims(q, k, layout):
    if layout not in LAYOUTS:
        raise ValueError(f"layout must be one of {LAYOUTS}, got {layout!r}")
    if layout == "bhsd":
        b, h, s, hd = q.shape
        kvh = k.shape[1]
    else:
        b, s, h, hd = q.shape
        kvh = k.shape[2]
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
    b, h, kvh, s, hd = _dims(q, k, layout)
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


def _strides(t, layout):
    """(batch, head, seq) strides in elements."""
    if t.stride(-1) != 1:
        raise ValueError("the head dim must be contiguous (stride 1)")
    if layout == "bhsd":
        return t.stride(0), t.stride(1), t.stride(2)
    return t.stride(0), t.stride(2), t.stride(1)


def flash_attention(q, k, v, *, causal=True, window=0, layout="bhsd"):
    """Causal or sliding-window GQA attention; see the module note.

    CPU tensors take the plain version; CUDA tensors launch the kernel
    (or raise).
    """
    b, h, kvh, s, hd = _dims(q, k, layout)
    if is_cpu(q, k, v):
        return flash_attention_ref(q, k, v, causal=causal, window=window,
                                   layout=layout)
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("q, k, v must share one dtype, float32 or bfloat16;"
                        f" got {q.dtype}, {k.dtype}, {v.dtype}")
    kv_shape = (b, kvh, s, hd) if layout == "bhsd" else (b, s, kvh, hd)
    if tuple(k.shape) != kv_shape or tuple(v.shape) != kv_shape:
        raise ValueError(f"k, v: expected {kv_shape}, got "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    if kvh == 0 or h % kvh:
        raise ValueError(f"{h} heads do not split into {kvh} kv heads")
    if hd % 16 or not 0 < hd <= MAX_HEAD_DIM:
        raise ValueError(f"head_dim must be a multiple of 16 up to "
                         f"{MAX_HEAD_DIM}, got {hd}")
    if window < 0:
        raise ValueError(f"window must be >= 0, got {window}")
    if b * h > 65535:
        raise ValueError(f"at most 65535 batch·heads per launch, got {b * h}")
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    sq, sk, sv, so = (_strides(t, layout) for t in (q, k, v, out))
    rc = load_library().mk_flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        *sq, *sk, *sv, *so, b, h, kvh, s, hd, int(causal), int(window),
        int(q.dtype == torch.bfloat16), hd ** -0.5, stream_ptr(q))
    check_launch("flash_attention", rc)
    flash_attention.launches += 1
    return out


flash_attention.launches = 0

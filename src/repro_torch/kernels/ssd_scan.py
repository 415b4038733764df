"""K5: the Mamba-2 inter-chunk state scan (SSD).

    H_0 = 0 ;  H_c = a_c · H_{c−1} + S_{c−1}     (exclusive, fp32 carry)

Replaces ``src/repro/kernels/ssd_scan.py::ssd_scan`` (Pallas body
``_kernel``), which walked the chunks as the innermost sequential grid
axis with the (P, N) carry in VMEM.  The CUDA kernel
(``csrc/model_kernels.cu::ssd_scan_vec_kernel``) keeps the carries in
registers and loops over the chunks itself, reading the states in their
(B, C, H, P, N) layout with no transpose copy.  It is bound by bytes
(173 MB at the zamba2-2.7b prefill, 0.0517 ms at 3.35 TB/s), so every
access is a 16-byte vector: each thread owns 8 bf16 (or 4 fp32)
elements of a (batch, head)'s P×N plane, issues the loads of 8 chunks
before their multiply-adds, reads each decay once per block from shared
memory, and writes ``h_last`` as float4s.  A plane size that is not a
multiple of the vector width, or a base off a 16-byte boundary, takes
the one-element-per-thread ``ssd_scan_kernel`` instead — the same
arithmetic, so the results do not depend on which one ran.

Outputs: ``h_prev`` (B, C, H, P, N) in the states' dtype — the state
entering each chunk, what the intra-chunk pass of ``ssd_chunked``
consumes — and ``h_last`` (B, H, P, N) **in fp32**, the final carry,
which the SSM cache keeps in fp32.  (The Pallas kernel writes ``h_last``
in the states' dtype; the two agree in fp32.)

The update is ``carry·a`` rounded, then ``+ s`` rounded: the kernels
use ``__fmul_rn`` and ``__fadd_rn``, so they are bit-equal to the plain
version, which rounds the product first.
"""
from __future__ import annotations

import torch

from repro_torch.utils.spans import kernel_wrapper

from ._build import check_launch, load_library
from ._checks import is_cpu, refuse_grad, stream_ptr

STATE_DTYPES = (torch.float32, torch.bfloat16)


def ssd_scan_hbm_bytes(b, c, h, p, n, state_bytes=2) -> int:
    """Bytes one call must move: the states read once, h_prev written
    once (both in the states' dtype), the decays read once, h_last
    written once in fp32."""
    return (2 * b * c * h * p * n * state_bytes + 4 * b * c * h
            + 4 * b * h * p * n)


def ssd_scan_ref(states: torch.Tensor, decays: torch.Tensor):
    """Plain PyTorch version: a loop over chunks with an fp32 carry."""
    b, c, h, p, n = states.shape
    carry = torch.zeros((b, h, p, n), dtype=torch.float32,
                        device=states.device)
    h_prev = torch.empty_like(states)
    for j in range(c):
        h_prev[:, j] = carry.to(states.dtype)
        carry = carry * decays[:, j, :, None, None]
        carry = carry + states[:, j].to(torch.float32)
    return h_prev, carry


def check_kernel_args(states_shape, states_dtype, decays_shape,
                      decays_dtype, contiguous=True):
    """The rules of the CUDA kernel on plain shapes and dtypes of the
    states and decays (and whether both are contiguous); raises
    TypeError or ValueError on what it does not take; returns
    (b, c, h, p, n).  It needs no card."""
    if len(states_shape) != 5:
        raise ValueError(f"states: expected (B, C, H, P, N), got "
                         f"{tuple(states_shape)}")
    b, c, h, p, n = states_shape
    if states_dtype not in STATE_DTYPES:
        raise TypeError(f"states: expected float32 or bfloat16, got "
                        f"{states_dtype}")
    if decays_dtype != torch.float32 or tuple(decays_shape) != (b, c, h):
        raise TypeError(f"decays: expected ({b}, {c}, {h}) float32, got "
                        f"{decays_dtype} {tuple(decays_shape)}")
    if not contiguous:
        raise ValueError("states and decays must be contiguous")
    return b, c, h, p, n


@kernel_wrapper("ssd_scan")
def ssd_scan(states: torch.Tensor, decays: torch.Tensor):
    """states: (B, C, H, P, N) fp32 or bf16; decays: (B, C, H) fp32 →
    (h_prev (B, C, H, P, N) in the states' dtype, h_last (B, H, P, N)
    fp32).

    CPU tensors take the plain version; CUDA tensors launch the kernel
    (or raise).  The kernel has no backward, so an input that requires
    grad is refused on both paths: the training loss takes
    :func:`ssd_scan_ref` by name (``models.ssm.ssd_chunked(scan=)``).
    """
    refuse_grad("ssd_scan", states, decays,
                detail="states and decays must not require grad (the "
                "training loss takes kernels.ssd_scan.ssd_scan_ref)")
    if is_cpu(states, decays):
        return ssd_scan_ref(states, decays)
    b, c, h, p, n = check_kernel_args(
        states.shape, states.dtype, decays.shape, decays.dtype,
        states.is_contiguous() and decays.is_contiguous())
    h_prev = torch.empty_like(states)
    h_last = torch.empty((b, h, p, n), dtype=torch.float32,
                         device=states.device)
    if h_prev.numel() == 0:
        return h_prev, h_last.zero_()
    with torch.cuda.device(states.device):
        rc = load_library().mk_ssd_scan(
            states.data_ptr(), decays.data_ptr(), h_prev.data_ptr(),
            h_last.data_ptr(), b, c, h, p * n,
            int(states.dtype == torch.bfloat16), stream_ptr(states))
    check_launch("ssd_scan", rc)
    ssd_scan.launches += 1
    return h_prev, h_last


ssd_scan.launches = 0

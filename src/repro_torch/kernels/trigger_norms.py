"""K1: per-client squared trigger distances ‖z_i^prev − ω‖².

Replaces ``src/repro/kernels/trigger_norms.py::trigger_sq_norms`` (the
Pallas body ``_kernel``).  The CUDA kernel
(``csrc/fedback_kernels.cu::trigger_sq_norms_kernel``) splits each
client row into S segments (:func:`trigger_segments`, from D alone),
summed by the S blocks of one thread-block cluster and added in rank
order through distributed shared memory, in one launch.  The order of
the sum depends only on the row's values and D (identical rows give
bit-equal sums, whatever their alignment, N or block order); see the
source note for its bound.  It masks the ragged edge of D itself
instead of padding to TPU tiles.

K1b, :func:`trigger_sq_norms_sharded`, replaces
``trigger_norms.py::trigger_sq_norms_sharded`` (``shard_map`` of K1 over
the ``clients`` mesh axis): the same kernel launched once per shard of a
client mesh on that shard's own rows.  A row's sum depends on its
values and D alone, so K1b gives every row the bits K1 gives it on the
whole (N, D) matrix.  Each launch is bound by its N/P rows' bytes like
K1; with N/P rows it runs N/P clusters, so it fills the SMs less than K1
on all N rows (PERF.md §6).

The caller takes the square root (``core/fedback.py``).
"""
from __future__ import annotations

import torch

from ._build import check_launch, load_library
from ._checks import check_f32, check_shards, is_cpu, stream_ptr


MAX_SEGMENTS = 8  # a thread-block cluster's portable maximum size
SEGMENT_MIN_GROUPS = 2048  # groups of 4 a segment takes before a row splits
MAX_BLOCKS = 2**31 - 1  # the grid's x dimension


def trigger_segments(d: int) -> tuple[int, int]:
    """(S, G) for rows of ``d`` elements: cluster block r sums the groups
    of 4 elements [r·G, min((r+1)·G, d // 4)) of its row, and block S−1
    also the d mod 4 tail elements.  S and G depend on d alone, so a
    row's sum does too."""
    if d < 1:
        raise ValueError(f"d must be >= 1, got {d}")
    groups = d // 4
    segs = max(1, min(MAX_SEGMENTS, -(-groups // SEGMENT_MIN_GROUPS)))
    return segs, -(-groups // segs)


def check_kernel_args(n: int, d: int, omega_ptr: int) -> tuple[int, int,
                                                                int]:
    """The launch of the CUDA kernel for an (n, d) z_prev and ω at
    ``omega_ptr``: (S, G, ω's vector width — 4 where ω starts on a
    16-byte boundary, else 1).  Raises ValueError on what it does not
    take.  It needs no card."""
    if n < 1:
        raise ValueError(f"n must be >= 1, got {n}")
    segs, seg_groups = trigger_segments(d)
    if n * segs > MAX_BLOCKS:
        raise ValueError(f"{n} rows × {segs} segments exceed the grid's "
                         f"{MAX_BLOCKS} blocks")
    return segs, seg_groups, 4 if omega_ptr % 16 == 0 else 1


def trigger_sq_norms_hbm_bytes(rows: int, dim: int) -> int:
    """Bytes one call must move: z read once, ω read once, (N,) written."""
    return 4 * (rows * dim + dim + rows)


def trigger_sq_norms_ref(z_prev: torch.Tensor,
                         omega: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: (N, D), (D,) → (N,) fp32."""
    diff = z_prev.to(torch.float32) - omega.to(torch.float32)[None]
    return torch.sum(diff * diff, dim=1)


def _kernel(z_prev: torch.Tensor, omega: torch.Tensor):
    """K1's kernel on one CUDA device: (the (N,) sums, whether a launch
    was made — none for N = 0 or D = 0).  The callers count."""
    n, d = z_prev.shape
    check_f32("z_prev", z_prev, (n, d))
    check_f32("omega", omega, (d,))
    out = torch.empty((n,), dtype=torch.float32, device=z_prev.device)
    if n == 0:
        return out, False
    if d == 0:
        return out.zero_(), False
    segs, seg_groups, w_vec = check_kernel_args(n, d, omega.data_ptr())
    with torch.cuda.device(z_prev.device):
        rc = load_library().fb_trigger_sq_norms(
            z_prev.data_ptr(), omega.data_ptr(), out.data_ptr(), n, d, segs,
            seg_groups, w_vec, stream_ptr(z_prev))
    check_launch("trigger_sq_norms", rc)
    return out, True


def trigger_sq_norms(z_prev: torch.Tensor,
                     omega: torch.Tensor) -> torch.Tensor:
    """(N, D) fp32, (D,) fp32 → (N,) fp32 squared distances.

    CPU tensors take the plain version; CUDA tensors launch the kernel
    (or raise).
    """
    if is_cpu(z_prev, omega):
        return trigger_sq_norms_ref(z_prev, omega)
    out, launched = _kernel(z_prev, omega)
    trigger_sq_norms.launches += launched
    return out


trigger_sq_norms.launches = 0


def trigger_sq_norms_sharded_ref(z_prev, omega) -> list[torch.Tensor]:
    """Plain version of K1b: K1's plain version on each shard."""
    return [trigger_sq_norms_ref(z, w)
            for z, w in zip(z_prev, omega, strict=True)]


def trigger_sq_norms_sharded(z_prev, omega, mesh) -> list[torch.Tensor]:
    """K1 per shard of a client mesh: ``z_prev`` the P per-shard (N/P, D)
    fp32 blocks and ``omega`` the P copies of the (D,) fp32 ω, shard i's
    on ``mesh.devices[i]`` → the P per-shard (N/P,) squared distances.

    One launch of K1's kernel per shard on its own rows (the plain
    version for a shard on the CPU); each launch counts here, not under
    K1.
    """
    check_shards(mesh, z_prev=z_prev, omega=omega)
    out = []
    for z, w in zip(z_prev, omega, strict=True):
        if is_cpu(z, w):
            out.append(trigger_sq_norms_ref(z, w))
            continue
        sq, launched = _kernel(z, w)
        trigger_sq_norms_sharded.launches += launched
        out.append(sq)
    return out


trigger_sq_norms_sharded.launches = 0

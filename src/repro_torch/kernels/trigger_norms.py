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

K1's leaf-table form (``csrc/fedback_kernels.cu::trigger_table_kernel``)
runs the same grid and the same order of the sum over a *virtual* row:
a table, built here by :func:`trigger_table_args` and passed by value
in the kernel's parameters, lists row blocks (shards) and, for each,
leaves — pointer, row stride, columns [begin, end) of the virtual row,
fp32 or bf16 — so every row's sum is bit-equal to K1's on the fp32
matrix that concatenating the leaves would build.  It serves:

* K1a: a bf16 z or ω in :func:`trigger_sq_norms` (one leaf; K1 counts);
* K1b, :func:`trigger_sq_norms_sharded`, which replaces
  ``trigger_norms.py::trigger_sq_norms_sharded`` (``shard_map`` of K1
  over the ``clients`` mesh axis): the shards are grouped by device
  and each device's shards go in one launch, one row block each, so P
  shards of one card make K1's N × S blocks and not P launches of N/P
  rows; every row keeps K1's bits on the whole (N, D) matrix;
* K1c, ``trigger_pytree.trigger_sq_norms_pytree`` (a stacked client
  tree read leaf by leaf in place).

The caller takes the square root (``core/fedback.py``).
"""
from __future__ import annotations

import ctypes
import dataclasses

import torch

from repro_torch.utils.spans import kernel_wrapper

from ._build import check_launch, load_library
from ._checks import check_f32, check_shards, is_cpu, refuse_grad, \
    stream_ptr


MAX_SEGMENTS = 8  # a thread-block cluster's portable maximum size
SEGMENT_MIN_GROUPS = 2048  # groups of 4 a segment takes before a row splits
MAX_BLOCKS = 2**31 - 1  # the grid's x dimension
# The leaf table travels in the kernel's parameters, which CUDA 12.1 and
# later cap at 32,764 bytes on sm_70 and above.  The largest table
# instance (csrc/fedback_kernels.cu::fb_trigger_sq_norms_table) holds
# 64 row blocks and 640 leaves in all (shards × leaves): 31,272 bytes.
PARAM_BYTES = 32764
TABLE_MAX_SHARDS = 64
TABLE_MAX_ENTRIES = 640
# The dtypes the kernels read, and a leaf's dtype bits in the table.
TRIGGER_DTYPES = (torch.float32, torch.bfloat16)
Z_BF16, W_BF16 = 1, 2


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


@dataclasses.dataclass(frozen=True)
class TriggerTable:
    """One launch of the leaf-table kernel: ``rows`` the row offsets of
    its row blocks (block s owns output rows [rows[s], rows[s+1])),
    ``leaves`` block-major entries of 6 ints (z pointer, ω pointer, z's
    row stride in elements, begin, end — the leaf's columns in the
    virtual row — and its dtype bits ``Z_BF16 | W_BF16``), ``d`` the
    virtual row's width, and K1's (S, G) of it."""

    rows: tuple[int, ...]
    leaves: tuple[tuple[int, ...], ...]
    n_leaves: int
    d: int
    segs: int
    seg_groups: int


def leaf_view(x: torch.Tensor, *shape: int) -> tuple[torch.Tensor, bool]:
    """``x`` in ``shape`` — (n, -1) for a stacked z leaf, (-1,) for an ω
    leaf — as the table kernel reads it in place: a view whose last dim
    has unit stride (the rows at any stride), else a contiguous copy.
    Returns (the tensor, whether it is a copy)."""
    try:
        v = x.view(shape)
    except RuntimeError:  # the dims cannot be merged without a copy
        return x.reshape(shape).contiguous(), True
    if v.shape[-1] > 1 and v.stride(-1) != 1:
        return v.contiguous(), True
    return v, False


def _dtype_bits(name: str, z: torch.Tensor, w: torch.Tensor) -> int:
    for label, t in ((f"{name} z", z), (f"{name} omega", w)):
        if t.dtype not in TRIGGER_DTYPES:
            raise TypeError(f"{label}: expected float32 or bfloat16, got "
                            f"{t.dtype}")
    return ((Z_BF16 if z.dtype == torch.bfloat16 else 0)
            | (W_BF16 if w.dtype == torch.bfloat16 else 0))


def trigger_table_args(blocks) -> TriggerTable:
    """The table of one launch over ``blocks``, a sequence of row blocks
    (shards) each given as (z leaves, ω leaves): z leaf l an (n_s, w_l)
    matrix with unit inner stride, ω leaf l a (w_l,) vector with unit
    stride (:func:`leaf_view` gives both), fp32 or bf16.
    Every block has the same leaf widths; leaf l covers the columns
    [o_l, o_l + w_l) of the virtual row, o_l = Σ_{k<l} w_k, as in the
    concatenation.  Raises ValueError on a table that does not fit the
    kernel's parameters or mismatched blocks, TypeError on another
    dtype.  Needs no card."""
    if not blocks:
        raise ValueError("a trigger table needs at least one row block")
    n_leaves = len(blocks[0][0])
    if n_leaves == 0:
        raise ValueError("a row block needs at least one leaf")
    entries = len(blocks) * n_leaves
    if len(blocks) > TABLE_MAX_SHARDS or entries > TABLE_MAX_ENTRIES:
        raise ValueError(
            f"a trigger table of {len(blocks)} row blocks × {n_leaves} "
            f"leaves exceeds the kernel's parameters (CUDA caps them at "
            f"{PARAM_BYTES} bytes; a table holds at most "
            f"{TABLE_MAX_SHARDS} row blocks and {TABLE_MAX_ENTRIES} "
            "leaves in all)")
    widths = [w.shape[0] for w in blocks[0][1]]
    rows, leaves = [0], []
    for s, (zs, ws) in enumerate(blocks):
        if len(zs) != n_leaves or len(ws) != n_leaves:
            raise ValueError(f"row block {s} has {len(zs)} z and {len(ws)} "
                             f"omega leaves, block 0 {n_leaves}")
        n = zs[0].shape[0]
        begin = 0
        for l, (z, w) in enumerate(zip(zs, ws, strict=True)):
            if w.dim() != 1 or w.shape[0] != widths[l] or \
                    (w.shape[0] > 1 and w.stride(0) != 1):
                raise ValueError(f"row block {s}, leaf {l}: omega must be a "
                                 f"({widths[l]},) vector with unit stride, "
                                 f"got {tuple(w.shape)}")
            if z.dim() != 2 or tuple(z.shape) != (n, widths[l]) or \
                    (z.shape[1] > 1 and z.stride(1) != 1):
                raise ValueError(f"row block {s}, leaf {l}: z must be an "
                                 f"({n}, {widths[l]}) matrix with unit inner "
                                 f"stride, got {tuple(z.shape)}")
            end = begin + widths[l]
            leaves.append((z.data_ptr(), w.data_ptr(), z.stride(0), begin,
                           end, _dtype_bits(f"row block {s}, leaf {l}", z,
                                            w)))
            begin = end
        rows.append(rows[-1] + n)
    d = sum(widths)
    segs, seg_groups = trigger_segments(max(d, 1))
    if rows[-1] * segs > MAX_BLOCKS:
        raise ValueError(f"{rows[-1]} rows × {segs} segments exceed the "
                         f"grid's {MAX_BLOCKS} blocks")
    return TriggerTable(tuple(rows), tuple(leaves), n_leaves, d, segs,
                        seg_groups)


def table_kernel(blocks, device: torch.device):
    """The leaf-table kernel over ``blocks`` (as :func:`trigger_table_args`
    takes them), all on the CUDA ``device``, in one launch: (the
    per-block (n_s,) sums, views of one output, whether a launch was
    made — none for 0 rows or D = 0).  The callers count.  The caller
    keeps the leaves alive until the launch has run (stream order)."""
    table = trigger_table_args(blocks)
    out = torch.empty((table.rows[-1],), dtype=torch.float32, device=device)
    parts = list(out.split([b - a for a, b in zip(table.rows[:-1],
                                                 table.rows[1:],
                                                 strict=True)]))
    if table.rows[-1] == 0:
        return parts, False
    if table.d == 0:
        out.zero_()
        return parts, False
    rows = (ctypes.c_int64 * len(table.rows))(*table.rows)
    words = [x for leaf in table.leaves for x in leaf]
    leaves = (ctypes.c_int64 * len(words))(*words)
    with torch.cuda.device(device):
        rc = load_library().fb_trigger_sq_norms_table(
            rows, len(table.rows) - 1, leaves, table.n_leaves, table.d,
            table.segs, table.seg_groups, out.data_ptr(), stream_ptr(out))
    check_launch("trigger_sq_norms (leaf table)", rc)
    return parts, True


def group_by_device(tensors) -> dict:
    """{device: the indices of ``tensors`` on it}, devices in order of
    first appearance, indices in order: the launches of a sharded call,
    one per device."""
    groups = {}
    for i, t in enumerate(tensors):
        groups.setdefault(t.device, []).append(i)
    return groups


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


def _table_operands(name, z_prev, omega):
    """K1a's and K1b's row block: a contiguous (n, D) z and (D,) ω,
    fp32 or bf16."""
    n, d = z_prev.shape
    check_f32(f"{name} z_prev", z_prev, (n, d), TRIGGER_DTYPES)
    check_f32(f"{name} omega", omega, (d,), TRIGGER_DTYPES)
    return [z_prev], [omega]


@kernel_wrapper("trigger_sq_norms")
def trigger_sq_norms(z_prev: torch.Tensor,
                     omega: torch.Tensor) -> torch.Tensor:
    """(N, D), (D,) → (N,) fp32 squared distances; z and ω fp32 or bf16.

    CPU tensors take the plain version; CUDA tensors launch the kernel
    (or raise): K1's for fp32 z and ω, else (K1a) its leaf-table form on
    one leaf, whose bits are K1's on fp32 copies.
    """
    refuse_grad("trigger_sq_norms", z_prev, omega)
    if is_cpu(z_prev, omega):
        return trigger_sq_norms_ref(z_prev, omega)
    if z_prev.dtype == omega.dtype == torch.float32:
        out, launched = _kernel(z_prev, omega)
    else:
        parts, launched = table_kernel(
            [_table_operands("trigger_sq_norms", z_prev, omega)],
            z_prev.device)
        out = parts[0]
    trigger_sq_norms.launches += launched
    return out


trigger_sq_norms.launches = 0


def trigger_sq_norms_sharded_ref(z_prev, omega) -> list[torch.Tensor]:
    """Plain version of K1b: K1's plain version on each shard."""
    return [trigger_sq_norms_ref(z, w)
            for z, w in zip(z_prev, omega, strict=True)]


@kernel_wrapper("trigger_sq_norms_sharded")
def trigger_sq_norms_sharded(z_prev, omega, mesh) -> list[torch.Tensor]:
    """K1 per shard of a client mesh: ``z_prev`` the P per-shard (N/P, D)
    blocks and ``omega`` the P copies of the (D,) ω (fp32 or bf16),
    shard i's on ``mesh.devices[i]`` → the P per-shard (N/P,) squared
    distances.

    The shards are grouped by device: one launch of the leaf-table
    kernel per card over all its shards, one row block each (the plain
    version for the shards on the CPU); each launch counts here, not
    under K1.
    """
    refuse_grad("trigger_sq_norms_sharded", z_prev, omega)
    check_shards(mesh, z_prev=z_prev, omega=omega)
    out = [None] * mesh.size
    for dev, idx in group_by_device(z_prev).items():
        if is_cpu(*(z_prev[i] for i in idx), *(omega[i] for i in idx)):
            for i in idx:
                out[i] = trigger_sq_norms_ref(z_prev[i], omega[i])
            continue
        parts, launched = table_kernel(
            [_table_operands(f"trigger_sq_norms_sharded shard {i}",
                             z_prev[i], omega[i]) for i in idx], dev)
        trigger_sq_norms_sharded.launches += launched
        for i, part in zip(idx, parts, strict=True):
            out[i] = part
    return out


trigger_sq_norms_sharded.launches = 0

"""Compressed consensus: quantized z-deltas with error feedback.

Port of ``repro/core/compress.py``.  With ``FLConfig.consensus_compress
∈ {"bf16", "int8"}`` the round's consensus aggregation goes through an
error-feedback compressed wire instead of the fp32 mean:

    δ_i  = z_i − ω_prev + e_i        z-delta with residual carry-in
    t_i  = Q(δ_i)                    level-1 per-client quantization
    e_i⁺ = δ_i − D(t_i)              client residual (FLState.comm)
    ω⁺   = ω_prev + (Σ_i D(t_i)) / denom   via the compressed wire

The residual ``e`` is the client-stacked (N, D) fp32 matrix
``FLState.comm`` (flat layout only).  Level 2 re-quantizes each client
shard's partial sum for the wire between shards: int8 codes under a
scale shared by every shard (the block maxima's max over shards), clipped
to ±⌊127/P⌋ so that the codes' sum over P shards cannot overflow, or the
partial's bf16 bits.  Each shard's wire error folds back into its
transmitting rows' residuals (1/m each), so one residual conserves both
levels:  Σ_i e_i⁺ + Σ transmitted == Σ_i δ_i.

Under a client mesh (``mesh=``, a :class:`~repro_torch.sharding.
ClientMesh`) the client-stacked arguments are shard lists; each shard
works on its own device, the maxima, the int8 codes and the bf16
partials go to shard 0's device, where they are combined in shard order
(``engine.all_sum``), and ω⁺ comes back on shard 0's device.  One device
is the one-shard case of the same code.

Every operation is elementwise, a max or the column sum, so the port
gives the reference's bits where it takes XLA's CPU order:

* the column sum ``jnp.sum(d, axis=0)`` is ``compact.
  sum_in_xla_cpu_order`` (windows of 32 over the client axis);
* XLA rewrites ``max|x| / 127`` as ``max|x| · fp32(1/127)`` and a
  division by the constant client count as a product with its fp32
  reciprocal;
* XLA contracts four products into FMAs — ``ω + total·(1/N)``,
  ``δ − codes·scale``, ``p − codes·scale`` (the wire error) and
  ``e + werr·(1/m)`` — emulated here in float64, where the product of
  two fp32 values is exact and the sum is rounded once.

XLA leaves the last D mod 8 columns of its vectorised loops uncontracted
on the machine measured (ROADMAP D6), so there the residual can differ by
a few ulp.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.sharding.clients import collectives
from repro_torch.utils.spans import span

from .compact import sum_in_xla_cpu_order
from .engine import all_sum

#: Supported ``FLConfig.consensus_compress`` values.
MODES = ("none", "bf16", "int8")

#: Symmetric int8 code range; level 2 divides it by the shard count so
#: the codes' sum over shards can never overflow.
INT8_CLIP = 127

#: Wire bytes per model coordinate by mode.
WIRE_BYTES = {"none": 4, "bf16": 2, "int8": 1}


def check_mode(mode: str) -> str:
    if mode not in MODES:
        raise ValueError(
            f"consensus_compress must be one of {MODES}, got {mode!r}")
    return mode


def block_layout(dim: int, block: int) -> tuple[int, int]:
    """(n_blocks, block_size) of the per-block int8 scale layout; the
    block is clamped to the vector length, so padding is at most
    block − 1 zeros."""
    b = max(1, min(int(block), int(dim)))
    return -(-int(dim) // b), b


def _blocked(x: torch.Tensor, block: int) -> torch.Tensor:
    """(..., D) → (..., nb, B), zero-padded past D."""
    nb, b = block_layout(x.shape[-1], block)
    pad = nb * b - x.shape[-1]
    if pad:
        x = torch.nn.functional.pad(x, (0, pad))
    return x.reshape(x.shape[:-1] + (nb, b))


def _unblocked(xb: torch.Tensor, dim: int) -> torch.Tensor:
    return xb.reshape(xb.shape[:-2] + (-1,))[..., :dim]


def _recip(n) -> float:
    """fp32(1/n), the constant XLA multiplies by for ``/ n``."""
    return float(np.float32(1.0) / np.float32(n))  # tracecheck: ok — n static


def _fma(a, b, c) -> torch.Tensor:
    """fp32 a·b + c rounded once (XLA's contraction): the product of
    two fp32 values is exact in float64 (in the span ``compress/fma``,
    the float64 ops the static-invariant checker allows, ROADMAP D6)."""
    with span("compress/fma"):
        a = a.double() if isinstance(a, torch.Tensor) else a
        b = b.double() if isinstance(b, torch.Tensor) else b
        return (a * b + c.double()).to(torch.float32)


def _codes(xb: torch.Tensor, scale: torch.Tensor, clip: int):
    """(codes as fp32 values, safe scale): round(x / safe) clipped."""
    safe = torch.where(scale > 0, scale, torch.ones_like(scale))
    codes = torch.clamp(torch.round(xb / safe[..., None]), -clip, clip)
    return codes, safe


def int8_quantize(x: torch.Tensor, *, block: int = 256,
                  clip: int = INT8_CLIP):
    """Per-block symmetric int8 codes and fp32 scales: codes (..., nb,
    B) int8 (zero-padded past D), scales (..., nb) = blockwise max|x| ·
    fp32(1/clip).  An all-zero block gets zero codes and scale 0."""
    xb = _blocked(x, block)
    scale = torch.amax(torch.abs(xb), dim=-1) * _recip(clip)
    codes, _ = _codes(xb, scale, clip)
    return codes.to(torch.int8), scale


def int8_dequantize(codes: torch.Tensor, scales: torch.Tensor,
                    dim: int) -> torch.Tensor:
    """Inverse of :func:`int8_quantize`: (..., nb, B) codes → (..., D)."""
    return _unblocked(codes.to(torch.float32) * scales[..., None], dim)


def quantize_dequantize(x: torch.Tensor, mode: str, *,
                        block: int = 256) -> torch.Tensor:
    """The level-1 transmit operator D(Q(x)), fp32 → fp32 through the
    wire dtype: exact for ``none``, one bf16 rounding (≤ 2⁻⁸·|x|) for
    ``bf16``, at most half a scale step for ``int8``."""
    if mode == "none":
        return x
    if mode == "bf16":
        return x.to(torch.bfloat16).to(torch.float32)
    codes, scales = int8_quantize(x, block=block)
    return int8_dequantize(codes, scales, x.shape[-1])


def _level1(delta: torch.Tensor, mode: str, block: int):
    """(D(Q(δ)), δ − D(Q(δ)), (codes, scales) or None), the blocked
    (n, nb, B) int8 codes as fp32 values and their (n, nb, 1) scales kept
    for the column sum; the residual contracted for int8."""
    if mode != "int8":
        d = quantize_dequantize(delta, mode, block=block)
        return d, delta - d, None
    dim = delta.shape[-1]
    xb = _blocked(delta, block)
    scale = (torch.amax(torch.abs(xb), dim=-1) * _recip(INT8_CLIP))[..., None]
    codes, _ = _codes(xb, scale[..., 0], INT8_CLIP)
    return (_unblocked(codes * scale, dim),
            _unblocked(_fma(-codes, scale, xb), dim), (codes, scale))


def _column_sum(d: torch.Tensor, quant, masked: bool,
                mode: str) -> torch.Tensor:
    """Σ_i d_i over a shard's rows in XLA's CPU order (ROADMAP D6).

    Above 32 rows XLA sums windows of 32 (:func:`sum_in_xla_cpu_order`)
    of the rounded products.  Up to 32 rows the sum fuses with the
    dequantization, and LLVM vectorises it over the rows: from 16 rows,
    eight-row groups accumulate lane by lane (the first group's values,
    then each later group added in order), the eight lanes reduce as a
    halving tree and the remaining rows are added one by one; below 16
    rows the rows are added in order.  Each int8 product ``codes·scale``
    (``quant``) is contracted into its add (an FMA), except when rows are
    ``masked`` (the participant mean: d is already zero where a row does
    not send)."""
    n = d.shape[0]
    if n > 32 or mode == "none":
        return sum_in_xla_cpu_order(d)
    contracted = quant is not None and not masked
    if contracted:
        codes, scale = quant

        def add(rows, acc):
            return _fma(codes[rows], scale[rows], acc)
    else:
        def add(rows, acc):
            return d[rows] + acc
    shape = codes.shape[1:] if contracted else d.shape[1:]
    acc = torch.zeros(shape, dtype=torch.float32, device=d.device)
    if n < 16:
        for j in range(n):
            acc = add(j, acc)
    else:
        lanes = add(slice(0, 8), acc.expand((8,) + shape))
        for k in range(8, n - 7, 8):
            lanes = add(slice(k, k + 8), lanes)
        half = lanes[:4] + lanes[4:]
        quarter = half[:2] + half[2:]
        acc = quarter[0] + quarter[1]
        for j in range(n - n % 8, n):
            acc = add(j, acc)
    return _unblocked(acc, d.shape[-1]) if contracted else acc


def _wire_int8_codes(partials, block: int):
    """The level-2 int8 codes of the shards' (D,) partial sums: one scale
    per block shared by every shard (the max over shards of their block
    maxima, on shard 0's device), codes clipped to ±⌊127/P⌋.  Returns
    (the blocked partials, each shard's codes as fp32 values, the
    scale)."""
    pbs = [_blocked(p, block) for p in partials]
    dev0 = pbs[0].device
    gmax = pbs[0].abs().amax(dim=-1)
    maxima = [pb.abs().amax(dim=-1) for pb in pbs[1:]]
    collectives.add("all-gather", maxima)
    for m in maxima:
        gmax = torch.maximum(gmax, m.to(dev0, non_blocking=True))
    clip = INT8_CLIP // len(partials)
    scale = gmax * _recip(clip)
    collectives.add("broadcast", [scale] * (len(pbs) - 1))
    codes = [_codes(pb, scale.to(pb.device, non_blocking=True), clip)[0]
             for pb in pbs]
    return pbs, codes, scale


def _wire_int8(partials, block: int):
    """Level-2 int8 wire: the codes of :func:`_wire_int8_codes` summed
    over shards in shard order (no overflow: |code| ≤ ⌊127/P⌋).
    Returns (the dequantized total on shard 0's device, each shard's
    wire error p − codes·scale)."""
    dim = partials[0].shape[-1]
    pbs, codes, scale = _wire_int8_codes(partials, block)
    safe = torch.where(scale > 0, scale, torch.ones_like(scale))
    collectives.add("broadcast", [safe] * (len(pbs) - 1))
    werrs = [_unblocked(_fma(-c, safe.to(pb.device, non_blocking=True)[
        ..., None], pb), dim) for pb, c in zip(pbs, codes, strict=True)]
    total = all_sum([c.to(torch.int8) for c in codes]).to(
        torch.float32) * safe[..., None]
    return _unblocked(total, dim), werrs


def _wire_bf16(partials):
    """Level-2 bf16 wire: each shard's partial sent as its bf16 bits (2
    bytes a coordinate) and the fp32 values summed in shard order on
    shard 0's device.  Returns (total, each shard's wire error)."""
    sent = [p.to(torch.bfloat16) for p in partials]
    werrs = [p - s.to(torch.float32) for p, s in zip(partials, sent,
                                                     strict=True)]
    if len(sent) == 1:
        return sent[0].to(torch.float32), werrs
    dev0 = sent[0].device
    collectives.add("all-gather", sent[1:])
    vals = torch.stack([s.to(dev0, non_blocking=True) for s in sent])
    return sum_in_xla_cpu_order(vals.to(torch.float32)), werrs


def _level1_shards(zs, omega, resids, masks, mode: str, block: int):
    """Level 1 on every shard: (the partial sums, the residuals before
    the wire error, 1/m or m per shard, the level-1 (codes, scales) or
    None per shard)."""
    parts, resid1s, m_locs, quants = [], [], [], []
    collectives.add("broadcast", [omega] * (len(zs) - 1))
    for i, (z, e) in enumerate(zip(zs, resids, strict=True)):
        delta = z - omega.to(z.device, non_blocking=True)[None] + e
        d, r1, quant = _level1(delta, mode, block)
        mask = None if masks is None else masks[i]
        if mask is None:
            m_locs.append(_recip(z.shape[0]))
        else:
            mz = mask[:, None]
            d = torch.where(mz, d, torch.zeros((), device=d.device))
            r1 = torch.where(mz, r1, e)
            m_locs.append(torch.clamp(torch.sum(mask.to(torch.float32)),
                                      min=1.0))
        parts.append(_column_sum(d, quant, mask is not None, mode))
        resid1s.append(r1)
        quants.append(quant if mode == "int8" else d)
    return parts, resid1s, m_locs, quants


def _ef(zs, omega, resids, masks, denom, *, mode: str, block: int):
    """The EF aggregation over shard lists (one entry per shard).

    zs, resids: per-shard (n_loc, D) fp32; omega: (D,) on shard 0's
    device; masks: per-shard (n_loc,) bool transmitters, or None (every
    row: the ADMM family); denom: the client count N (a Python int) or,
    with masks, the () int32 count of committed clients.  Returns (ω⁺ on
    shard 0's device, the per-shard residuals)."""
    parts, resid1s, m_locs, _ = _level1_shards(zs, omega, resids, masks,
                                               mode, block)
    if mode == "int8":
        total, werrs = _wire_int8(parts, block)
    elif mode == "bf16":
        total, werrs = _wire_bf16(parts)
    else:  # the exact wire: the EF identity's check path
        total = all_sum(parts)
        werrs = [torch.zeros_like(p) for p in parts]
    # Each shard's wire error folds back into its transmitting rows'
    # residuals, 1/m each; a shard with no transmitter sent p = 0.
    resids_new = []
    for i, (r1, werr, m) in enumerate(zip(resid1s, werrs, m_locs,
                                          strict=True)):
        if masks is None:
            resids_new.append(_fma(werr[None], m, r1))
        else:
            resids_new.append(torch.where(masks[i][:, None],
                                          r1 + werr[None] / m, r1))
    if masks is None:
        return _fma(total, _recip(denom), omega), resids_new
    denom_f = torch.clamp(denom.to(torch.float32), min=1.0)
    return torch.where(denom > 0, omega + total / denom_f, omega), resids_new


def _shard_args(mesh, *xs):
    if mesh is None:
        return [[x] for x in xs]
    if any(not isinstance(x, (list, tuple)) or len(x) != mesh.size
           for x in xs):
        raise ValueError(f"with mesh= pass one tensor per shard "
                         f"({mesh.size})")
    return [list(x) for x in xs]


def ef_consensus(z, omega, resid, *, mode: str, block: int = 256,
                 mesh=None):
    """EF-compressed consensus mean (ADMM family, Eq. 2.4):
    ω⁺ = ω + (1/N) Σ_i D(Q(z_i − ω + e_i)).  z, resid: (N, D) fp32 (with
    ``mesh``, one (N/P, D) tensor per shard); omega: (D,).  Mode
    ``"none"`` is the exact mean with e ≡ 0.  Returns (ω⁺, the new
    residual: a tensor, or with ``mesh`` one per shard)."""
    check_mode(mode)
    zs, rs = _shard_args(mesh, z, resid)
    n = sum(x.shape[0] for x in zs)
    omega_new, resids = _ef(zs, omega, rs, None, n, mode=mode, block=block)
    return omega_new, (resids if mesh is not None else resids[0])


def ef_participant_mean(z, committed, omega, resid, num_committed, *,
                        mode: str, block: int = 256, mesh=None):
    """EF-compressed participant mean (FedAvg/FedProx):
    ω⁺ = ω + (1/|committed|) Σ_{i∈committed} D(Q(z_i − ω + e_i)); ω
    unchanged, and nothing sent, when no client committed; the other
    rows keep their residuals.  ``committed`` (N,) bool (with ``mesh``,
    per shard), ``num_committed`` its () int32 count on ω's device."""
    check_mode(mode)
    zs, ms, rs = _shard_args(mesh, z, committed, resid)
    omega_new, resids = _ef(zs, omega, rs, ms, num_committed, mode=mode,
                            block=block)
    return omega_new, (resids if mesh is not None else resids[0])


def _bf16_ulp(x: torch.Tensor) -> torch.Tensor:
    """The spacing of bf16 values at each (bf16-valued) x: 2^(e − 8) for
    |x| = m·2^e, m ∈ [0.5, 1); the subnormal spacing at 0."""
    _, e = torch.frexp(x)
    return torch.where(x == 0, 2.0 ** -133,
                       torch.ldexp(torch.ones_like(x), e - 8))


def ef_codes(z, omega, resid, committed=None, *, mode: str,
             block: int = 256, mesh=None) -> dict:
    """What each coordinate is sent as, for holding two runs apart: per
    shard, ``codes1`` (n_loc, D) and ``step1`` — the level-1 int8 codes
    and their block's scale, or the bf16 values and their spacing (one
    bf16 ulp) — and ``codes2`` / ``step2`` (D,), the same for the
    shard's partial sum on the wire.  Where two runs' codes differ,
    their ω and residuals may differ by that step (÷ N in ω, ÷ m in a
    residual for level 2); ``committed`` as for
    :func:`ef_participant_mean` (None: every row sends)."""
    check_mode(mode)
    if mode == "none":
        raise ValueError("mode 'none' sends exact values")
    args = [z, resid] + ([] if committed is None else [committed])
    zs, rs, *ms = _shard_args(mesh, *args)
    parts, _, _, quants = _level1_shards(zs, omega, rs, ms[0] if ms else
                                         None, mode, block)
    dim = zs[0].shape[-1]
    if mode == "bf16":
        codes1 = list(quants)
        codes2 = [p.to(torch.bfloat16).to(torch.float32) for p in parts]
        return {"codes1": codes1, "step1": [_bf16_ulp(c) for c in codes1],
                "codes2": codes2, "step2": [_bf16_ulp(c) for c in codes2]}
    _, codes2, scale = _wire_int8_codes(parts, block)
    return {
        "codes1": [_unblocked(c, dim) for c, _ in quants],
        "step1": [_unblocked(torch.ones_like(c) * s, dim)
                  for c, s in quants],
        "codes2": [_unblocked(c, dim) for c in codes2],
        "step2": [_unblocked(torch.ones_like(c) * scale.to(c.device)[
            ..., None], dim) for c in codes2]}


def init_residual(n_clients: int, dim: int, device=None) -> torch.Tensor:
    """Zero-initialised client EF residual (``FLState.comm``) on
    ``device`` (CUDA unless another is passed)."""
    return torch.zeros((n_clients, dim), dtype=torch.float32,
                       device=resolve_device(device))


def consensus_wire_bytes(dim: int, *, mode: str = "none", block: int = 256,
                         world_size: int = 1) -> dict:
    """Modelled per-device link bytes of one consensus aggregation (the
    reference's ring model: an all-reduce moves 2·bytes·(n−1)/n per
    device, an all-gather output_bytes·(n−1)/n).  ``payload`` is the
    z-term, ``overhead`` the int8 shared-scale max, ``uplink`` the bytes
    one client's transmit occupies."""
    check_mode(mode)
    w = WIRE_BYTES[mode]
    nb, _ = block_layout(dim, block)
    frac = (world_size - 1) / world_size if world_size > 1 else 0.0
    if mode == "bf16":
        payload = world_size * dim * 2 * frac
    else:
        payload = 2.0 * dim * w * frac
    overhead = 2.0 * nb * 4 * frac if mode == "int8" else 0.0
    uplink = dim * w + (nb * 4 if mode == "int8" else 0)
    return {
        "payload_link_bytes": payload,
        "overhead_link_bytes": overhead,
        "total_link_bytes": payload + overhead,
        "uplink_bytes_per_client": uplink,
    }

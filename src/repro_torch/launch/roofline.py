"""Roofline model of one NVIDIA H100 (the twin of
``repro/launch/roofline.py``, with its names).

Hardware model: H100 SXM5 80 GB (NVIDIA H100 Tensor Core GPU data
sheet, dense rates without sparsity, at the 700 W power limit)::

    compute term    = flops / PEAK_FLOPS        (bf16 tensor cores)
    memory term     = bytes / HBM_BW            (HBM3)
    collective term = link bytes / LINK_BW      (NVLink 4, one way)

The reference prices a TPU v5e (197 TFLOP/s, 819 GB/s, 50 GB/s a link,
PCIe gen4 32 GB/s); every byte model here is the reference's line for
line, and every time is the reference's times the ratio of its constant
to the one here.  :func:`roofline_terms` takes counted FLOPs, bytes
and collective bytes (``launch/dryrun.py`` counts them on the meta
device) where the reference reads XLA's cost analysis and HLO text.

The by-card tables (``PEAK_BYTES_PER_S``, ``PEAK_BF16_FLOPS``,
``PEAK_TF32_FLOPS_BY_CARD``) give the same rates for the H100 variants a
measurement may land on, matched by a substring of
``torch.cuda.get_device_name`` (the first match wins, so the NVL and
PCIe rows come before the plain "H100"); ``chip_smoke.py`` and
``time_kernels.py`` read their kernel bounds from them.  This module
imports nothing at its top but the standard library: ``time_kernels.py``
loads it by its path beside that file, whatever tree it times.
"""
from __future__ import annotations

from typing import Any

# H100 SXM5 (NVIDIA H100 data sheet): dense bf16/fp16 tensor cores.
PEAK_FLOPS = 989e12
# H100 SXM5 (data sheet): dense TF32 tensor cores.
PEAK_TF32_FLOPS = 494.7e12
# H100 SXM5 (data sheet): fp32 outside the tensor cores (the port's
# fp32 products run in full fp32: TF32 is off).
PEAK_FP32_FLOPS = 67e12
# H100 SXM5 (data sheet): 80 GB HBM3 at 3.35 TB/s.
HBM_BW = 3.35e12
# NVLink 4 (data sheet): 900 GB/s per card in both directions together,
# 18 links; 450 GB/s each way is what one device sends in a ring step.
LINK_BW = 450e9
# PCIe Gen5 x16 (PCI-SIG: 32 GT/s a lane, 128b/130b), 64 GB/s each way
# nominal, host <-> device.
PCIE_BW = 64e9

# By card name (NVIDIA data sheets); the first key found in the name.
PEAK_BYTES_PER_S = (("H100 NVL", 3.9e12), ("H100 PCIe", 2.0e12),
                    ("H100", 3.35e12), ("H200", 4.8e12))
PEAK_BF16_FLOPS = (("H100 NVL", 835e12), ("H100 PCIe", 756e12),
                   ("H100", 989e12), ("H200", 989e12))
# The rate of the 3xTF32 fp32 instance of K4, which does three products.
PEAK_TF32_FLOPS_BY_CARD = (("H100 NVL", 417.5e12), ("H100 PCIe", 378e12),
                           ("H100", 494.7e12), ("H200", 494.7e12))


def peak_for(table, name: str):
    """The value of the first key of ``table`` found in ``name``, or
    None for a card the table does not name."""
    for key, value in table:
        if key in name:
            return value
    return None


def peak_bandwidth(name: str):
    return peak_for(PEAK_BYTES_PER_S, name)


def card_peaks(name: str) -> dict[str, float | None]:
    """The rates of the card called ``name``: HBM bytes/s, bf16, TF32
    and fp32 FLOP/s (fp32 is the SXM part's for every H100 row)."""
    return {"hbm_bytes_per_s": peak_bandwidth(name),
            "bf16_flops": peak_for(PEAK_BF16_FLOPS, name),
            "tf32_flops": peak_for(PEAK_TF32_FLOPS_BY_CARD, name),
            "fp32_flops": PEAK_FP32_FLOPS}


def model_flops_per_device(cfg, *, mode: str, batch: int, seq: int,
                           n_chips: int, active_params: int,
                           local_steps: int = 1) -> float:
    """6·N·D (train: fwd+bwd) / 2·N·D (inference fwd) per device."""
    if mode == "train":
        tokens = batch * seq * local_steps
        factor = 6.0
    elif mode == "prefill":
        tokens = batch * seq
        factor = 2.0
    else:  # decode: one token per sequence
        tokens = batch * 1
        factor = 2.0
    return factor * active_params * tokens / n_chips


def roofline_terms(flops: float, bytes_hbm: float,
                   collective_bytes: float = 0.0, *,
                   collectives: dict | None = None,
                   peak_flops: float = PEAK_FLOPS, hbm_bw: float = HBM_BW,
                   link_bw: float = LINK_BW) -> dict[str, Any]:
    """The three terms of one device's program from its counted FLOPs,
    HBM bytes and collective link bytes, at ``peak_flops`` / ``hbm_bw``
    / ``link_bw`` (the H100 SXM's by default).  The keys are the
    reference's, so one schema serves both packages' records; the
    ``hlo_`` names are kept for that schema, though here the numbers are
    counted on the meta device, not read from HLO.  ``collectives`` is
    the per-kind inventory ({kind: {"count", "bytes", "raw_bytes"}}),
    empty on one card."""
    flops, bytes_hbm = float(flops), float(bytes_hbm)
    coll = float(collective_bytes)
    t_c = flops / peak_flops
    t_m = bytes_hbm / hbm_bw
    t_x = coll / link_bw
    terms = {"compute_s": t_c, "memory_s": t_m, "collective_s": t_x}
    dominant = max(terms, key=terms.get)
    return {
        **terms,
        "hlo_flops_per_device": flops,
        "hlo_bytes_per_device": bytes_hbm,
        "collective_bytes_per_device": coll,
        "dominant": dominant.replace("_s", ""),
        "bound_time_s": max(t_c, t_m, t_x),
        "collectives": dict(collectives or {}),
    }


def fedback_round_hbm_bytes(n_clients: int, solver_rows: int, dim: int,
                            *, data_bytes_per_client: int = 0,
                            dtype_bytes: int = 4,
                            fused: bool = False) -> dict[str, int]:
    """Modeled per-round HBM traffic of the flat FedBack round engine
    (the reference's model, line for line).

    The server side is irreducibly O(N·D): one trigger read of z_prev,
    one consensus read, and one commit write per state field (θ, λ,
    z_prev).  Everything client-side flows through the capacity slots —
    ``solver_rows`` is N on the dense path and C = ⌈slack·L̄·N⌉ on the
    compacted path: the λ⁺/center pass (K2's with_z=False form, 2 reads
    + 2 writes per row), the post-solve z = θ_out + λ⁺ assembly (2
    reads + 1 write) and the gathered data shards.  With ``fused=True``
    the solver-state term is the reference's fused model, 10·rows·D +
    2·D elements: the pre-solve center pass (2 row reads, 1 write, ω)
    and one commit pass — K3's bytes (``fused_gss_hbm_bytes``) plus the
    z_prev read the reference's Pallas commit makes and K3 does not, so
    that the two packages' models stay one number.
    """
    server = (1 + 1 + 3) * n_clients * dim * dtype_bytes
    if fused:
        from repro_torch.kernels.fused_gss import fused_gss_hbm_bytes
        presolve = (3 * solver_rows * dim + dim) * dtype_bytes
        solver_state = (fused_gss_hbm_bytes(solver_rows, dim, with_z=True,
                                            dtype_bytes=dtype_bytes)
                        + solver_rows * dim * dtype_bytes + presolve)
    else:
        from repro_torch.kernels.admm_update import admm_update_hbm_bytes
        solver_state = (admm_update_hbm_bytes(solver_rows, dim,
                                              with_z=False,
                                              dtype_bytes=dtype_bytes)
                        + 3 * solver_rows * dim * dtype_bytes)
    solver_data = solver_rows * data_bytes_per_client
    return {
        "server_bytes": server,
        "solver_state_bytes": solver_state,
        "solver_data_bytes": solver_data,
        "solver_bytes": solver_state + solver_data,
        "total_bytes": server + solver_state + solver_data,
    }


def fedback_ragged_round_hbm_bytes(n_clients: int, solver_rows: int,
                                   dim: int, *, sizes,
                                   row_bytes: int,
                                   dtype_bytes: int = 4) -> dict[str, int]:
    """Ragged variant of :func:`fedback_round_hbm_bytes`: the dense
    ragged round streams every client's CSR slice once (Σnᵢ·row_bytes);
    the compacted round slices one static ``max(nᵢ)``-row block per
    capacity slot (``solver_rows · max(nᵢ) · row_bytes``).  ``sizes``
    the per-client row counts, ``row_bytes`` one data row (x and y)."""
    base = fedback_round_hbm_bytes(n_clients, solver_rows, dim,
                                   data_bytes_per_client=0,
                                   dtype_bytes=dtype_bytes)
    sizes = tuple(int(s) for s in sizes)
    total_rows = sum(sizes)
    if solver_rows >= n_clients:  # dense: every CSR slice, streamed once
        solver_data = total_rows * row_bytes
    else:  # compacted: static max-length block slice per slot
        solver_data = solver_rows * max(sizes) * row_bytes
    return {
        "server_bytes": base["server_bytes"],
        "solver_state_bytes": base["solver_state_bytes"],
        "solver_data_bytes": solver_data,
        "solver_bytes": base["solver_state_bytes"] + solver_data,
        "total_bytes": base["server_bytes"] + base["solver_state_bytes"]
        + solver_data,
        "data_rows_total": total_rows,
    }


def host_stream_bytes(n_clients: int, capacity: int, dim: int, *,
                      compress: str = "none",
                      data_bytes_per_client: int = 0,
                      dtype_bytes: int = 4) -> dict[str, float]:
    """Planned host <-> device traffic of one host-backend round
    (``state_backend="host"``) and the modeled stream/solve overlap of
    the double-buffered working set over PCIe and HBM: row stream up θ,
    λ (2·C·D·b), down θ', λ⁺, z (3·C·D·b), a budget of 8·C·D·b, the
    server pass z_prev up (with the EF residual under ``compress``) and
    the residual down.  ``modeled_overlap_fraction`` = min(t_solve,
    t_stream) / t_stream."""
    row_h2d = 2 * capacity * dim * dtype_bytes
    row_d2h = 3 * capacity * dim * dtype_bytes
    full_mult = 2 if compress != "none" else 1
    server_h2d = n_clients * dim * dtype_bytes * full_mult
    server_d2h = (n_clients * dim * dtype_bytes
                  if compress != "none" else 0)
    solver = fedback_round_hbm_bytes(
        n_clients, capacity, dim,
        data_bytes_per_client=data_bytes_per_client,
        dtype_bytes=dtype_bytes)
    t_stream = (row_h2d + row_d2h) / PCIE_BW
    t_solve = solver["solver_bytes"] / HBM_BW
    return {
        "row_stream_h2d_bytes": row_h2d,
        "row_stream_d2h_bytes": row_d2h,
        "row_stream_budget_bytes": 8 * capacity * dim * dtype_bytes,
        "server_pass_h2d_bytes": server_h2d,
        "server_pass_d2h_bytes": server_d2h,
        "device_working_set_bytes": 5 * capacity * dim * dtype_bytes,
        "stream_s": t_stream,
        "solve_s": t_solve,
        "modeled_overlap_fraction": (
            min(t_solve, t_stream) / max(t_stream, 1e-30)),
    }


def consensus_collective_s(dim: int, *, mode: str = "none",
                           block: int = 256,
                           world_size: int = 1) -> dict[str, float]:
    """Modeled wire time of one consensus aggregation under
    ``consensus_compress``: ``core.compress.consensus_wire_bytes``'s
    byte breakdown and ``collective_s``, its total at ``LINK_BW``."""
    from repro_torch.core.compress import consensus_wire_bytes

    wire = consensus_wire_bytes(dim, mode=mode, block=block,
                                world_size=world_size)
    return {**wire, "collective_s": wire["total_link_bytes"] / LINK_BW}


def fedback_round_memory_s(n_clients: int, solver_rows: int, dim: int,
                           *, data_bytes_per_client: int = 0,
                           dtype_bytes: int = 4) -> float:
    """Memory roofline term (seconds) of one flat FedBack round."""
    return fedback_round_hbm_bytes(
        n_clients, solver_rows, dim,
        data_bytes_per_client=data_bytes_per_client,
        dtype_bytes=dtype_bytes)["total_bytes"] / HBM_BW


def fedback_async_overlap(n_clients: int, solver_rows: int, dim: int, *,
                          max_staleness: int, n_chips: int = 1,
                          data_bytes_per_client: int = 0,
                          dtype_bytes: int = 4,
                          compress: str = "none",
                          compress_block: int = 256) -> dict[str, float]:
    """Modeled round-time overlap of the stale-tolerant engine:

        t_sync  = t_solver + t_server (+ t_collective)
        t_async = max(t_solver, t_server + t_collective)   (S ≥ 1)

    The collective term is the consensus all-reduce over the clients'
    devices: 2·D·b / ``LINK_BW`` uncompressed (the reference's
    conservative formula), :func:`consensus_collective_s` under
    ``compress``, 0 on one device."""
    hbm = fedback_round_hbm_bytes(
        n_clients, solver_rows, dim,
        data_bytes_per_client=data_bytes_per_client,
        dtype_bytes=dtype_bytes)
    t_solver = hbm["solver_bytes"] / HBM_BW
    t_server = hbm["server_bytes"] / HBM_BW
    if n_chips <= 1:
        t_coll = 0.0
    elif compress == "none":
        t_coll = 2.0 * dim * dtype_bytes / LINK_BW
    else:
        t_coll = consensus_collective_s(
            dim, mode=compress, block=compress_block,
            world_size=n_chips)["collective_s"]
    t_sync = t_solver + t_server + t_coll
    t_async = (max(t_solver, t_server + t_coll) if max_staleness > 0
               else t_sync)
    return {
        "solver_s": t_solver,
        "server_s": t_server,
        "collective_s": t_coll,
        "modeled_sync_s": t_sync,
        "modeled_async_s": t_async,
        "modeled_overlap_speedup": t_sync / max(t_async, 1e-30),
    }


def summarize(record: dict) -> str:
    r = record
    t = r["roofline"]
    mfu = (r.get("model_flops_per_device", 0.0) /
           max(t["hlo_flops_per_device"], 1.0))
    return (f"{r['arch']:24s} {r['shape']:12s} mesh={r['mesh']:10s} "
            f"compute={t['compute_s']*1e3:9.3f}ms "
            f"memory={t['memory_s']*1e3:9.3f}ms "
            f"coll={t['collective_s']*1e3:9.3f}ms "
            f"dom={t['dominant']:10s} useful/hlo={mfu:5.2f}")

"""The port's H100 roofline model (``repro_torch.launch.roofline``)
against the reference's v5e one (``repro.launch.roofline``).

* every byte model equals the reference's exactly, on a grid of (N, C,
  D, dtype bytes, compress mode, world size);
* every time is the reference's times the ratio of the reference's
  constant to the port's (HBM, link or PCIe rate), within 1e-12 (two
  divisions against one);
* ``model_flops_per_device`` is equal for every architecture × mode,
  each package counting its own active parameters;
* the by-card tables give the H100 SXM's rates for its names, and
  ``roofline_terms`` the reference's schema.
"""
import itertools

import pytest

from repro.configs import get_config as jax_get_config
from repro.launch import roofline as jroof
from repro.models.api import active_param_count as jax_active_param_count
from repro_torch.configs import ARCHITECTURES, get_config
from repro_torch.launch import roofline as roof
from repro_torch.models import active_param_count

HBM = jroof.HBM_BW / roof.HBM_BW
LINK = jroof.LINK_BW / roof.LINK_BW
PCIE = jroof.PCIE_BW / roof.PCIE_BW
GRID = list(itertools.product(
    (16, 100), (4, 16, 100), (130, 159010), (2, 4),
    ("none", "int8", "bf16"), (1, 2, 4)))


def _close(got, want, ratio):
    assert got == pytest.approx(want * ratio, rel=1e-12, abs=0.0)


@pytest.mark.parametrize("n,c,d,b,mode,p", GRID)
def test_byte_models_equal_the_references(n, c, d, b, mode, p):
    c = min(c, n)
    for fused in (False, True):
        assert roof.fedback_round_hbm_bytes(
            n, c, d, data_bytes_per_client=3136, dtype_bytes=b,
            fused=fused) == jroof.fedback_round_hbm_bytes(
            n, c, d, data_bytes_per_client=3136, dtype_bytes=b, fused=fused)
    sizes = [30 + (7 * i) % 23 for i in range(n)]
    assert roof.fedback_ragged_round_hbm_bytes(
        n, c, d, sizes=sizes, row_bytes=3140, dtype_bytes=b) == \
        jroof.fedback_ragged_round_hbm_bytes(
            n, c, d, sizes=sizes, row_bytes=3140, dtype_bytes=b)
    got = roof.host_stream_bytes(n, c, d, compress=mode,
                                 data_bytes_per_client=3136, dtype_bytes=b)
    want = jroof.host_stream_bytes(n, c, d, compress=mode,
                                   data_bytes_per_client=3136,
                                   dtype_bytes=b)
    assert set(got) == set(want)
    for k in got:
        if k.endswith("_bytes"):
            assert got[k] == want[k], k
    got = roof.consensus_collective_s(d, mode=mode, block=256, world_size=p)
    want = jroof.consensus_collective_s(d, mode=mode, block=256,
                                        world_size=p)
    assert {k: v for k, v in got.items() if k != "collective_s"} == \
        {k: v for k, v in want.items() if k != "collective_s"}


@pytest.mark.parametrize("n,c,d,b,mode,p", GRID)
def test_times_are_the_references_at_the_h100s_rates(n, c, d, b, mode, p):
    c = min(c, n)
    got = roof.host_stream_bytes(n, c, d, compress=mode, dtype_bytes=b)
    want = jroof.host_stream_bytes(n, c, d, compress=mode, dtype_bytes=b)
    _close(got["stream_s"], want["stream_s"], PCIE)
    _close(got["solve_s"], want["solve_s"], HBM)
    _close(got["modeled_overlap_fraction"],
           min(got["solve_s"], got["stream_s"]) / got["stream_s"], 1.0)
    _close(roof.consensus_collective_s(d, mode=mode, world_size=p)
           ["collective_s"], jroof.consensus_collective_s(
               d, mode=mode, world_size=p)["collective_s"], LINK)
    _close(roof.fedback_round_memory_s(n, c, d, dtype_bytes=b),
           jroof.fedback_round_memory_s(n, c, d, dtype_bytes=b), HBM)
    for s in (0, 2):
        got = roof.fedback_async_overlap(n, c, d, max_staleness=s,
                                         n_chips=p, dtype_bytes=b,
                                         compress=mode)
        want = jroof.fedback_async_overlap(n, c, d, max_staleness=s,
                                           n_chips=p, dtype_bytes=b,
                                           compress=mode)
        assert set(got) == set(want)
        _close(got["solver_s"], want["solver_s"], HBM)
        _close(got["server_s"], want["server_s"], HBM)
        _close(got["collective_s"], want["collective_s"], LINK)
        t_sync = got["solver_s"] + got["server_s"] + got["collective_s"]
        _close(got["modeled_sync_s"], t_sync, 1.0)
        _close(got["modeled_async_s"], max(
            got["solver_s"], got["server_s"] + got["collective_s"])
            if s else t_sync, 1.0)


def test_roofline_terms_schema_and_rates():
    flops, nbytes = 3.0e11, 2.0e9
    got = roof.roofline_terms(flops, nbytes, 1.0e8)
    want = jroof.roofline_terms({"flops": flops, "bytes accessed": nbytes},
                                "", world_size=1)
    assert set(got) == set(want)
    _close(got["compute_s"], want["compute_s"],
           jroof.PEAK_FLOPS / roof.PEAK_FLOPS)
    _close(got["memory_s"], want["memory_s"], HBM)
    assert got["collective_s"] == 1.0e8 / roof.LINK_BW
    assert got["dominant"] == "memory"
    assert got["bound_time_s"] == got["memory_s"]
    assert got["collectives"] == {} == want["collectives"]
    assert roof.roofline_terms(1e15, 1.0)["dominant"] == "compute"
    line = roof.summarize({"arch": "a", "shape": "s", "mesh": "1xH100",
                           "roofline": got, "model_flops_per_device": 1e11})
    assert "dom=memory" in line and "useful/hlo= 0.33" in line


@pytest.mark.parametrize("arch", ARCHITECTURES)
def test_model_flops_equal_the_references(arch):
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    n_act, j_act = active_param_count(cfg), jax_active_param_count(jcfg)
    assert n_act == j_act
    for mode, seq, batch in (("train", 4096, 256), ("prefill", 32768, 32),
                             ("decode", 32768, 128)):
        for chips, steps in ((1, 1), (256, 2)):
            assert roof.model_flops_per_device(
                cfg, mode=mode, batch=batch, seq=seq, n_chips=chips,
                active_params=n_act, local_steps=steps) == \
                jroof.model_flops_per_device(
                    jcfg, mode=mode, batch=batch, seq=seq, n_chips=chips,
                    active_params=j_act, local_steps=steps)


@pytest.mark.parametrize("name,bw,bf16,tf32", [
    ("NVIDIA H100 80GB HBM3", 3.35e12, 989e12, 494.7e12),
    ("NVIDIA H100 NVL", 3.9e12, 835e12, 417.5e12),
    ("NVIDIA H100 PCIe", 2.0e12, 756e12, 378e12),
    ("NVIDIA H200", 4.8e12, 989e12, 494.7e12)])
def test_card_tables(name, bw, bf16, tf32):
    assert roof.card_peaks(name) == {"hbm_bytes_per_s": bw,
                                     "bf16_flops": bf16, "tf32_flops": tf32,
                                     "fp32_flops": 67e12}
    assert roof.peak_bandwidth("NVIDIA A100-SXM4-80GB") is None


def test_constants_are_the_sxm_rows():
    name = "NVIDIA H100 80GB HBM3"
    assert roof.HBM_BW == roof.peak_bandwidth(name)
    assert roof.PEAK_FLOPS == roof.peak_for(roof.PEAK_BF16_FLOPS, name)
    assert roof.PEAK_TF32_FLOPS == roof.peak_for(
        roof.PEAK_TF32_FLOPS_BY_CARD, name)


def test_time_kernels_reads_the_tables_beside_it():
    """``time_kernels.py`` loads ``roofline.py`` from its own directory
    (it may time an earlier tree, ``--src``, that has none); the kernel
    bounds of chip_smoke.py come from the same rows."""
    from repro_torch.launch import time_kernels

    for name, _ in roof.PEAK_BYTES_PER_S:
        assert time_kernels.peak_bandwidth(name) == roof.peak_bandwidth(name)
    assert time_kernels.peak_bandwidth("NVIDIA H100 80GB HBM3") == 3.35e12

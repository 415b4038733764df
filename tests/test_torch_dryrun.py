"""The one-card dry-run (``repro_torch.launch.dryrun`` with
``one_card=True``, the CLI's ``--mesh card``) against the reference's
``repro/launch/dryrun.py``.

* the reference test's three reduced-granite records (``train_4k``
  single and multi, ``decode_32k``) with its schema and its check that
  decode is not compute-bound (tests/test_dryrun.py), here for one card;
* the skip records carry the reference's ``shape_applicable`` reasons
  over every architecture × shape;
* ``analytic_hbm_bytes`` equals the reference's at one chip, over every
  architecture × shape × mesh — the reference module is imported only in
  a subprocess: it sets ``XLA_FLAGS`` to 512 host devices when imported
  (``src/repro/launch/dryrun.py:1-2``), which would hold for every later
  JAX test of the worker;
* the 1- and 2-unit extrapolation equals the full count at 4 units;
* no kernel wrapper is reached on the meta device: K4 and K5 are counted
  by their stand-ins, and a wrapper refuses a meta tensor.
"""
import json
import os
import subprocess
import sys

import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import shape_applicable as jax_shape_applicable
from repro_torch.configs import ARCHITECTURES, INPUT_SHAPES, get_config
from repro_torch.kernels import ops
from repro_torch.launch import dryrun

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CARD = "NVIDIA H100 80GB HBM3"


def _granite():
    return get_config("granite-3-2b").reduced(
        num_layers=2, d_model=512, num_heads=8, num_kv_heads=4, head_dim=64,
        d_ff=1024, vocab_size=4096, kv_block=512, remat=True,
        dtype="bfloat16")


@pytest.fixture(scope="module")
def records():
    return [dryrun.dry_run("granite-3-2b", shape, multi_pod=mp,
                           cost_correction=False, cfg=_granite(), card=CARD,
                           one_card=True)
            for shape, mp in (("train_4k", False), ("train_4k", True),
                              ("decode_32k", False))]


class TestReducedGraniteRecords:
    def test_single_pod_train(self, records):
        r = records[0]
        assert r["status"] == "ok" and r["step"] == "train"
        assert r["n_chips"] == 1 and r["mesh"] == "1xH100"
        assert r["pods"] == 1 and "assumed" not in r
        assert r["roofline"]["hlo_flops_per_device"] > 0

    def test_multi_pod_train_is_the_cross_pod_round(self, records):
        single, r = records[0], records[1]
        assert r["status"] == "ok"
        assert r["n_chips"] == 1 and r["mesh"] == "1xH100"
        assert r["pods"] == 2 and r["assumed"] == "every pod fires"
        # every pod fires: the same tokens' products as one train step,
        # plus the round's ADMM algebra and two more optimizer passes
        assert r["roofline"]["hlo_flops_per_device"] >= \
            single["roofline"]["hlo_flops_per_device"]
        assert r["analytic_hbm_bytes"] > single["analytic_hbm_bytes"]

    def test_decode_is_not_compute_bound(self, records):
        r = records[2]
        assert r["status"] == "ok"
        assert r["roofline"]["dominant"] in ("memory", "collective")

    def test_roofline_terms_positive_and_schema(self, records):
        for r in records:
            t = r["roofline"]
            for k in ("compute_s", "memory_s", "collective_s"):
                assert t[k] >= 0
            assert t["collective_s"] == 0.0 and t["collectives"] == {}
            assert "memory_analysis" in r
            assert "analytic_hbm_bytes" in r
            assert r["card"] == CARD
            assert r["fits_hbm_80GB"] == (r["analytic_hbm_bytes"] < 80e9)
            assert r["useful_flops_ratio"] == pytest.approx(
                r["model_flops_per_device"] / t["hlo_flops_per_device"])
            assert t["bound_time_s"] == max(t["compute_s"], t["memory_s"])


@pytest.mark.parametrize("arch", ARCHITECTURES)
def test_skip_reasons_are_the_references(arch):
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    for shape in INPUT_SHAPES:
        ok, reason = jax_shape_applicable(jcfg, shape)
        rec = (dryrun.dry_run(arch, shape, cfg=cfg, card=CARD,
                              one_card=True) if not ok else None)
        if ok:
            assert dryrun.build_step(cfg, shape, multi_pod=False,
                                     one_card=True)[1] == ""
        else:
            assert rec["status"] == "skipped" and rec["reason"] == reason


_JAX_SCRIPT = r"""
import functools, json
from repro.configs import ARCHITECTURES, INPUT_SHAPES, get_config
from repro.launch import dryrun
dryrun.param_count = functools.cache(dryrun.param_count)  # once an arch
out = {}
for arch in ARCHITECTURES:
    cfg = get_config(arch)
    for shape, (mode, seq, batch) in INPUT_SHAPES.items():
        for mp in (False, True):
            out[f"{arch}|{shape}|{mp}"] = dryrun.analytic_hbm_bytes(
                cfg, step_mode=mode, batch=batch, seq=seq, n_chips=1,
                multi_pod=mp, local_steps=2)
print("RESULT:" + json.dumps(out))
"""


def test_analytic_hbm_bytes_are_the_references():
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", _JAX_SCRIPT], env=env,
                         capture_output=True, text=True, timeout=300,
                         cwd=REPO)
    assert out.returncode == 0, out.stderr[-3000:]
    line = [x for x in out.stdout.splitlines() if x.startswith("RESULT:")]
    want = json.loads(line[-1][len("RESULT:"):])
    assert len(want) == len(ARCHITECTURES) * len(INPUT_SHAPES) * 2
    for key, value in want.items():
        arch, shape, mp = key.split("|")
        mode, seq, batch = INPUT_SHAPES[shape]
        got = dryrun.analytic_hbm_bytes(
            get_config(arch), step_mode=mode, batch=batch, seq=seq,
            n_chips=1, multi_pod=mp == "True", local_steps=2)
        assert got == value, key


@pytest.mark.parametrize("arch,shape,mp,overrides", [
    ("granite-3-2b", "train_4k", False, dict(num_layers=4)),
    ("granite-3-2b", "train_4k", True, dict(num_layers=4)),
    ("granite-3-2b", "prefill_32k", False, dict(num_layers=4)),
    ("mixtral-8x7b", "decode_32k", False, dict(num_layers=4)),
    ("zamba2-2.7b", "prefill_32k", False, dict(num_layers=8,
                                               attn_every=2)),
    ("granite-3-2b", "train_4k", False, dict(num_layers=8,
                                             remat_group=2))])
def test_extrapolation_equals_the_full_count(arch, shape, mp, overrides):
    # KV blocks of 2048 and SSD chunks of 64 (the reduced configs' 8
    # would make thousands of blocks at these lengths).
    cfg = get_config(arch).reduced(kv_block=2048, chunk=64, **overrides)
    assert dryrun._scan_units(cfg) == 4
    full = dryrun.count_cost(cfg, shape, multi_pod=mp, one_card=True)
    got = dryrun.corrected_cost(cfg, shape, multi_pod=mp, one_card=True)
    for k in ("flops", "bytes", "args_bytes", "flash_attention",
              "ssd_scan"):
        assert got[k] == full[k], k
    assert full["flops"] > 0 and full["bytes"] > 0


def test_kernels_are_counted_by_their_stand_ins():
    """Prefill reaches K4 (and, in the hybrid, K5) once a layer through
    the stand-ins, never the wrappers; K4's FLOPs are the causal count,
    about half its plain version's S²."""
    cfg = get_config("zamba2-2.7b").reduced(chunk=64)
    ops.reset_launch_counts()
    c = dryrun.count_cost(cfg, "prefill_32k", multi_pod=False,
                          one_card=True)
    assert ops.call_counts() == {k: 0 for k in ops.KERNELS}
    assert c["flash_attention"] == cfg.num_layers // cfg.attn_every
    assert c["ssd_scan"] == cfg.num_layers
    assert ops.flash_attention is ops.KERNELS["flash_attention"]
    assert ops.ssd_scan is ops.KERNELS["ssd_scan"]
    b, h, hd = 32, cfg.num_heads, cfg.head_dim
    assert ops.flash_attention_flops(b, h, 2048, hd) == \
        4 * b * h * hd * 2048 * 2049 // 2
    q = torch.empty(1, 4, 2, 8, device="meta")
    with pytest.raises(ValueError, match="CPU or all on one CUDA"):
        ops.flash_attention(q, q, q, layout="bshd")


def test_encoder_prefill_is_its_encode_pass():
    rec = dryrun.dry_run("hubert-xlarge", "prefill_32k",
                         cfg=get_config("hubert-xlarge").reduced(
                             kv_block=8192), card=CARD, one_card=True)
    assert rec["status"] == "ok" and rec["step"] == "encode"
    assert rec["roofline"]["hlo_flops_per_device"] > 0


def test_cli_writes_records_and_refuses_an_unknown_card(tmp_path, capsys):
    argv = ["--arch", "granite-3-2b", "--shape", "all", "--mesh", "card",
            "--card", CARD, "--jobs", "1", "--out", str(tmp_path),
            "--set", "num_layers=2", "--set", "d_model=256",
            "--set", "vocab_size=1024", "--set", "kv_block=4096"]
    with pytest.raises(SystemExit) as e:
        dryrun.main(argv)
    assert e.value.code == 0
    files = sorted(p.name for p in tmp_path.iterdir())
    assert len(files) == 8 and "granite-3-2b__train_4k__multi.json" in files
    rec = json.loads((tmp_path / "granite-3-2b__long_500k__single.json")
                     .read_text())
    assert rec["status"] == "skipped"
    out = capsys.readouterr().out
    assert "dom=" in out and "every pod fires" in out
    with pytest.raises(ValueError, match="do not name the card"):
        dryrun.dry_run("granite-3-2b", "train_4k", card="Some Other GPU",
                       one_card=True)


def test_sweep_in_worker_processes_gives_the_same_records():
    cfg = dict(num_layers=2, d_model=128, vocab_size=512, chunk=64,
               kv_block=4096)

    def small(c):
        return c.reduced(**cfg)

    combos = [("granite-3-2b", "decode_32k", False),
              ("mamba2-2.7b", "prefill_32k", True),
              ("granite-3-2b", "long_500k", False)]
    one = list(dryrun.sweep(combos, card=CARD, jobs=1, overrides=small,
                            one_card=True))
    two = list(dryrun.sweep(combos, card=CARD, jobs=2, overrides=small,
                            one_card=True))
    for a, b in zip(one, two, strict=True):
        a.pop("count_s", None)
        b.pop("count_s", None)
        assert a == b
    assert [r["status"] for r in one] == ["ok", "ok", "skipped"]

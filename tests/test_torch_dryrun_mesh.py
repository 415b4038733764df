"""The dry-run over the reference's meshes (``repro_torch.launch.dryrun``
with ``--mesh single|multi|both``) against the reference's
``repro/launch/dryrun.py``.

* Each argument leaf's bytes a device equal those of the reference's
  ``build_step`` shardings (``in_shardings[i].shard_shape``, no compile)
  on the 16 × 16 and 2 × 16 × 16 meshes, for reduced configurations of
  every family whose heads split over 16, and of phi3 with its 40 heads
  (which straddle 16 model shards), in modes fsdp, tp and fsdp_tp,
  every shape that applies — but the ROADMAP D17 leaves: the token and
  label ids and the cross-pod key at twice the reference's bytes (int64
  against int32 and uint32), and a cache's ``pos`` absent (a host int).
  The reference runs in a subprocess that forces 512 host devices before
  it imports ``jax`` (``src/repro/launch/dryrun.py:1-2`` sets the flag
  when imported).
* A training step's collective bytes by kind equal
  ``sharding.train.step_bytes`` (its record's, a device, over the
  coordinates); the counted FLOPs equal ``FlopCounterMode`` of the same
  step run on CPU tensors on (2, 2) and (2, 2, 2) meshes; the figures
  per coordinate add up to the whole count; and the count that runs two
  data shards of each loop (the sample) equals the count that runs them
  all, for every family and mode, on (4, 2) and (2, 2, 2).
* Records and CLI: the reference's mesh names, ``n_chips``,
  ``sharding_mode`` and file names, the two skip records, and
  ``--sharding ep`` refused as the reference's CLI refuses it.
"""
import contextlib
import json
import os
import subprocess
import sys

import pytest
import torch
from torch.utils._python_dispatch import _disable_current_modes
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import INPUT_SHAPES, get_config
from repro_torch.kernels import ops
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.launch.steps import make_cross_pod_step, \
    make_prefill_step, make_train_step
from repro_torch.models import build_model
from repro_torch.optim.adam import adam_init
from repro_torch.sharding.params import ShardedTree, per_device_bytes, \
    shard_tree
from repro_torch.sharding.train import init_cross_pod_state_on_mesh, \
    step_bytes
from repro_torch.utils.pytree import tree_leaves
from torch_threads import _one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CARD = "NVIDIA H100 80GB HBM3"
MODES = ("fsdp", "tp", "fsdp_tp")
# Reduced configurations whose heads (and mamba heads) split over a
# model axis of 16, one a family, and phi3 with its own 40 query and 10
# kv heads, whose query heads straddle the 16 model shards (H·hd splits:
# 2.5 heads a shard).
WIDE = dict(num_layers=2, d_model=512, num_heads=16, num_kv_heads=16,
            head_dim=32, d_ff=1024, vocab_size=4096)
FAMILIES = {
    "granite-3-2b": dict(WIDE, num_kv_heads=4),
    "moonshot-v1-16b-a3b": WIDE,
    "mamba2-2.7b": WIDE,
    "zamba2-2.7b": dict(WIDE, num_layers=4),
    "paligemma-3b": dict(WIDE, num_kv_heads=1),
    "hubert-xlarge": WIDE,
    "phi3-medium-14b": dict(WIDE, d_model=640, num_heads=40,
                            num_kv_heads=10, head_dim=16),
}
# the port's ids and the cross-pod key are twice the reference's bytes
DOUBLED = ("['tokens']", "['labels']", ".rng")

_SCRIPT = r"""
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=512"
import json
import jax, numpy as np
from repro.configs import INPUT_SHAPES, get_config
from repro.launch import dryrun

out = {}
for arch, kw in %r.items():
    cfg = get_config(arch).reduced(**kw)
    for shape, (step, _, batch) in INPUT_SHAPES.items():
        if not dryrun.shape_applicable(cfg, shape)[0] or batch == 1 or (
                step == "prefill" and cfg.family == "audio"):
            continue
        for mode in %r:
            for mp in (False, True):
                built, _ = dryrun.build_step(cfg, shape, multi_pod=mp,
                                             mode=mode)
                _, _, _, (_, in_sh, _, args), *_ = built
                leaves = jax.tree_util.tree_flatten_with_path(args)[0]
                shardings = jax.tree.leaves(in_sh)
                assert len(leaves) == len(shardings)
                out[f"{arch}|{shape}|{mode}|{mp}"] = [
                    [jax.tree_util.keystr(p), int(np.prod(
                        s.shard_shape(x.shape))) * x.dtype.itemsize]
                    for (p, x), s in zip(leaves, shardings)]
print("RESULT:" + json.dumps(out))
""" % (FAMILIES, MODES)


@pytest.fixture(scope="module", autouse=True)
def _abstract_params_once():
    """Each configuration's meta-device parameters made once (their init
    runs the PRNG over every leaf); the steps only read their shapes."""
    from repro_torch.launch import steps
    from repro_torch.sharding import train

    made, build = {}, steps.abstract_params

    def once(model):
        if model.config not in made:
            made[model.config] = build(model)
        return made[model.config]

    patch = pytest.MonkeyPatch()
    patch.setattr(steps, "abstract_params", once)
    patch.setattr(train, "abstract_params", once)
    yield
    patch.undo()


@pytest.fixture(scope="module")
def reference():
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", _SCRIPT], env=env,
                         capture_output=True, text=True, timeout=300,
                         cwd=REPO)
    assert out.returncode == 0, out.stderr[-3000:]
    line = [x for x in out.stdout.splitlines() if x.startswith("RESULT:")]
    return json.loads(line[-1][len("RESULT:"):])


def _port_leaf_bytes(arch, shape, mode, mp):
    """Each argument leaf's bytes a device of the port's step (None for
    a leaf that is no tensor: a cache's ``pos``)."""
    built, reason = dryrun.build_step(get_config(arch).reduced(
        **FAMILIES[arch]), shape, multi_pod=mp, mode=mode)
    assert reason == ""
    mesh, (_, args) = built[2], built[3]
    out = []
    for arg, spec in zip(args, args.in_specs, strict=True):
        for x, s in zip(tree_leaves(arg), tree_leaves(spec), strict=True):
            out.append(per_device_bytes(x, s, mesh)
                       if isinstance(x, torch.Tensor) else None)
    return out


@pytest.mark.parametrize("mp", [False, True], ids=["16x16", "2x16x16"])
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("arch", FAMILIES)
def test_argument_bytes_a_device_are_the_references(reference, arch, mode,
                                                    mp):
    keys = [k for k in reference if k.startswith(f"{arch}|")
            and k.endswith(f"|{mode}|{mp}")]
    assert keys
    for key in keys:
        shape = key.split("|")[1]
        want = []
        for path, n in reference[key]:
            if path.endswith("['pos']"):
                continue  # a host int in the port (D17)
            doubled = path.endswith(DOUBLED) or (
                INPUT_SHAPES[shape][0] == "decode" and path == "[1]")
            want.append(2 * n if doubled else n)
        got = [n for n in _port_leaf_bytes(arch, shape, mode, mp)
               if n is not None]
        assert got == want, key


def _small(arch):
    """The reduced configuration cut to one layer unit (a layer; the
    hybrid's group of two)."""
    cfg = get_config(arch)
    return cfg.reduced(num_layers=2 if cfg.family == "hybrid" else 1)


SMALL = {"granite-3-2b": {}, "moonshot-v1-16b-a3b": {},
         "mamba2-2.7b": {}, "zamba2-2.7b": {}, "paligemma-3b": {},
         "hubert-xlarge": {}}
TRAIN_MODES = [(a, m) for a in SMALL for m in MODES] + [
    ("moonshot-v1-16b-a3b", "ep")]


def _meta_mesh(shape):
    axes = ("pod", "data", "model") if len(shape) == 3 else ("data",
                                                              "model")
    return make_test_mesh(shape, axes, devices=("meta",))


@pytest.mark.parametrize("arch,mode", TRAIN_MODES)
def test_training_collectives_are_step_bytes(arch, mode):
    cfg = _small(arch)
    mesh = _meta_mesh((4, 2))
    cost = dryrun.count_cost(cfg, "train_4k", multi_pod=False, mode=mode,
                             mesh=mesh, batch=8, seq=16)
    model = build_model(cfg)
    _, args = make_train_step(model, mesh, batch=8, seq=16, mode=mode)
    want = {k: v for k, v in step_bytes(cfg, args[0], args.in_specs[0],
                                        mesh, mode, batch=8,
                                        seq=16).items() if v}
    assert cost["collectives"] == want
    rec = dryrun.make_record(arch, "train_4k", cfg, cost, multi_pod=False,
                             card=CARD, mode=mode)
    assert rec["n_chips"] == 8
    assert {k: v["bytes"] for k, v in
            rec["roofline"]["collectives"].items()} == {
        k: v / 8 for k, v in want.items()}
    assert rec["roofline"]["collective_bytes_per_device"] == \
        sum(want.values()) / 8


@contextlib.contextmanager
def plain_kernels(work):
    """On the CPU: each kernel's plain version gives the values, its work
    counted into ``work`` as the dry-run's stand-ins count it (the
    counters do not see the plain version's own products)."""
    saved = ops.flash_attention, ops.ssd_scan

    def attention(q, k, v, **kw):
        dryrun._flash_attention_stand_in(work, q, k, v, **kw)
        with _disable_current_modes():
            return saved[0](q, k, v, **kw)

    def scan(states, decays):
        dryrun._ssd_scan_stand_in(work, states, decays)
        with _disable_current_modes():
            return saved[1](states, decays)

    ops.flash_attention, ops.ssd_scan = attention, scan
    try:
        yield
    finally:
        ops.flash_attention, ops.ssd_scan = saved


def _batch(abstract, vocab, gen):
    return {k: torch.randint(0, vocab, tuple(v.shape), generator=gen)
            if v.dtype == torch.int64 else
            torch.randn(tuple(v.shape), generator=gen).to(v.dtype)
            for k, v in abstract.items()}


def _cpu_flops(arch, shape, mode, mesh_shape, batch, seq):
    """FlopCounterMode's count of the step run on CPU tensors (the
    kernels' plain versions, counted as the stand-ins count them)."""
    cfg = _small(arch)
    model = build_model(cfg)
    params = model.init(0, device="cpu")
    gen = torch.Generator().manual_seed(0)
    axes = ("pod", "data", "model") if len(mesh_shape) == 3 else (
        "data", "model")
    mesh = make_test_mesh(mesh_shape, axes)
    work = dryrun._Kernels()
    if shape == "train_4k" and len(mesh_shape) == 3:
        fn, args = make_cross_pod_step(model, mesh, batch=batch, seq=seq,
                                       mode=mode, every_pod_fires=True)
        from repro_torch.core.controller import ControllerConfig
        from repro_torch.core.crosspod import CrossPodConfig
        cp = CrossPodConfig(n_pods=2, local_steps=2, controller=(
            ControllerConfig(K=0.5, alpha=0.9, target_rate=0.5)))
        state = init_cross_pod_state_on_mesh(cp, params, mesh, mode)
        b = _batch(args[1], cfg.vocab_size, gen)
        call = (state, shard_tree(b, args.in_specs[1], mesh))
    elif shape == "train_4k":
        fn, args = make_train_step(model, mesh, batch=batch, seq=seq,
                                   mode=mode)
        sp = shard_tree(params, args.in_specs[0], mesh)
        so = ShardedTree(tuple(adam_init(b) for b in sp.blocks),
                         args.in_specs[1], mesh)
        call = (sp, so, sp, shard_tree(_batch(args[3], cfg.vocab_size, gen),
                                       args.in_specs[3], mesh))
    else:
        fn, args = make_prefill_step(model, mesh, batch=batch, seq=seq,
                                     mode=mode)
        call = (shard_tree(params, args.in_specs[0], mesh),
                shard_tree(_batch(args[1], cfg.vocab_size, gen),
                           args.in_specs[1], mesh))
    with plain_kernels(work), FlopCounterMode(display=False) as fc:
        fn(*call)
    return fc.get_total_flops() + work.flops, work.calls


@pytest.mark.parametrize("arch,shape,mode,mesh_shape", [
    *[(a, "train_4k", m, (2, 2)) for a in SMALL for m in ("fsdp", "tp")],
    ("granite-3-2b", "train_4k", "fsdp", (2, 2, 2)),
    ("granite-3-2b", "train_4k", "tp", (2, 2, 2)),
    ("moonshot-v1-16b-a3b", "train_4k", "fsdp_tp", (2, 2, 2)),
    ("granite-3-2b", "prefill_32k", "tp", (2, 2)),
    ("zamba2-2.7b", "prefill_32k", "fsdp", (2, 2)),
    ("zamba2-2.7b", "prefill_32k", "fsdp_tp", (2, 2))])
def test_counted_flops_equal_a_cpu_run(arch, shape, mode, mesh_shape):
    batch = 8 if len(mesh_shape) == 3 else 4
    want, calls = _cpu_flops(arch, shape, mode, mesh_shape, batch, 16)
    got = dryrun.count_cost(_small(arch), shape,
                            multi_pod=len(mesh_shape) == 3, mode=mode,
                            mesh=_meta_mesh(mesh_shape), batch=batch,
                            seq=16)
    assert sum(got["flops"]) == want
    for k, n in calls.items():
        assert sum(got[k]) == n


@pytest.mark.parametrize("arch,shape,mode", [
    ("granite-3-2b", "train_4k", "fsdp"),
    ("moonshot-v1-16b-a3b", "train_4k", "tp"),
    ("zamba2-2.7b", "prefill_32k", "tp"),
    ("mamba2-2.7b", "decode_32k", "fsdp_tp")])
def test_per_coordinate_figures_add_up_to_the_whole(arch, shape, mode):
    """The counter's figures per coordinate against the one-card
    counters run over the same ops: every FLOP, byte and kernel call
    counts to exactly one coordinate."""
    built, _ = dryrun.build_step(_small(arch), shape, multi_pod=False,
                                 mode=mode, mesh=_meta_mesh((4, 2)),
                                 batch=8, seq=16)
    mesh, (fn, _) = built[2], built[3]
    sharded = dryrun.mesh_arguments(built, mesh, mode)
    for x in sharded:
        dryrun.tag_tree(x)
    counter = dryrun.MeshCounter(mesh.size)
    kernels = dryrun._Kernels()

    class Both:
        def add(self, *a):
            counter.add(*a)
            kernels.add(*a)

    flops, moved = FlopCounterMode(display=False), dryrun.ByteCounter()
    # the counters above the mesh counter see each op it sees (the FLOP
    # counter, on top, splits an op with a decomposition for all three)
    with dryrun.kernel_stand_ins(Both()), dryrun._Placement(counter), \
            counter, moved, flops:
        fn(*sharded)
    assert sum(counter.flops) == flops.get_total_flops() + kernels.flops
    assert sum(counter.bytes) == moved.bytes + kernels.bytes
    for k, n in kernels.calls.items():
        assert sum(counter.calls[k]) == n
    assert all(b > 0 for b in counter.bytes)
    if mode != "fsdp":  # the work is spread over the model shards
        assert min(counter.flops) > 0


def _sample_cases():
    shapes = [("train_4k", (4, 2)), ("prefill_32k", (4, 2)),
              ("decode_32k", (2, 2, 2))]
    out = []
    for arch in SMALL:
        for mode in MODES:
            for shape, mesh_shape in shapes:
                if dryrun._skip_reason(_small(arch), shape, False, True):
                    continue
                if get_config(arch).family == "audio" and shape != \
                        "train_4k":
                    continue
                out.append((arch, mode, shape, mesh_shape))
    # the cross-pod round: its pods sampled (each fires)
    return out + [("granite-3-2b", "fsdp", "train_4k", (2, 2, 2)),
                  ("granite-3-2b", "tp", "train_4k", (2, 2, 2)),
                  ("zamba2-2.7b", "tp", "train_4k", (2, 2, 2)),
                  ("moonshot-v1-16b-a3b", "fsdp_tp", "train_4k", (2, 2, 2))]


@pytest.mark.parametrize("arch,mode,shape,mesh_shape", _sample_cases())
def test_the_sample_equals_the_full_count(arch, mode, shape, mesh_shape):
    """Two data shards of each loop run (one pod of the cross-pod round)
    and the others stand in: the count equals the one that runs them
    all, coordinate by coordinate, and so does the record; the memory's
    peak on every coordinate but those stood in for."""
    mesh = _meta_mesh(mesh_shape)
    kw = dict(multi_pod=len(mesh_shape) == 3, mode=mode, mesh=mesh,
              batch=8, seq=16)
    cfg = _small(arch)
    full = dryrun.count_cost(cfg, shape, sample=False, **kw)
    sampled = dryrun.count_cost(cfg, shape, **kw)
    peaks = full.pop("temp_bytes"), sampled.pop("temp_bytes")
    assert sampled == full
    # the batch position of each coordinate: those from the first that
    # is not run (the second pod's, a third data shard's) stood in for
    cross_pod = shape == "train_4k" and len(mesh_shape) == 3
    runs = 1 if cross_pod else 2
    for coord, a, b in zip(mesh.coords(), *peaks, strict=True):
        batch_pos = coord[0] if cross_pod else (
            coord[0] * mesh_shape[1] + coord[1] if len(coord) == 3
            else coord[0])
        if batch_pos < runs:
            assert a == b, coord
    records = [dryrun.make_record(arch, shape, cfg, dict(c, temp_bytes=t),
                                  multi_pod=kw["multi_pod"], card=CARD,
                                  mode=mode, mesh=mesh)
               for c, t in zip((full, sampled), peaks, strict=True)]
    assert records[0] == records[1]


TINY = dict(num_layers=1, d_model=256, num_heads=16, num_kv_heads=16,
            head_dim=16, d_ff=512, vocab_size=1024)


@pytest.mark.parametrize("mode,mp", [("fsdp", False), ("tp", True),
                                     ("fsdp_tp", False)])
def test_a_mesh_record_is_one_cards_on_the_references_mesh(mode, mp):
    cfg = get_config("granite-3-2b").reduced(**TINY, dtype="bfloat16")
    rec = dryrun.dry_run("granite-3-2b", "decode_32k", multi_pod=mp,
                         mode=mode, cost_correction=False, cfg=cfg,
                         card=CARD)
    n = 512 if mp else 256
    assert rec["status"] == "ok" and rec["step"] == "decode"
    assert rec["mesh"] == ("2x16x16" if mp else "16x16")
    assert rec["n_chips"] == n and rec["sharding_mode"] == mode
    assert len(rec["busiest_coordinate"]) == (3 if mp else 2)
    t = rec["roofline"]
    assert t["collective_bytes_per_device"] == sum(
        v["bytes"] for v in t["collectives"].values()) > 0
    assert t["collective_s"] == pytest.approx(
        t["collective_bytes_per_device"] / 450e9)
    assert rec["model_flops_per_device"] == pytest.approx(
        2 * dryrun.active_param_count(cfg) * 128 / n)
    mem = rec["memory_analysis"]
    model = build_model(cfg)
    _, args = dryrun.build_step(cfg, "decode_32k", multi_pod=mp,
                                mode=mode)[0][3]
    mesh = dryrun.make_production_mesh(multi_pod=mp, devices=["meta"])
    assert mem["argument_size_in_bytes"] == sum(
        per_device_bytes(a, s, mesh)
        for a, s in zip(args, args.in_specs, strict=True))
    assert rec["bytes_per_device"] == sum(mem.values())
    assert rec["fits_hbm_80GB"] == (rec["analytic_hbm_bytes"] < 80e9)
    assert rec["meta_measured_fits"] == (rec["bytes_per_device"] < 80e9)
    assert rec["analytic_hbm_bytes"] == int(dryrun.analytic_hbm_bytes(
        cfg, step_mode="decode", batch=128, seq=32768, n_chips=n,
        multi_pod=mp, local_steps=2))
    assert "pods" not in rec and rec["card"] == CARD
    assert model.config is cfg


def test_the_two_mesh_skip_records():
    tiny = dict(num_layers=2, d_model=256, vocab_size=1024)
    for mp in (False, True):
        rec = dryrun.dry_run("mamba2-2.7b", "long_500k", multi_pod=mp,
                             cfg=get_config("mamba2-2.7b").reduced(**tiny),
                             card=CARD)
        assert rec["status"] == "skipped"
        assert "batch 1 does not split" in rec["reason"]
        assert f"{32 if mp else 16} data shards" in rec["reason"]
        rec = dryrun.dry_run("hubert-xlarge", "prefill_32k", multi_pod=mp,
                             cfg=get_config("hubert-xlarge").reduced(
                                 **tiny), card=CARD)
        assert rec["status"] == "skipped" and "D13" in rec["reason"]
    # on one card the encoder's prefill is counted (its encode pass)
    assert dryrun._skip_reason(get_config("hubert-xlarge"), "prefill_32k",
                               False, True) == ""


def test_cli_writes_the_references_file_names(tmp_path, capsys):
    argv = ["--arch", "granite-3-2b", "--shape", "decode_32k", "--mesh",
            "multi", "--sharding", "tp", "--card", CARD, "--jobs", "1",
            "--out", str(tmp_path)]
    argv += [a for k, v in TINY.items() for a in ("--set", f"{k}={v}")]
    with pytest.raises(SystemExit) as e:
        dryrun.main(argv)
    assert e.value.code == 0
    name = "granite-3-2b__decode_32k__multi__tp.json"
    assert [p.name for p in tmp_path.iterdir()] == [name]
    assert dryrun.record_name("granite-3-2b", "decode_32k", False,
                              sharding="fsdp", tag="x") == \
        "granite-3-2b__decode_32k__single__fsdp__x.json"
    rec = json.loads((tmp_path / name).read_text())
    assert rec["mesh"] == "2x16x16" and rec["n_chips"] == 512
    assert rec["sharding_mode"] == "tp"
    assert rec["overrides"] and "dom=" in capsys.readouterr().out
    with pytest.raises(SystemExit) as e:
        dryrun.main(argv[:5] + ["--sharding", "ep"])
    assert e.value.code == 2


@pytest.mark.parametrize("arch", ["moonshot-v1-16b-a3b", "zamba2-2.7b",
                                  "paligemma-3b"])
def test_the_counters_shortcuts_give_each_ops_output(arch):
    """The ops whose meta kernels the count skips (elementwise, shape
    only) give each op's own output shape and dtype: ``check`` runs the
    op too and holds them equal, over a training step and a prefill."""
    for shape in ("train_4k", "prefill_32k"):
        dryrun.count_cost(_small(arch), shape, multi_pod=False, mode="tp",
                          mesh=_meta_mesh((2, 2)), batch=4, seq=16,
                          check=True)

"""The port stands alone: no JAX, no ``repro`` imports, CUDA by default."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"
MODULES = sorted(PKG.rglob("*.py"))


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_package_has_the_slice_modules():
    names = {p.relative_to(PKG).as_posix() for p in MODULES}
    for m in ("prng.py", "convert.py", "device.py", "utils/flatstate.py",
              "kernels/ref.py", "kernels/_build.py",
              "kernels/trigger_norms.py", "kernels/admm_update.py",
              "kernels/fused_gss.py", "kernels/ops.py", "core/controller.py",
              "core/trigger.py", "core/state.py", "core/selection.py",
              "core/engine.py", "core/compact.py", "core/fedback.py",
              "core/baselines.py",
              "optim/sgd.py", "models/mlp.py", "data/synthetic.py",
              "data/partition.py", "data/pipeline.py",
              "configs/paper_mnist.py", "configs/model_config.py",
              "configs/zamba2_2_7b.py", "kernels/flash_attention.py",
              "kernels/ssd_scan.py", "models/layers.py", "models/ssm.py",
              "models/attention.py", "models/transformer.py",
              "models/api.py", "launch/serve_lm.py",
              "sharding/clients.py", "core/compress.py",
              "checkpoint/store.py", "optim/prox.py", "launch/serve.py",
              "utils/ragged.py", "core/hoststate.py", "launch/sweep.py",
              "utils/spans.py", "analysis/__init__.py",
              "analysis/__main__.py", "analysis/oplog.py",
              "analysis/artifacts.py", "analysis/rules.py",
              "analysis/retrace.py", "analysis/astlint.py",
              "analysis/cli.py"):
        assert m in names, m
    for src in ("fedback_kernels.cu", "model_kernels.cu"):
        assert (PKG / "csrc" / src).is_file(), src


@pytest.mark.parametrize("path", MODULES,
                         ids=[p.relative_to(PKG).as_posix() for p in MODULES])
def test_module_imports_no_jax_and_no_repro(path):
    for name in _imports(path):
        top = name.split(".")[0]
        assert top not in ("jax", "jaxlib", "repro", "flax", "optax",
                           "ml_dtypes"), \
            f"{path.name} imports {name}"


def test_importing_the_port_leaves_jax_out():
    code = ("import sys, repro_torch, repro_torch.core, repro_torch.kernels."
            "ops, repro_torch.convert, repro_torch.configs.paper_mnist, "
            "repro_torch.configs.zamba2_2_7b, repro_torch.data, "
            "repro_torch.models, repro_torch.models.transformer, "
            "repro_torch.launch.serve_lm, repro_torch.sharding, "
            "repro_torch.checkpoint, repro_torch.core.compress, "
            "repro_torch.optim.prox, repro_torch.launch.serve, "
            "repro_torch.core.hoststate, repro_torch.launch.sweep; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro', 'ml_dtypes')]; print(bad); "
            "sys.exit(bool(bad))")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_default_device_raises_without_cuda(monkeypatch):
    from repro_torch.core import FLConfig, init_scaffold, init_state, \
        make_eval_fn, make_round_fn, make_scaffold_round
    from repro_torch.data import make_least_squares
    from repro_torch.utils import make_flat_spec

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    params0 = {"theta": torch.zeros(3)}
    spec = make_flat_spec(params0)
    cfg = FLConfig(n_clients=4)
    with pytest.raises(RuntimeError, match="CUDA"):
        init_state(cfg, params0, spec=spec)
    with pytest.raises(RuntimeError, match="CUDA"):
        make_round_fn(cfg, lambda p, x, y: x.sum(), {"x": torch.zeros(4, 2, 3),
                      "y": torch.zeros(4, 2)}, spec=spec)
    with pytest.raises(RuntimeError, match="CUDA"):
        make_eval_fn(lambda p, x, y: (x, y), spec=spec)
    with pytest.raises(RuntimeError, match="CUDA"):
        make_least_squares(4, 2, 3)
    with pytest.raises(RuntimeError, match="CUDA"):
        init_scaffold(cfg, params0, spec=spec)
    with pytest.raises(RuntimeError, match="CUDA"):
        make_scaffold_round(cfg, lambda p, x, y: x.sum(),
                            {"x": torch.zeros(4, 2, 3),
                             "y": torch.zeros(4, 2)}, spec=spec)
    state = init_state(cfg, params0, spec=spec, device="cpu")
    assert state.theta.device.type == "cpu" and state.theta.shape == (4, 3)


BUILDERS = ("params_from_numpy", "state_from_numpy", "init_mlp", "MLP",
            "PRNGKey", "init_controller", "init_queue",
            "lm_params_from_numpy", "lm_cache_from_numpy", "lm_init",
            "lm_init_cache", "serve")


@pytest.fixture(scope="module")
def builder_inputs():
    """What the builders take, made once on the CPU: a fetched FL state,
    reduced zamba2's config, model and seed-0 tree, a hybrid cache."""
    import numpy as np

    from repro_torch import convert
    from repro_torch.configs import get_config
    from repro_torch.core import FLConfig, init_state
    from repro_torch.models import build_model
    from repro_torch.utils import make_flat_spec
    from repro_torch.utils.pytree import tree_map

    params0 = {"theta": torch.zeros(3)}
    state_np = convert.state_to_numpy(init_state(
        FLConfig(n_clients=4), params0, spec=make_flat_spec(params0),
        device="cpu"))
    lm_cfg = get_config("zamba2-2.7b").reduced()
    lm = build_model(lm_cfg)
    lm_tree = tree_map(lambda t: t.numpy(), lm.init(0, device="cpu"))
    cache_np = {"layers": {"ssm": np.zeros((4, 1, 2, 2, 2), np.float32),
                           "conv": np.zeros((4, 1, 3, 8), np.float32)},
                "k": np.zeros((2, 1, 4, 2, 8), np.float32),
                "v": np.zeros((2, 1, 4, 2, 8), np.float32), "pos": 4}
    assert convert.lm_params_from_numpy(lm_tree, lm_cfg, device="cpu")
    return state_np, lm_cfg, lm, lm_tree, cache_np


@pytest.mark.parametrize("entry", BUILDERS)
def test_default_device_of_builders_raises_without_cuda(entry, monkeypatch,
                                                        builder_inputs):
    """Weights, converted state and the state's parts are made on CUDA
    unless the caller asks for another device; without CUDA they raise
    rather than land on the CPU."""
    import numpy as np

    from repro_torch import convert, prng
    from repro_torch.core import compact, controller
    from repro_torch.launch.serve_lm import serve
    from repro_torch.models import MLP, init_mlp

    state_np, lm_cfg, lm, lm_tree, cache_np = builder_inputs
    calls = {
        "params_from_numpy": lambda: convert.params_from_numpy(
            {"fc1": {"w": np.zeros((2, 3), np.float32)}}),
        "state_from_numpy": lambda: convert.state_from_numpy(state_np),
        "init_mlp": lambda: init_mlp(prng.PRNGKey(0, device="cpu"), 4, 3,
                                     2),
        "MLP": lambda: MLP(4, 3, 2),
        "PRNGKey": lambda: prng.PRNGKey(0),
        "init_controller": lambda: controller.init_controller(
            4, controller.ControllerConfig()),
        "init_queue": lambda: compact.init_queue(4),
        "lm_params_from_numpy": lambda: convert.lm_params_from_numpy(
            lm_tree, lm_cfg),
        "lm_cache_from_numpy": lambda: convert.lm_cache_from_numpy(cache_np),
        "lm_init": lambda: lm.init(0),
        "lm_init_cache": lambda: lm.init_cache(1, 8),
        "serve": lambda: serve(lm_cfg, batch=1, prompt_len=4, new_tokens=2,
                               seed=0),
    }
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        calls[entry]()


def test_unported_features_are_refused():
    from repro_torch.core import FLConfig, init_state
    from repro_torch.utils import make_flat_spec

    params0 = {"theta": torch.zeros(3)}
    spec = make_flat_spec(params0)
    for layout in (spec, None):
        with pytest.raises(NotImplementedError):
            init_state(FLConfig(n_clients=4, algorithm="scaffold"), params0,
                       spec=layout, device="cpu")
    # The host-offloaded state is ported: compact rounds on the flat
    # layout; the tree layout and the dense round are refused as the
    # reference refuses them.
    host = init_state(FLConfig(n_clients=4, state_backend="host",
                               compact=True), params0, spec=spec,
                      device="cpu")
    assert host.theta.shape == (4, 3) and host.distances is None
    with pytest.raises(ValueError, match="flat"):
        init_state(FLConfig(n_clients=4, state_backend="host", compact=True),
                   params0, spec=None, device="cpu")
    with pytest.raises(ValueError, match="compact"):
        init_state(FLConfig(n_clients=4, state_backend="host"), params0,
                   spec=spec, device="cpu")
    # Compressed consensus is ported on the flat layout (its residual);
    # the tree layout refuses it as the reference does.
    state = init_state(FLConfig(n_clients=4, consensus_compress="int8"),
                       params0, spec=spec, device="cpu")
    assert state.comm.shape == (4, 3)
    with pytest.raises(ValueError, match="flat"):
        init_state(FLConfig(n_clients=4, consensus_compress="int8"),
                   params0, spec=None, device="cpu")
    # The tree layout (spec=None) is ported: stacked leaves, unstacked ω.
    state = init_state(FLConfig(n_clients=4), params0, spec=None,
                       device="cpu")
    assert state.theta["theta"].shape == (4, 3)
    assert state.omega["theta"].shape == (3,)
    # So is the stale-tolerant round: its delay pipeline, in either layout.
    for layout in (spec, None):
        state = init_state(FLConfig(n_clients=4, max_staleness=2), params0,
                           spec=layout, device="cpu")
        assert state.inflight.hist.shape == (4, 3)


@pytest.mark.parametrize("builder", ["make_round_fn",
                                     "make_scaffold_round"])
def test_rounds_built_for_cuda_turn_tf32_off(builder, monkeypatch):
    """A round hands its device to ``device.fp32_products``, which on a
    CUDA device switches TF32 off for cuBLAS and cuDNN (the CNN's
    convolutions), so the solve runs in full fp32 as on the CPU, and
    makes cuDNN's algorithms deterministic, so a round repeats bit for
    bit.  The round is built on the CPU, so the test reads the same on
    any machine."""
    from repro_torch import device as device_mod
    from repro_torch.core import FLConfig, baselines, fedback

    module = baselines if builder == "make_scaffold_round" else fedback
    seen = []
    monkeypatch.setattr(module, "fp32_products", seen.append)
    data = {"x": torch.zeros(4, 2, 3), "y": torch.zeros(4, 2)}
    getattr(module, builder)(FLConfig(n_clients=4), lambda *a: 0.0, data,
                             device="cpu")
    assert seen == [torch.device("cpu")]
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", False)
    device_mod.fp32_products(torch.device("cpu"))
    assert torch.backends.cuda.matmul.allow_tf32
    assert torch.backends.cudnn.allow_tf32
    assert not torch.backends.cudnn.deterministic
    device_mod.fp32_products(torch.device("cuda"))
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32
    assert torch.backends.cudnn.deterministic


def test_unported_model_paths_raise():
    """Every architecture of the reference resolves and builds, with no
    ``NotImplementedError`` left for a family, a config or a mask; what
    the port refuses raises as the reference does: an unknown
    architecture (``KeyError``), an unknown family or mask
    (``ValueError``), and serving the audio encoder (``ValueError``)."""
    import dataclasses

    from repro_torch.configs import ARCHITECTURES, get_config
    from repro_torch.models import abstract_params, attention, build_model

    for arch in ARCHITECTURES:
        assert abstract_params(build_model(get_config(arch)))["layers"]
    for arch in ("qwen3-moe-236b", "mixtral", "paligemma-2b", "hubert"):
        with pytest.raises(KeyError):
            get_config(arch)
    cfg = get_config("zamba2-2.7b").reduced()
    for family in ("moe-dense", "vision", "speech"):
        with pytest.raises(ValueError, match="unknown family"):
            build_model(dataclasses.replace(cfg, family=family))
    p = {k: torch.zeros(8, 8) for k in ("wq", "wk", "wv", "wo")}
    for mode in ("prefix-lm", "bidirectional"):
        with pytest.raises(ValueError, match="mask_mode"):
            attention.attention_forward(
                p, torch.zeros(1, 3, 8), positions=torch.arange(3),
                rope_theta=1e4, num_heads=2, num_kv_heads=2, head_dim=4,
                mask_mode=mode)
    audio = build_model(get_config("hubert-xlarge").reduced())
    with pytest.raises(ValueError, match="no cache"):
        audio.init_cache(1, 8, device="cpu")


def test_kernel_build_is_lazy():
    from repro_torch.kernels import _build
    assert len(_build.SOURCES) == 2
    assert all(src.is_file() for src in _build.SOURCES)
    assert _build.library_path().parent.parent == ROOT / "build" / "kernels"
    code = ("import repro_torch.kernels._build as b, repro_torch.core; "
            "import repro_torch.kernels.ops; assert b._lib is None")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr  # importing built nothing


def test_time_kernels_refuses_without_cuda(monkeypatch, capsys):
    from repro_torch.launch import time_kernels
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert time_kernels.main([]) == 1
    out = capsys.readouterr()
    assert out.out == "" and "no CUDA device" in out.err

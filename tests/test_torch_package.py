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
              "optim/sgd.py", "models/mlp.py", "data/synthetic.py",
              "data/partition.py", "data/pipeline.py",
              "configs/paper_mnist.py"):
        assert m in names, m
    assert (PKG / "csrc" / "fedback_kernels.cu").is_file()


@pytest.mark.parametrize("path", MODULES,
                         ids=[p.relative_to(PKG).as_posix() for p in MODULES])
def test_module_imports_no_jax_and_no_repro(path):
    for name in _imports(path):
        top = name.split(".")[0]
        assert top not in ("jax", "jaxlib", "repro", "flax", "optax"), \
            f"{path.name} imports {name}"


def test_importing_the_port_leaves_jax_out():
    code = ("import sys, repro_torch, repro_torch.core, repro_torch.kernels."
            "ops, repro_torch.convert, repro_torch.configs.paper_mnist, "
            "repro_torch.data, repro_torch.models; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')]; print(bad); sys.exit(bool(bad))")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_default_device_raises_without_cuda(monkeypatch):
    from repro_torch.core import FLConfig, init_state, make_eval_fn, \
        make_round_fn
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
    state = init_state(cfg, params0, spec=spec, device="cpu")
    assert state.theta.device.type == "cpu" and state.theta.shape == (4, 3)


BUILDERS = ("params_from_numpy", "state_from_numpy", "init_mlp", "MLP",
            "PRNGKey", "init_controller", "init_queue")


@pytest.mark.parametrize("entry", BUILDERS)
def test_default_device_of_builders_raises_without_cuda(entry, monkeypatch):
    """Weights, converted state and the state's parts are made on CUDA
    unless the caller asks for another device; without CUDA they raise
    rather than land on the CPU."""
    import numpy as np

    from repro_torch import convert, prng
    from repro_torch.core import FLConfig, compact, controller, init_state
    from repro_torch.models import MLP, init_mlp
    from repro_torch.utils import make_flat_spec

    params0 = {"theta": torch.zeros(3)}
    state_np = convert.state_to_numpy(init_state(
        FLConfig(n_clients=4), params0, spec=make_flat_spec(params0),
        device="cpu"))
    calls = {
        "params_from_numpy": lambda: convert.params_from_numpy(
            {"fc1": {"w": np.zeros((2, 3), np.float32)}}),
        "state_from_numpy": lambda: convert.state_from_numpy(state_np),
        "init_mlp": lambda: init_mlp(0, 4, 3, 2),
        "MLP": lambda: MLP(4, 3, 2),
        "PRNGKey": lambda: prng.PRNGKey(0),
        "init_controller": lambda: controller.init_controller(
            4, controller.ControllerConfig()),
        "init_queue": lambda: compact.init_queue(4),
    }
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        calls[entry]()


def test_unported_features_are_refused():
    from repro_torch.core import FLConfig, init_state
    from repro_torch.utils import make_flat_spec

    params0 = {"theta": torch.zeros(3)}
    spec = make_flat_spec(params0)
    for kw in (dict(max_staleness=2), dict(consensus_compress="int8"),
               dict(algorithm="fedavg"), dict(state_backend="host")):
        with pytest.raises(NotImplementedError):
            init_state(FLConfig(n_clients=4, **kw), params0, spec=spec,
                       device="cpu")
    with pytest.raises(NotImplementedError, match="flat"):
        init_state(FLConfig(n_clients=4), params0, spec=None, device="cpu")


def test_kernel_build_is_lazy():
    from repro_torch.kernels import _build
    assert _build.SOURCE.is_file()
    assert _build.library_path().parent.parent == ROOT / "build" / "kernels"
    code = ("import repro_torch.kernels._build as b, repro_torch.core; "
            "import repro_torch.kernels.ops; assert b._lib is None")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr  # importing built nothing

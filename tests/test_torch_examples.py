"""The example twins (``examples/*_torch.py``) run in-process on the CPU
at tiny settings, through their ``main(argv)``: each must finish and
report what its reference prints.  On the card they run with no
``--device`` (``chip_smoke.py`` phase 10d)."""
import functools
import importlib.util
import os
import types

import pytest
import torch

from repro_torch.configs import paper_cifar
from repro_torch.kernels import ops
from torch_threads import _one_torch_thread  # noqa: F401

EXAMPLES = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "examples")
TWINS = ("quickstart", "federated_image", "serve_lm", "sharded_sweep",
         "fedback_transformer")


def _load(name):
    path = os.path.join(EXAMPLES, f"{name}_torch.py")
    spec = importlib.util.spec_from_file_location(f"{name}_torch", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(autouse=True)
def _no_kernel_launch():
    ops.reset_launch_counts()
    yield
    assert ops.launch_counts() == {k: 0 for k in ops.KERNELS}


@pytest.mark.parametrize("name", TWINS)
def test_twin_names_its_reference_and_imports_no_jax(name):
    text = open(os.path.join(EXAMPLES, f"{name}_torch.py")).read()
    assert f"examples/{name}.py" in text
    assert "import jax" not in text and "from repro." not in text
    assert "--device cpu" in text


def test_quickstart(capsys):
    rep = _load("quickstart").main(["--device", "cpu", "--rounds", "3"])
    assert rep["device"] == "cpu" and 0 < rep["events"] <= 3 * 20
    assert 0 < rep["rate"] <= 1 and 0 <= rep["accuracy"] <= 1
    assert "realized participation rate" in capsys.readouterr().out


def test_federated_image_all_algorithms_and_resume(tmp_path, capsys):
    fi = _load("federated_image")
    reps = fi.main(["--device", "cpu", "--algorithm", "all", "--rounds",
                    "1", "--ckpt-dir", str(tmp_path), "--ckpt-every", "1"])
    assert [r["algorithm"] for r in reps] == list(fi.ALGORITHMS)
    assert (tmp_path / "fedback" / "ckpt_00000001.npz").is_file()
    out = capsys.readouterr().out
    assert "events to 90% (mnist" in out
    # Resume FedBack after its round 0 and run round 1: the same state
    # as two rounds straight.
    straight = fi.main(["--device", "cpu", "--rounds", "2"])[0]
    resumed = fi.main(["--device", "cpu", "--rounds", "2", "--ckpt-dir",
                       str(tmp_path / "fedback")])[0]
    assert resumed["start"] == 1 and "resumed from" in \
        capsys.readouterr().out
    assert resumed["accuracy"] == straight["accuracy"]


def test_federated_image_cifar(monkeypatch):
    """``--dataset cifar`` on the paper grid's CIFAR workload cut to its
    first 10 clients (the full 100 clients' dense round takes ~35 s on
    one CPU thread)."""
    fi = _load("federated_image")
    n = 10

    def workload(seed, device=None):
        data, test, params0, logits = paper_cifar.workload(seed, device)
        return {k: v[:n] for k, v in data.items()}, test, params0, logits

    monkeypatch.setattr(fi, "paper_cifar", types.SimpleNamespace(
        workload=workload, TARGET_ACCURACY=paper_cifar.TARGET_ACCURACY,
        fl_config=functools.partial(paper_cifar.fl_config, n_clients=n)))
    rep = fi.main(["--device", "cpu", "--dataset", "cifar", "--rounds",
                   "1"])[0]
    assert rep["algorithm"] == "fedback" and rep["events"] == n
    assert 0 <= rep["accuracy"] <= 1


def test_serve_lm():
    rep = _load("serve_lm").main(["--device", "cpu", "--batch", "2",
                                  "--prompt-len", "16", "--new-tokens", "3"])
    assert rep["device"] == "cpu" and len(rep["tokens"]) == 2
    assert all(len(t) == 3 for t in rep["tokens"])
    assert rep["params"] > 0 and rep["new_tokens"] == 3


def test_sharded_sweep():
    rep = _load("sharded_sweep").main(["--device", "cpu", "--rounds", "3",
                                       "--sweep-rounds", "2", "--shards",
                                       "4"])
    assert rep["events_equal"] and rep["omega_gap"] < 1e-5
    assert len(rep["runs"]) == 8
    assert all(0 <= r <= 1 for _, _, r in rep["runs"])


def test_fedback_transformer():
    rep = _load("fedback_transformer").main(["--device", "cpu",
                                             "--rounds", "2"])
    assert len(rep["event_count"]) == 2 and rep["device"] == "cpu"
    assert all(0 <= e <= 2 for e in rep["event_count"])
    assert all(torch.isfinite(torch.tensor(rep["losses"])))

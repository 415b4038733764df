"""The training launcher (``repro_torch.launch.train``) against the JAX
package's (``repro.launch.train``): both engines, two rounds each on the
CPU, print the reference's lines.

The reference runs in one subprocess (its cross-pod engine needs two
host devices, forced by ``XLA_FLAGS`` before ``jax`` is imported); the
port's ``main`` runs in this process with ``--device cpu``.
The round lines must be equal character for character: the events, the
cumulative count and the losses and accuracies at four decimals.  The
cross-pod engine's first line names the placement, which differs by
design where the pods are not split (a pod × data × model device mesh
there, a device or pod shards here), and is held by its form.  With
``--model-par 2 --host-devices 8`` both lay the same (2, 2, 2) mesh
(the reference over 8 forced host devices in a subprocess of its own,
the port over the CPU) and every line is equal.
"""
import os
import re
import subprocess
import sys

import pytest

from repro_torch.launch import train

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIM = ["--engine", "sim", "--rounds", "2", "--clients", "10",
       "--log-every", "1"]
CROSSPOD = ["--engine", "crosspod", "--arch", "granite-3-2b", "--reduced",
            "--rounds", "2"]

_REFERENCE = r"""
import sys
from repro.launch import train
for argv in (sys.argv[1].split(), sys.argv[2].split()):
    sys.argv = ["train"] + argv
    train.main()
    print("--", flush=True)
"""


@pytest.fixture(scope="module")
def reference_lines():
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=2")
    out = subprocess.run(
        [sys.executable, "-c", _REFERENCE, " ".join(SIM),
         " ".join(CROSSPOD + ["--model-par", "1"])],
        env=env, capture_output=True, text=True, timeout=600, cwd=REPO)
    assert out.returncode == 0, out.stderr[-3000:]
    sim, crosspod, _ = out.stdout.split("--\n")
    return {"sim": sim.splitlines(), "crosspod": crosspod.splitlines()}


MESH = CROSSPOD + ["--model-par", "2", "--host-devices", "8"]


@pytest.fixture(scope="module")
def reference_mesh_lines():
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    out = subprocess.run(
        [sys.executable, "-m", "repro.launch.train", *MESH], env=env,
        capture_output=True, text=True, timeout=600, cwd=REPO)
    assert out.returncode == 0, out.stderr[-3000:]
    return out.stdout.splitlines()


def _port_lines(argv, capsys):
    train.main(argv + ["--device", "cpu"])
    return capsys.readouterr().out.splitlines()


def test_sim_engine_prints_the_reference_lines(reference_lines, capsys):
    got = _port_lines(SIM, capsys)
    assert got == reference_lines["sim"]
    assert len(got) == 2 and re.fullmatch(
        r"round +1 events= *\d+ cum= *\d+ loss=\d+\.\d{4} acc=\d\.\d{4}",
        got[1])


@pytest.mark.parametrize("shards", [1, 2])
def test_crosspod_engine_prints_the_reference_lines(reference_lines, capsys,
                                                    shards):
    got = _port_lines(CROSSPOD + ["--shards", str(shards)], capsys)
    want = reference_lines["crosspod"]
    assert want[0] == "mesh: {'pod': 2, 'data': 1, 'model': 1}"
    assert got[0].startswith("mesh: {'pod': 2, ")
    assert got[1:] == want[1:]
    assert len(got) == 3 and re.fullmatch(
        r"round +1 events=\[[01] [01]\] cum=\d+ loss=\d+\.\d{4}", got[2])


def test_launcher_needs_a_card_unless_told_cpu(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train.main(CROSSPOD)


def test_crosspod_engine_on_a_pod_data_model_mesh(reference_mesh_lines,
                                                  capsys):
    got = _port_lines(MESH, capsys)
    assert reference_mesh_lines[0] == "mesh: {'pod': 2, 'data': 2, " \
        "'model': 2}"
    assert got == reference_mesh_lines
    assert len(got) == 3 and re.fullmatch(
        r"round +1 events=\[[01] [01]\] cum=\d+ loss=\d+\.\d{4}", got[2])


def test_shards_with_model_par_raises():
    with pytest.raises(SystemExit, match="--shards"):
        train.main(CROSSPOD + ["--shards", "2", "--model-par", "2",
                               "--device", "cpu"])

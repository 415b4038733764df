"""The port's training step on a model mesh against the JAX package's
jitted sharded step, on the CPU, for the moe family (moonshot in tp,
fsdp_tp and ep, and in fsdp on a data axis of 2: its load-balance loss
of the whole batch), the vlm (paligemma) and the audio encoder (hubert)
in tp and fsdp_tp, at tests/torch_train_tp_reference.py's grades.  The
dense, ssm and hybrid families are in
tests/test_torch_train_tp_reference_a.py."""
import pytest

from repro_torch.kernels import ops
from torch_threads import _one_torch_thread  # noqa: F401
from torch_train_tp_reference import check_case, run_reference

CASES = [("moonshot-v1-16b-a3b", "tp", (1, 4), 1),
         ("moonshot-v1-16b-a3b", "fsdp_tp", (2, 2), 1),
         ("moonshot-v1-16b-a3b", "ep", (1, 4), 1),
         ("moonshot-v1-16b-a3b", "fsdp", (2, 2), 1),
         ("paligemma-3b", "tp", (1, 4), 1),
         ("paligemma-3b", "fsdp_tp", (2, 2), 1),
         ("hubert-xlarge", "tp", (1, 4), 1),
         ("hubert-xlarge", "fsdp_tp", (2, 2), 1)]


@pytest.fixture(autouse=True)
def _counts_stay_zero():
    ops.reset_launch_counts()
    yield
    assert ops.launch_counts() == {k: 0 for k in ops.KERNELS}


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    return run_reference(CASES, tmp_path_factory.mktemp("train_tp_b")
                         / "ref.npz")


@pytest.mark.parametrize("arch,mode,shape,grad_accum", CASES)
def test_mesh_step_matches_the_references_sharded_step(reference, arch,
                                                       mode, shape,
                                                       grad_accum):
    check_case(reference, arch, mode, shape, grad_accum)

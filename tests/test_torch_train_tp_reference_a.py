"""The port's training step on a model mesh in modes tp and fsdp_tp
against the JAX package's jitted sharded step, on the CPU, for the
dense (granite, also with grad_accum 2), ssm (mamba2) and hybrid
(zamba2) families (tests/torch_train_tp_reference.py runs the
reference and holds the port to it: the loss at rtol 2e-5, the first
moment at rtol 1e-4 / atol 1e-7, the parameters at the solve grade
where the gradient is firm, the shardings equal element by element).
The moe, vlm and audio families are in
tests/test_torch_train_tp_reference_b.py."""
import pytest

from repro_torch.kernels import ops
from torch_threads import _one_torch_thread  # noqa: F401
from torch_train_tp_reference import check_case, run_reference

CASES = [("granite-3-2b", "tp", (1, 4), 1),
         ("granite-3-2b", "fsdp_tp", (2, 2), 1),
         ("granite-3-2b", "tp", (1, 4), 2),
         ("granite-3-2b", "fsdp_tp", (2, 2), 2),
         ("mamba2-2.7b", "tp", (1, 4), 1),
         ("mamba2-2.7b", "fsdp_tp", (2, 2), 1),
         ("zamba2-2.7b", "tp", (1, 4), 1),
         ("zamba2-2.7b", "fsdp_tp", (2, 2), 1)]


@pytest.fixture(autouse=True)
def _counts_stay_zero():
    ops.reset_launch_counts()
    yield
    assert ops.launch_counts() == {k: 0 for k in ops.KERNELS}


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    return run_reference(CASES, tmp_path_factory.mktemp("train_tp_a")
                         / "ref.npz")


@pytest.mark.parametrize("arch,mode,shape,grad_accum", CASES)
def test_mesh_step_matches_the_references_sharded_step(reference, arch,
                                                       mode, shape,
                                                       grad_accum):
    check_case(reference, arch, mode, shape, grad_accum)

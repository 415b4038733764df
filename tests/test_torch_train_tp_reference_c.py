"""The port's training step on a model mesh against the JAX package's
jitted sharded step, on the CPU, where the query heads straddle the
model shards' column blocks of wq (granite and zamba2 with 6 heads,
paligemma with 2, on 4 model shards: ``sharding/serve.py::TpLayout``
gathers q's columns and each shard attends over the heads it touches),
in tp on (1, 4) and fsdp_tp on (2, 4), at
tests/torch_train_tp_reference.py's grades.  The families' own reduced
configurations are in tests/test_torch_train_tp_reference_a.py and
tests/test_torch_train_tp_reference_b.py."""
import pytest

from repro_torch.kernels import ops
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.launch.steps import make_train_step
from repro_torch.models import build_model
from repro_torch.sharding.serve import TpLayout
from torch_threads import _one_torch_thread  # noqa: F401
from torch_train_tp_reference import B, CONFIGS, SEQ, check_case, \
    config_of, run_reference

CASES = [(name, mode, shape, 1) for name in CONFIGS
         for mode, shape in (("tp", (1, 4)), ("fsdp_tp", (2, 4)))]


@pytest.fixture(autouse=True)
def _counts_stay_zero():
    ops.reset_launch_counts()
    yield
    assert ops.launch_counts() == {k: 0 for k in ops.KERNELS}


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    return run_reference(CASES, tmp_path_factory.mktemp("train_tp_c")
                         / "ref.npz")


@pytest.mark.parametrize("arch,mode,shape,grad_accum", CASES)
def test_straddled_heads_match_the_references_sharded_step(
        reference, arch, mode, shape, grad_accum):
    cfg = config_of(arch)
    mesh = make_test_mesh(shape)
    _, args = make_train_step(build_model(cfg), mesh, batch=B, seq=SEQ,
                              mode=mode)
    assert TpLayout(cfg, args.in_specs[0], mesh).q_spans
    check_case(reference, arch, mode, shape, grad_accum)

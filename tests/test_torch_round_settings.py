"""Seven round settings no other port test covers, each over 5
state-synced rounds against live JAX with tests/test_torch_round.py's
harness and grades: the linf (compact) and cosine (dense) trigger
metrics, a cold-started solve, an explicit capacity, a fixed commit
limit, plain SGD, and full selection on the compact round."""
import jax.numpy as jnp
import pytest

from repro.models.mlp import make_loss_fn as jax_make_loss_fn
from repro.models.mlp import mlp_logits as jax_mlp_logits
from repro_torch.convert import nest_params, params_from_numpy
from repro_torch.models import make_loss_fn
from test_torch_round import MLP_BASE, N, _both, _mlp_problem, _run_synced

SETTINGS = {
    "linf_compact": dict(trigger_metric="linf", compact=True,
                         use_trigger_kernel=False),
    "cosine_dense": dict(trigger_metric="cosine", compact=False,
                         use_trigger_kernel=False),
    "cold_start": dict(warm_start=False, compact=True, fused_gss=True),
    "capacity_3": dict(capacity=3, compact=True, fused_gss=True),
    "fixed_limit": dict(adaptive_capacity=False, compact=True),
    "no_momentum": dict(momentum=0.0, compact=False),
    "full_compact": dict(selection="full", compact=True, fused_gss=True),
}


@pytest.mark.parametrize("name", list(SETTINGS))
def test_round_setting_matches_jax(name):
    params, x, y = _mlp_problem()
    jcfg, tcfg = _both(dict(MLP_BASE, **SETTINGS[name]),
                       dict(K=1.0, alpha=0.9))
    seen = _run_synced(
        jcfg, tcfg, jax_make_loss_fn(jax_mlp_logits), make_loss_fn(),
        {"x": jnp.asarray(x), "y": jnp.asarray(y)}, {"x": x, "y": y},
        params, nest_params(params_from_numpy(params, device="cpu")),
        rounds=5)
    assert seen["flipped_rounds"] == 0
    if name == "full_compact":
        assert seen["events"] == 5 * N and seen["deferred"] > 0
    else:
        assert 0 < seen["events"] < 5 * N
    if name == "capacity_3":
        assert seen["deferred"] > 0

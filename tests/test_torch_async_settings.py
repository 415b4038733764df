"""Eleven stale-tolerant round settings no other port test covers, each
over 10 state-synced rounds against live JAX with
tests/test_torch_round.py's harness and grades: least squares, N = 64,
L̄ = 0.25, K = 0.5, α = 0.9, ``max_staleness`` 2 (3 for the fixed
capacity).  Each run's events, landed solves and deferrals, summed over
its rounds, are pinned: the reference saw the same totals, so a setting
that stopped exercising its path would show here."""
import numpy as np
import pytest

from repro.data import make_least_squares as jax_make_least_squares
from repro_torch.data import make_least_squares
from test_torch_round import _both, _run_synced

BASE = dict(algorithm="fedback", n_clients=64, participation=0.25, rho=1.0,
            lr=0.1, momentum=0.0, epochs=2, batch_size=4, seed=0,
            capacity_slack=1.25, max_staleness=2)
# An i.i.d. arrival trace: each client arrives with probability 0.3.
TRACE = np.random.default_rng(3).random((10, 64)) < 0.3
# name: (FLConfig keywords, layout, trace, (events, landed, deferred))
SETTINGS = {
    "round_robin_compact": (dict(selection="round_robin", compact=True),
                            "flat", None, (160, 89, 0)),
    "bernoulli_dense": (dict(selection="bernoulli"), "flat", None,
                        (152, 77, 0)),
    "fedprox_compact": (dict(algorithm="fedprox", mu=0.1, compact=True),
                        "flat", None, (160, 87, 0)),
    "linf_compact": (dict(trigger_metric="linf", compact=True), "flat",
                     None, (330, 94, 175)),
    "cosine_dense": (dict(trigger_metric="cosine"), "flat", None,
                     (299, 168, 0)),
    "admm_full_dense": (dict(algorithm="admm"), "flat", None,
                        (409, 168, 0)),
    "fedadmm_compact_fused": (dict(algorithm="fedadmm", compact=True,
                                   fused_gss=True), "flat", None,
                              (160, 87, 0)),
    "tree_dense_uniform": (dict(staleness_schedule="uniform"), "tree",
                           None, (357, 182, 0)),
    "tree_compact_served": (dict(compact=True), "tree", TRACE,
                            (165, 81, 7)),
    "round_robin_flat_served": (dict(selection="round_robin"), "flat",
                                TRACE, (152, 75, 0)),
    "capacity_5_fixed_s3": (dict(compact=True, capacity=5,
                                 adaptive_capacity=False, max_staleness=3),
                            "flat", None, (315, 29, 499)),
}


@pytest.mark.parametrize("name", list(SETTINGS))
def test_stale_tolerant_setting_matches_jax(name):
    kw, layout, trace, totals = SETTINGS[name]
    jcfg, tcfg = _both(dict(BASE, **kw), dict(K=0.5, alpha=0.9))
    jdata, jparams, jloss = jax_make_least_squares(64, 8, 5)
    tdata, tparams, tloss = make_least_squares(64, 8, 5, device="cpu")
    seen = _run_synced(jcfg, tcfg, jloss, tloss, jdata, tdata, jparams,
                       tparams, rounds=10, layout=layout, trace=trace)
    assert seen["flipped_rounds"] == 0
    assert (seen["events"], seen["landed"], seen["deferred"]) == totals

"""Mutation matrix of the port's checker: each seeded regression turns
its own rule red and no other (the twin of
``tests/test_analysis_mutations.py``).

``body_transform`` (given to ``build_artifact``) is the seeding hook: it
wraps the finished round — on the host backend, through
``make_round_fn``, the solve leg — so the engine's code stays
untouched.  Every artifact is recorded on the
CPU, where the kernel wrappers run their plain versions.
"""
import pytest
import torch

from repro_torch.analysis.artifacts import FAST_MATRIX, ConfigKey, \
    build_artifact
from repro_torch.analysis.rules import evaluate
from repro_torch.sharding.clients import unshard_rows

DENSE_FLAT = ConfigKey("dense", "flat", "sync", "uniform", 1)
COMPACT_FLAT = ConfigKey("compact", "flat", "sync", "uniform", 1)
HOST_COMPACT = ConfigKey("compact", "flat", "sync", "uniform", 1,
                         "none", "host")
DENSE_2D = ConfigKey("dense", "flat", "sync", "uniform", 2)


def failing_rules(key, **kw):
    art = build_artifact(key, device="cpu", **kw)
    return sorted(r.rule for r in evaluate(art) if r.status == "fail")


def before_round(change):
    """A body_transform that applies ``change`` to the state first."""
    def transform(round_fn):
        def wrapped(state, *args):
            return round_fn(change(state), *args)
        return wrapped
    return transform


@pytest.mark.parametrize("key", FAST_MATRIX, ids=lambda k: k.name)
def test_unmutated_round_passes_every_rule(key):
    assert failing_rules(key) == []


def test_stray_full_width_subtraction():
    # An in-place (N, D) subtraction on θ before the dense round: one
    # sweep over its budget of one, no new buffer.
    def sweep(state):
        state.theta.sub_(0.0)
        return state

    assert failing_rules(DENSE_FLAT, body_transform=before_round(sweep)) \
        == ["no-full-width-sweeps"]


def test_read_back_inside_the_round():
    # .cpu() of a device vector inside the round: on the CPU it makes no
    # ATen op, and the op log still sees the read.
    def read_back(state):
        state.ctrl.delta.cpu()
        return state

    assert failing_rules(COMPACT_FLAT,
                         body_transform=before_round(read_back)) \
        == ["host-transfer-budget"]


def test_full_width_copy_on_the_host_leg():
    # The host backend's solve leg copies the whole (N, D) θ matrix to
    # the device: the row stream moves (C, D) tiles, never the state.
    def leak(solve_leg):
        def wrapped(state, plan, clock):
            state.theta.to(state.omega.device, copy=True)
            return solve_leg(state, plan, clock)
        return wrapped

    assert failing_rules(HOST_COMPACT, body_transform=leak) \
        == ["host-transfer-budget"]


def test_unfused_compact_commit():
    # fused_gss=False on the compact leg gives the same bits through K2
    # and three scatters; the kernel policy catches it.
    assert failing_rules(COMPACT_FLAT,
                         cfg_overrides={"fused_gss": False}) \
        == ["fused-admm-pass"]


def test_float64_leak_on_an_uncompressed_leg():
    def leak(state):
        step = torch.zeros((), dtype=torch.float64,
                           device=state.round.device)
        return state._replace(round=state.round + step.to(torch.int32))

    assert failing_rules(DENSE_FLAT, body_transform=before_round(leak)) \
        == ["no-f64-ops"]


def test_dropped_in_place_state():
    # A clone of θ before the fused compact round: the round writes the
    # clone in place, so θ's own storage is no longer the output's.
    def clone(state):
        return state._replace(theta=state.theta.clone())

    assert failing_rules(COMPACT_FLAT, body_transform=before_round(clone)) \
        == ["donated-state-aliases"]


def test_state_gathered_whole_to_shard_zero():
    # θ's shards gathered to shard 0 each round: a (N/P, D) block crosses
    # shards.
    def gather(shards):
        unshard_rows([s.theta for s in shards])
        return shards

    assert failing_rules(DENSE_2D, body_transform=before_round(gather)) \
        == ["collective-budget"]

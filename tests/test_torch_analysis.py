"""The port's static-invariant checker (``repro_torch.analysis``) against
the reference's (``repro.analysis``), on the CPU.

Each 1-device leg of the fast matrix is recorded by the port (its round
on the plain kernel versions) and traced by the live reference
(``build_artifact(key, compile=False)``: the jaxpr rules need no XLA
compile), and the facts the two share are held equal: kernel calls
against ``pallas_call`` equations, (N, D) sweeps, the host legs' row
stream.  The policy differences (the tree layout's trigger kernel, the
host legs' K1 + K3, D6's float64 FMAs, D7's new dense state) are pinned.
Then the 2-shard legs' bytes between shards, the signature and transfer
checks, the AST lint on seeded snippets, the op log's hooks and the CLI
against the committed baseline.
"""
import copy
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.analysis import astlint, cli, retrace
from repro_torch.analysis.artifacts import FAST_MATRIX, ConfigKey, \
    build_artifact
from repro_torch.analysis.oplog import OpLog
from repro_torch.analysis.retrace import run_serve_trace_check, \
    run_single_trace_check, run_transfer_guard_check
from repro_torch.analysis.rules import RULES, evaluate
from repro_torch.kernels import ops

ROOT = Path(__file__).resolve().parents[1]
BASELINE = ROOT / "src" / "repro_torch" / "analysis" / \
    "baseline_fast_cpu.json"
ONE_DEVICE = [k for k in FAST_MATRIX if k.devices == 1]
TWO_SHARDS = [k for k in FAST_MATRIX if k.devices == 2]

_PORT, _REF = {}, {}


def port(key):
    if key not in _PORT:
        art = build_artifact(key, device="cpu")
        _PORT[key] = (art, {r.rule: r for r in evaluate(art)})
    return _PORT[key]


def reference(key):
    """(pallas_call equations, (N, D) sweeps, host-transfer metrics) of
    the live reference's round for ``key``."""
    if key not in _REF:
        from repro.analysis import artifacts as ra
        from repro.analysis import rules as rr
        from repro.utils import hlo

        art = ra.build_artifact(ra.ConfigKey(*(getattr(key, f) for f in (
            "path", "layout", "timing", "shards", "devices", "compress",
            "backend"))), compile=False)
        sweeps = rr.FullWidthSweepBudget().check(art)
        _REF[key] = (hlo.jaxpr_eqn_counts(art.jaxpr).get("pallas_call", 0),
                     sweeps.metrics,
                     rr.HostTransferBudget().check(art).metrics)
    return _REF[key]


@pytest.mark.parametrize("key", ONE_DEVICE, ids=lambda k: k.name)
def test_port_facts_equal_the_reference(key):
    art, res = port(key)
    pallas, ref_sweeps, ref_host = reference(key)
    for r in res.values():
        assert r.status != "fail", (r.rule, r.violations)
    calls = res["fused-admm-pass"].metrics["kernel_calls"]
    sweeps = res["no-full-width-sweeps"].metrics
    if key.layout == "tree":
        # Policy difference: the port's trigger runs through its kernel
        # front end on the tree layout (here one (N, D) leaf → K1), the
        # reference's tree round launches no kernel.
        assert pallas == 0
        assert calls == {"trigger_sq_norms": 1}
        assert res["no-full-width-sweeps"].status == "skip"
        return
    if key.backend == "host":
        # Policy difference: the port's host round launches K1 and K3
        # on its working set; the reference's host solve program none.
        assert pallas == 0
        assert calls == {"trigger_sq_norms": 1, "fused_gss": 1}
        host = res["host-transfer-budget"].metrics
        for m in ("planned_row_stream_bytes", "row_stream_budget",
                  "server_pass_bytes"):
            assert host[m] == ref_host[m], m
        assert (host["planned_row_stream_bytes"],
                host["row_stream_budget"]) == (3840, 6144)
        assert host["plan_readbacks"] == 2 + (key.timing == "async")
        assert sweeps["full_width_sweeps"] == 0
        return
    assert sum(calls.values()) == pallas == 2
    if key.compress == "none":
        assert sweeps["full_width_sweeps"] == \
            ref_sweeps["full_width_sweeps"]
        assert sweeps["budget"] == ref_sweeps["budget"]
    else:
        # int8: the port's EF algebra keeps 4 (N, D) ops, the reference
        # 5; D6's float64 FMAs are the only float64 ops.
        assert sweeps["full_width_sweeps"] == 4
        assert sweeps["full_width_sweeps"] <= ref_sweeps["budget"] == 5
        assert res["no-f64-ops"].metrics["d6_fma_f64_ops"] == 46
    assert res["host-transfer-budget"].metrics["syncs"] == 0


@pytest.mark.parametrize("key,fields,allocs", [
    (FAST_MATRIX[0], "new", 4),  # D7: gated θ/λ/z and z = θ + λ⁺
    (FAST_MATRIX[1], "inplace", 0),
    (FAST_MATRIX[2], "inplace", 0),
    (FAST_MATRIX[3], "new", 7),  # + the tree's plain λ⁺ and centers
    (FAST_MATRIX[7], "new", 9),  # + the EF residual's algebra
], ids=lambda x: x.name if isinstance(x, ConfigKey) else str(x))
def test_state_written_in_place_or_new_is_pinned(key, fields, allocs):
    art, res = port(key)
    m = res["donated-state-aliases"].metrics
    assert {m["fields"][f] for f in ("theta", "lam", "z_prev")} == {fields}
    assert m["state_allocations"] == m["budget"] == allocs


@pytest.mark.parametrize("key,total,by_kind", [
    (TWO_SHARDS[0], 644, {"all-reduce": 80, "broadcast": 84,
                          "all-gather": 224, "scatter": 256}),
    (TWO_SHARDS[1], 672, {"all-reduce": 108, "broadcast": 84,
                          "all-gather": 224, "scatter": 256}),
    (TWO_SHARDS[2], 672, {"all-reduce": 32, "broadcast": 156,
                          "all-gather": 228, "scatter": 256}),
    (TWO_SHARDS[3], 676, {"all-reduce": 16, "broadcast": 148,
                          "all-gather": 256, "scatter": 256}),
], ids=lambda x: x.name if isinstance(x, ConfigKey) else str(x))
def test_two_shard_legs_bytes_between_shards_are_pinned(key, total,
                                                        by_kind):
    art, res = port(key)
    for r in res.values():
        assert r.status != "fail", (r.rule, r.violations)
    m = res["collective-budget"].metrics
    assert m["total_bytes"] == total
    assert {k: m[k]["bytes"] for k in by_kind} == by_kind
    assert m["total_bytes"] <= m["budget_bytes"]
    assert res["no-full-width-sweeps"].status == "skip"
    sharded = {"trigger_sq_norms_sharded": 1}
    sharded.update({"fused_gss": 2} if key.path == "compact"
                   else {"admm_update_sharded": 1})
    assert res["fused-admm-pass"].metrics["kernel_calls"] == sharded


@pytest.mark.parametrize("check", [run_single_trace_check,
                                   run_serve_trace_check])
def test_signature_checks_pass_and_fail_under_shape_mutation(check):
    ok = check(device="cpu")
    assert ok.status == "pass", ok.violations
    assert ok.metrics["signatures"] == 1
    bad = check(device="cpu", shape_mutation=True)
    assert bad.status == "fail"
    assert bad.metrics["signatures"] > 1


@pytest.mark.parametrize("check", [run_single_trace_check,
                                   run_serve_trace_check])
def test_signature_checks_fail_when_the_first_round_raises(check,
                                                          monkeypatch):
    # A round that crashes on its first call leaves one entry, the
    # raise; it must read as a failure, never as "one signature".
    def crashing(*args, **kw):
        def round_fn(state, *round_args):
            raise RuntimeError("seeded crash")
        return round_fn
    monkeypatch.setattr(retrace, "make_round_fn", crashing)
    res = check(device="cpu")
    assert res.status == "fail"
    assert any("seeded crash" in v for v in res.violations)


def test_transfer_guard_passes():
    res = run_transfer_guard_check(device="cpu")
    assert res.status == "pass", res.violations
    assert res.metrics["syncs"] == 0


_SNIPPETS = {
    "TC101": "def body(x):\n    return np.zeros(3)\n",
    "TC102": "def body(x):\n    return x.sum().item()\n",
    "TC103": "def body(x):\n    return float(torch.sum(x))\n",
    "TC104": "def body(x):\n    if torch.any(x > 0):\n        x = -x\n"
             "    return x\n",
}


@pytest.mark.parametrize("code", sorted(_SNIPPETS))
def test_lint_codes_fire_and_the_pragma_exempts(code):
    src = _SNIPPETS[code]
    scopes = {"m.py": ("body",)}
    found = astlint.lint_source(src, "m.py", scopes=scopes)
    assert [f.code for f in found] == [code]
    lines = src.splitlines()
    i = found[0].line - 1
    lines[i] += "  # tracecheck: ok — seeded"
    assert astlint.lint_source("\n".join(lines), "m.py", scopes=scopes) == []
    # Outside a registered round body the lint is silent.
    assert astlint.lint_source(src, "m.py", scopes={"m.py": ("x",)}) == []


def test_lint_of_the_port_is_clean():
    assert astlint.lint_repo() == []


def test_nested_kernel_wrappers_count_the_innermost_call():
    rng = np.random.default_rng(0)
    z = torch.from_numpy(rng.normal(size=(6, 5)).astype(np.float32))
    w = torch.from_numpy(rng.normal(size=(5,)).astype(np.float32))
    ops.reset_launch_counts()
    with OpLog("cpu") as log:
        got = ops.trigger_sq_norms_pytree({"a": z}, {"a": w})
    torch.testing.assert_close(got, ops.trigger_sq_norms_ref(z, w),
                               rtol=0, atol=0)
    assert log.calls == {"trigger_sq_norms": 1}
    assert log.launches == {}
    assert all(op.within(("kernel/trigger_sq_norms",)) for op in log.ops)
    assert ops.call_counts()["trigger_sq_norms"] == 1
    ops.reset_launch_counts()
    assert set(ops.call_counts().values()) == {0}


def test_body_transform_is_the_host_backends_hook():
    # A device round is wrapped by its caller (build_artifact); only the
    # host backend's solve leg is out of its reach.
    from repro_torch.analysis.artifacts import build_config, build_problem
    from repro_torch.core.fedback import make_round_fn

    key = ConfigKey("dense", "flat", "sync", "uniform", 1)
    data, _params0, loss_fn, spec, ragged = build_problem(key,
                                                          device="cpu")
    with pytest.raises(ValueError, match="host backend"):
        make_round_fn(build_config(key), loss_fn, data, spec=spec,
                      ragged=ragged, device="cpu",
                      body_transform=lambda f: f)


def test_op_log_sees_reads_the_dispatcher_cannot():
    x = torch.arange(4.0)
    with OpLog("cpu") as log:
        x.cpu()  # no ATen op on the CPU
        bool(x.sum() > 0)
        torch.nonzero(x)
    kinds = [what for what, _ in log.syncs()]
    assert kinds == ["Tensor.cpu", "Tensor.__bool__", "nonzero"]


@pytest.mark.parametrize("rate", [0.1, 0.25, 1 / 3, 0.29, 0.7, 1e-8, 2.0])
def test_controller_target_rounds_on_the_host_as_before(rate):
    from repro_torch.core.controller import _target

    want = torch.tensor(float(rate), dtype=torch.float32).item()
    got = _target(rate, torch.device("cpu"))
    assert isinstance(got, float)
    assert np.float64(got).tobytes() == np.float64(want).tobytes()


def test_rules_keep_the_reference_names():
    from repro.analysis import rules as rr

    assert [r.name for r in RULES] == [r.name for r in rr.RULES]


def test_cli_gates_clean_against_the_committed_baseline(tmp_path, capsys):
    out = tmp_path / "report.json"
    rc = cli.main(["--matrix", "fast", "--device", "cpu", "--json",
                   str(out), "--baseline", str(BASELINE)])
    assert rc == 0, capsys.readouterr().out[-3000:]
    report = json.loads(out.read_text())
    assert set(report) == {"_env", "_matrix", "lint", "exec", "configs"}
    assert report["lint"]["status"] == "pass"
    assert len(report["configs"]) == len(FAST_MATRIX)
    skips = {name: sorted(r for r, v in rules.items()
                          if v["status"] == "skip")
             for name, rules in report["configs"].items()}
    for name, skipped in skips.items():
        two = name.split("-")[4] == "2d"
        assert ("collective-budget" in skipped) != two, name
        assert ("no-full-width-sweeps" in skipped) == (
            two or "-tree-" in name), name
    # The gate: a changed kernel-call count and more bytes between
    # shards are regressions.
    base = json.loads(BASELINE.read_text())
    worse = copy.deepcopy(report)
    leg = worse["configs"]["dense-flat-sync-uniform-1d"]["fused-admm-pass"]
    leg["metrics"]["kernel_calls"]["admm_update"] = 2
    two = worse["configs"]["dense-flat-sync-uniform-2d"]["collective-budget"]
    two["metrics"]["total_bytes"] += 1
    found = cli.compare_to_baseline(base, worse)
    assert len(found) == 2, found
    assert cli.compare_to_baseline(base, report) == []

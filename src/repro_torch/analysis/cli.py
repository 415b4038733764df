"""The checker's CLI: record the matrix, evaluate the rules, gate on a
baseline.

``python -m repro_torch.analysis --matrix fast|full --device cpu|cuda
[--json report.json] [--baseline PATH] [--no-exec] [--no-lint]``; the
port of ``repro/analysis/cli.py``.  Without ``--device`` it runs on the
card and raises without one.

The report has the reference's keys (``_env``, ``_matrix``, ``lint``,
``exec``, ``configs``), so the two reports line up, and holds no
wall-clock number, so the baseline compare is exact: a rule that goes
from pass to fail, a changed kernel-call count or more bytes between
shards than the baseline's fails the gate.  The CPU baseline is
``baseline_fast_cpu.json`` beside this module; after a deliberate change
of the round's structure re-make it with ``--matrix fast --device cpu
--json src/repro_torch/analysis/baseline_fast_cpu.json``.
"""
from __future__ import annotations

import argparse
import json
import platform
import sys

import torch

from repro_torch.device import resolve_device

from . import astlint
from .artifacts import MATRICES, build_artifact
from .retrace import (
    run_serve_trace_check,
    run_single_trace_check,
    run_transfer_guard_check,
)
from .rules import evaluate


def _env_fingerprint(device: torch.device) -> str:
    env = (f"torch={torch.__version__};device={device.type};"
           f"machine={platform.machine()}")
    if device.type == "cuda":
        env += f";card={torch.cuda.get_device_name(device)}"
    return env


def run_matrix(matrix_name: str, *, device=None, execute: bool = True,
               lint: bool = True, log=print) -> dict:
    """Evaluate every rule over the configuration matrix → report."""
    device = resolve_device(device)
    report: dict = {
        "_env": _env_fingerprint(device),
        "_matrix": matrix_name,
        "lint": None,
        "exec": {},
        "configs": {},
    }
    if lint:
        findings = astlint.lint_repo()
        report["lint"] = {
            "status": "fail" if findings else "pass",
            "findings": [f.to_json() for f in findings],
        }
        log(f"astlint: {report['lint']['status']} "
            f"({len(findings)} findings)")
    for key in MATRICES[matrix_name]:
        results = evaluate(build_artifact(key, device=device))
        report["configs"][key.name] = {r.rule: r.to_json() for r in results}
        bad = [r for r in results if r.status == "fail"]
        log(f"{key.name}: {'FAIL' if bad else 'ok'} "
            f"({sum(r.status == 'pass' for r in results)} pass, "
            f"{sum(r.status == 'skip' for r in results)} skip)")
        for r in bad:
            for v in r.violations:
                log(f"  {r.rule}: {v}")
    if execute:
        for check in (run_single_trace_check, run_serve_trace_check,
                      run_transfer_guard_check):
            res = check(device=device)
            report["exec"][res.rule] = res.to_json()
            log(f"exec {res.rule}: {res.status}")
    return report


def report_failures(report: dict) -> list:
    """Flat list of every failing rule/lint/exec entry in a report."""
    failures = []
    lint = report.get("lint")
    if lint and lint["status"] == "fail":
        failures.append(f"astlint: {len(lint['findings'])} findings")
    for name, res in report.get("exec", {}).items():
        if res["status"] == "fail":
            failures.append(f"exec/{name}: {res['violations']}")
    for cfg, rules in report.get("configs", {}).items():
        for rule, res in rules.items():
            if res["status"] == "fail":
                failures.append(f"{cfg}/{rule}: {res['violations']}")
    return failures


def compare_to_baseline(base: dict, fresh: dict) -> list:
    """Regressions of ``fresh`` against a committed baseline report.

    Gates on structure, not timings: status regressions (pass →
    fail/missing), changed kernel-call counts, and growth of the bytes
    copied between shards.  New configurations and rules are allowed
    (they gate from the next baseline on).
    """
    regressions = []
    for cfg, base_rules in base.get("configs", {}).items():
        fresh_rules = fresh.get("configs", {}).get(cfg)
        if fresh_rules is None:
            regressions.append(f"{cfg}: configuration vanished from "
                               f"the matrix")
            continue
        for rule, bres in base_rules.items():
            fres = fresh_rules.get(rule)
            if fres is None:
                regressions.append(f"{cfg}/{rule}: rule vanished")
                continue
            if bres["status"] == "pass" and fres["status"] != "pass":
                regressions.append(
                    f"{cfg}/{rule}: pass → {fres['status']} "
                    f"{fres.get('violations')}")
                continue
            bm, fm = bres.get("metrics", {}), fres.get("metrics", {})
            if ("kernel_calls" in bm
                    and fm.get("kernel_calls") != bm["kernel_calls"]):
                regressions.append(
                    f"{cfg}/{rule}: kernel calls {bm['kernel_calls']} → "
                    f"{fm.get('kernel_calls')}")
            btot, ftot = bm.get("total_bytes"), fm.get("total_bytes")
            if btot is not None and ftot is not None and ftot > btot:
                regressions.append(f"{cfg}/{rule}: bytes between shards "
                                   f"{btot} → {ftot}")
    if regressions and base.get("_env") != fresh.get("_env"):
        regressions.append(f"env drift: baseline {base.get('_env')} vs "
                           f"{fresh.get('_env')}")
    return regressions


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="Static-invariant checks of the port's round")
    ap.add_argument("--matrix", choices=sorted(MATRICES), default="fast")
    ap.add_argument("--device", default=None,
                    help="cpu or cuda (default: the card; raises without)")
    ap.add_argument("--json", metavar="PATH",
                    help="write the machine-readable report here")
    ap.add_argument("--baseline", metavar="PATH",
                    help="baseline report to gate against")
    ap.add_argument("--no-exec", action="store_true",
                    help="skip the signature and transfer-guard runs")
    ap.add_argument("--no-lint", action="store_true",
                    help="skip the AST lint")
    args = ap.parse_args(argv)

    report = run_matrix(args.matrix, device=args.device,
                        execute=not args.no_exec, lint=not args.no_lint)
    if args.json:
        with open(args.json, "w") as fh:
            json.dump(report, fh, indent=2, sort_keys=True)
            fh.write("\n")
        print(f"wrote {args.json}")

    failures = report_failures(report)
    for f in failures:
        print(f"FAIL {f}")
    if args.baseline:
        with open(args.baseline) as fh:
            base = json.load(fh)
        regressions = compare_to_baseline(base, report)
        for r in regressions:
            print(f"REGRESSION {r}")
        failures.extend(regressions)
    print("tracecheck:", "FAIL" if failures else "ok",
          f"({len(report['configs'])} configurations)")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())

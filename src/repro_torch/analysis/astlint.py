"""Repo-specific AST lint: read-back footguns in the round's bodies.

Port of ``repro/analysis/astlint.py``, in torch form.  A generic linter
cannot know which functions run inside a round; ``TRACED_SCOPES``
records that — per module of ``src/repro_torch``, the functions whose
bodies run every round (``"*"`` = every function in the file).  Nested
functions and lambdas inherit the property from their enclosing scope.

Checks (each a silent sync or a host detour in a round that runs on the
card):

- ``TC101`` a ``np.*``/``numpy.*`` call — host work, or a tensor read
  back to make an array;
- ``TC102`` ``.item()``, ``.tolist()``, ``.cpu()`` or ``.numpy()`` — a
  read back to the host, which waits for the card;
- ``TC103`` ``float(...)``/``int(...)``/``bool(...)`` of a torch
  expression — the same read;
- ``TC104`` ``if``/``while`` whose test holds a torch expression — a
  Python branch on a value on the card.

A torch expression is a call rooted at ``torch`` or a call of a tensor
method that reduces to a value (``.any()``, ``.all()``, ``.sum()``, ...).
A line ending in ``# tracecheck: ok`` (with its reason) is exempt: the
opt-out for host work on static values (fp32 rounding of a constant).

The host backend's glue (``core/hoststate.py``: row copies in host
memory and the plan's read-back, by design) stays out of scope, as the
reference lists only the jitted programs of its host module.

This module imports only the standard library.
"""
from __future__ import annotations

import ast
import dataclasses
import pathlib
import re

PRAGMA_RE = re.compile(r"#\s*tracecheck:\s*ok\b")

#: Module (relative to ``src/repro_torch``) → the functions that run in
#: a round, or ``"*"`` for every function in the file.  Files not
#: listed are not linted: add the entry when a module gains round code.
TRACED_SCOPES: dict = {
    "core/engine.py": "*",
    "core/compress.py": "*",
    "core/trigger.py": "*",
    "core/controller.py": "*",
    "core/selection.py": "*",
    "core/fedback.py": (
        "_local_solve", "_masked_local_solve", "_epoch_indices",
        "_solvers", "trigger", "presolve", "dense_client_update",
        "ragged_dense_solve", "overrides_on", "select_events",
        "stale_commit", "round_body", "body", "round_fn", "eval_fn"),
    "core/compact.py": (
        "sum_in_xla_cpu_order", "adaptive_limit", "_stable_order",
        "compact_plan", "queue_update", "gather_rows", "gather_blocks",
        "scatter_rows", "plan_step", "block", "presolve", "slot_inputs",
        "solve", "commit"),
    # Only the device-side step of the host round: its legs move rows
    # in host memory and read the plan back, by design.
    "core/hoststate.py": ("trigger",),
    "kernels/admm_update.py": (
        "admm_update_ref", "admm_update", "admm_update_sharded_ref",
        "admm_update_sharded"),
    "kernels/trigger_norms.py": (
        "trigger_sq_norms_ref", "trigger_sq_norms",
        "trigger_sq_norms_sharded_ref", "trigger_sq_norms_sharded"),
    "kernels/trigger_pytree.py": (
        "pytree_operands", "trigger_sq_norms_pytree_ref",
        "trigger_sq_norms_pytree"),
    "kernels/fused_gss.py": ("fused_gss_ref", "fused_gss"),
    "utils/pytree.py": "*",
    "utils/flatstate.py": (
        "flatten", "unflatten", "flatten_stacked", "unflatten_stacked"),
}

_NUMPY_ROOTS = ("np", "numpy")
_TORCH_ROOTS = ("torch",)
_READS = ("item", "tolist", "cpu", "numpy")
#: Tensor methods whose result is a value a branch would read.
_VALUE_METHODS = ("any", "all", "sum", "max", "min", "amax", "amin",
                  "equal", "allclose", "count_nonzero", "item")


@dataclasses.dataclass(frozen=True)
class LintFinding:
    path: str
    line: int
    code: str
    message: str

    def to_json(self) -> dict:
        return dataclasses.asdict(self)


def _call_root(node: ast.AST) -> str | None:
    """Leftmost name of a call's function expression, if any."""
    f = node.func if isinstance(node, ast.Call) else node
    while isinstance(f, ast.Attribute):
        f = f.value
    while isinstance(f, ast.Call):
        f = f.func
        while isinstance(f, ast.Attribute):
            f = f.value
    if isinstance(f, ast.Name):
        return f.id
    return None


def _is_torch_expr(node: ast.AST) -> bool:
    """A call rooted at ``torch`` or of a value-reducing tensor method."""
    if not isinstance(node, ast.Call):
        return False
    if _call_root(node) in _TORCH_ROOTS:
        return True
    return (isinstance(node.func, ast.Attribute)
            and node.func.attr in _VALUE_METHODS)


def _contains_torch_expr(node: ast.AST) -> bool:
    return any(_is_torch_expr(sub) for sub in ast.walk(node))


class _Linter(ast.NodeVisitor):
    def __init__(self, relpath: str, source: str, traced):
        self.relpath = relpath
        self.lines = source.splitlines()
        self.traced = traced  # "*" or set of function names
        self.depth = 0  # > 0 ⇔ inside a traced scope
        self.findings: list = []

    def _is_traced_def(self, name: str) -> bool:
        return self.traced == "*" or name in self.traced

    def _exempt(self, node) -> bool:
        line = self.lines[node.lineno - 1] if node.lineno <= len(
            self.lines) else ""
        return bool(PRAGMA_RE.search(line))

    def _add(self, node, code: str, message: str):
        if not self._exempt(node):
            self.findings.append(LintFinding(
                path=self.relpath, line=node.lineno, code=code,
                message=message))

    # --- scope tracking -------------------------------------------
    def _visit_func(self, node, name: str):
        enter = self.depth > 0 or self._is_traced_def(name)
        self.depth += 1 if enter else 0
        self.generic_visit(node)
        self.depth -= 1 if enter else 0

    def visit_FunctionDef(self, node):
        self._visit_func(node, node.name)

    visit_AsyncFunctionDef = visit_FunctionDef

    def visit_Lambda(self, node):
        if self.depth:
            self._visit_func(node, "<lambda>")
        else:
            self.generic_visit(node)

    # --- checks ----------------------------------------------------
    def visit_Call(self, node):
        if self.depth > 0:
            if _call_root(node) in _NUMPY_ROOTS:
                self._add(node, "TC101",
                          "numpy call in a round body (host work or a "
                          "read-back)")
            if (isinstance(node.func, ast.Attribute)
                    and node.func.attr in _READS and not node.args):
                self._add(node, "TC102",
                          f".{node.func.attr}() in a round body reads a "
                          "tensor back to the host")
            if (isinstance(node.func, ast.Name)
                    and node.func.id in ("float", "int", "bool")
                    and node.args and _is_torch_expr(node.args[0])):
                self._add(node, "TC103",
                          f"{node.func.id}() of a torch expression reads "
                          "it back to the host")
        self.generic_visit(node)

    def _check_branch(self, node):
        if self.depth > 0 and _contains_torch_expr(node.test):
            self._add(node, "TC104",
                      "Python branch on a torch value (use torch.where)")
        self.generic_visit(node)

    visit_If = _check_branch
    visit_While = _check_branch


def lint_source(source: str, relpath: str, scopes=None) -> list:
    """Lint one module's source; ``relpath`` keys into the registry."""
    scopes = TRACED_SCOPES if scopes is None else scopes
    traced = scopes.get(relpath)
    if traced is None:
        return []
    if traced != "*":
        traced = set(traced)
    linter = _Linter(relpath, source, traced)
    linter.visit(ast.parse(source))
    return sorted(linter.findings, key=lambda f: (f.path, f.line))


def lint_repo(src_root=None, scopes=None) -> list:
    """All findings over the registered modules."""
    if src_root is None:
        src_root = pathlib.Path(__file__).resolve().parents[1]
    src_root = pathlib.Path(src_root)
    scopes = TRACED_SCOPES if scopes is None else scopes
    findings: list = []
    for relpath in sorted(scopes):
        path = src_root / relpath
        if not path.exists():
            findings.append(LintFinding(
                path=relpath, line=0, code="TC100",
                message="registered module missing on disk"))
            continue
        findings.extend(lint_source(path.read_text(), relpath,
                                    scopes=scopes))
    return findings

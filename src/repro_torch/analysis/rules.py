"""The rule engine of the port's checker: each invariant is data.

Port of ``repro/analysis/rules.py``: the same six rules under the same
names, :class:`RuleResult`, ``RULES`` and :func:`evaluate`, each read
from the op logs of an :class:`~.artifacts.EngineArtifact` (two steady
rounds; a rule holds in each, and reports round 2's facts).  A rule is a
frozen dataclass whose fields are its budget; ``check`` maps an
artifact to a :class:`RuleResult`.

- ``fused-admm-pass``       kernel wrapper calls per round, by name: K1
                            and the fused K3 on a flat compact round,
                            K1 and K2 on a flat dense round, K1c on the
                            tree layout, K1b with K3 per shard or K2b on
                            two shards; on the card the profiler's CUDA
                            kernels match the launches one for one;
- ``no-full-width-sweeps``  add/sub/mul ops (in-place forms included)
                            with an (N, D) output outside the kernel
                            wrappers and the local solve: dense 1 (the
                            z assembly), compact 0, host 0, +4 with the
                            compressed consensus's EF algebra;
- ``no-f64-ops``            no float64/complex128 op, except D6's FMA
                            emulation (span ``compress/fma``) on the
                            compressed legs, whose count is reported;
- ``donated-state-aliases`` torch has no donation: which state fields
                            the round wrote in place, and its (N/P, D)
                            allocations outside the wrappers and the
                            solve, against the commit form's budget;
- ``collective-budget``     bytes copied between shards against a byte
                            model, and no (N/P, D) block or pool data
                            crossing;
- ``host-transfer-budget``  no sync op in a device round; on the host
                            backend the plan's read-back only, no (N, D)
                            tensor in the plan and solve legs, and the
                            planned row stream within 8·C·D·4 B.

The port's policy differs from the reference's in four places, stated
here as data (ROADMAP D6, D7): the tree layout launches K1c where JAX
launches no kernel, the host legs launch K1 and K3 on the working set,
the compressed legs run float64 FMAs, and the dense round writes new
θ/λ/z where the reference donates them.
"""
from __future__ import annotations

import dataclasses
from collections import Counter

from repro_torch.core.compress import WIRE_BYTES, block_layout

#: Spans whose ops the sweep and allocation rules leave out: the kernel
#: wrappers (their plain versions on the CPU) and the local solve.
EXCLUDED = ("kernel/", "fedback/solve")
#: The CUDA kernel each wrapper launches (``csrc/fedback_kernels.cu``).
CUDA_KERNEL_OF = {
    "trigger_sq_norms": "trigger_sq_norms_kernel",
    "trigger_sq_norms_sharded": "trigger_table_kernel",
    "trigger_sq_norms_pytree": "trigger_table_kernel",
    "admm_update": "admm_update_kernel",
    "admm_update_sharded": "admm_update_kernel",
    "fused_gss": "fused_gss_kernel",
}


@dataclasses.dataclass
class RuleResult:
    rule: str
    status: str  # "pass" | "fail" | "skip"
    violations: list
    metrics: dict

    def to_json(self) -> dict:
        return dataclasses.asdict(self)


def _result(name: str, violations: list, metrics: dict) -> RuleResult:
    return RuleResult(rule=name, status="fail" if violations else "pass",
                      violations=violations, metrics=metrics)


def _skip(name: str, why: str) -> RuleResult:
    return RuleResult(rule=name, status="skip", violations=[],
                      metrics={"skipped": why})


def _host(art) -> bool:
    return art.key.backend == "host"


def _rounds(art):
    """(round number, log) of the recorded rounds (2, 3, ...)."""
    return [(i + 2, log) for i, log in enumerate(art.logs)]


@dataclasses.dataclass(frozen=True)
class FusedPassBudget:
    """Kernel wrapper calls per round, by wrapper (``calls``: the plain
    path and the kernel path alike; a wrapper that hands its work to
    another counts once, as the innermost).

    Policy, not read from the config — a mis-flagged config must turn
    this rule red, not adapt it: a flat ADMM round calls K1 and one state
    kernel, the fused K3 on the compacted path (and no K2) or K2 on the
    dense path; on two shards K1b once, with K3 once per shard or K2b
    once; the host backend K1 and K3 on its working set; the tree layout
    K1c (``trigger_sq_norms_pytree``) and no state kernel — K1 (K1b) where
    the tree is one (N, D) leaf, which K1c's front end reads as the flat
    matrix.  On the card
    the CUDA kernels in the profiler's trace must be the wrappers'
    launches, kernel for kernel.
    """

    name: str = "fused-admm-pass"

    def expected(self, art) -> dict:
        key, ws = art.key, art.world_size
        trigger = "trigger_sq_norms" if ws == 1 else \
            "trigger_sq_norms_sharded"
        if key.layout == "tree":
            # K1c's front end hands a tree of one (N, D) leaf — the toy
            # problem's one vector parameter — to K1 (K1b on shards).
            one_leaf = len(art.state_block_shapes()) == 1 and all(
                len(s) == 2 for s in art.state_block_shapes())
            return {trigger if one_leaf else "trigger_sq_norms_pytree": 1}
        if key.path == "compact":
            return {trigger: 1, "fused_gss": ws}
        return {trigger: 1,
                "admm_update" if ws == 1 else "admm_update_sharded": 1}

    def check(self, art) -> RuleResult:
        want = self.expected(art)
        violations = []
        for rnd, log in _rounds(art):
            if log.calls != want:
                violations.append(f"{art.key.name}: round {rnd} called "
                                  f"{log.calls}, policy expects {want}")
            if log.cuda_kernels is not None:
                launched = Counter()
                for k, v in log.launches.items():
                    launched[CUDA_KERNEL_OF.get(k, k)] += v
                seen = Counter({
                    k: sum(v for name, v in log.cuda_kernels.items()
                           if k in name)
                    for k in set(CUDA_KERNEL_OF.values())})
                seen = +seen
                if seen != launched:
                    violations.append(
                        f"{art.key.name}: round {rnd} CUDA kernels "
                        f"{dict(seen)} against launches {dict(launched)}")
        log = art.logs[0]
        metrics = {"kernel_calls": dict(sorted(log.calls.items())),
                   "calls": sum(log.calls.values()),
                   "expected": dict(sorted(want.items()))}
        if log.cuda_kernels is not None:
            metrics["launches"] = dict(sorted(log.launches.items()))
            metrics["cuda_kernels"] = dict(sorted(
                (k, v) for k, v in log.cuda_kernels.items()
                if any(c in k for c in CUDA_KERNEL_OF.values())))
        return _result(self.name, violations, metrics)


@dataclasses.dataclass(frozen=True)
class FullWidthSweepBudget:
    """add/sub/mul ops (in-place forms included) whose output is (N, D),
    outside the kernel wrappers and the local solve.

    The dense flat round keeps one (z = θ + λ⁺); the compacted round's
    algebra runs at C rows and keeps none; the host backend's round
    keeps none.  The EF-compressed consensus adds up to four (δ = z − ω
    + e, the residual and the wire-error fold-back: every client carries
    a residual row).  Flat layout, one device: on two shards the
    shard's block is (N/P, D) and the rule skips, as the reference's.
    """

    name: str = "no-full-width-sweeps"
    dense_budget: int = 1
    compact_budget: int = 0
    host_budget: int = 0
    ef_extra: int = 4
    ops: tuple = ("add", "sub", "mul", "rsub")

    def applies(self, art) -> bool:
        return art.kernels_on and art.world_size == 1

    def sweeps(self, art, log) -> list:
        nd = (art.n, art.dim)
        return [op for op in log.outside(EXCLUDED)
                if op.name.rstrip("_") in self.ops and nd in op.shapes]

    def budget(self, art) -> int:
        if _host(art):
            budget = self.host_budget
        else:
            budget = (self.compact_budget if art.cfg.compact
                      else self.dense_budget)
        if art.cfg.consensus_compress != "none":
            budget += self.ef_extra
        return budget

    def check(self, art) -> RuleResult:
        if not self.applies(art):
            return _skip(self.name, "flat single-device only")
        budget = self.budget(art)
        violations = []
        for rnd, log in _rounds(art):
            got = len(self.sweeps(art, log))
            if got > budget:
                violations.append(
                    f"{art.key.name}: round {rnd} ran {got} (N={art.n}, "
                    f"D={art.dim}) add/sub/mul ops, budget {budget}")
        return _result(self.name, violations, {
            "full_width_sweeps": len(self.sweeps(art, art.logs[0])),
            "budget": budget})


@dataclasses.dataclass(frozen=True)
class DtypeBan:
    """No float64/complex128 op in the round (its inputs or outputs).

    The one allowance, stated as data: D6's FMA emulation
    (``core/compress.py::_fma``, span ``compress/fma``) on the compressed
    legs, where the product of two fp32 values is exact in float64 and
    the sum rounds once, as XLA contracts it.  Its op count is reported
    (``d6_fma_f64_ops``); every other float64 op is a violation.
    """

    name: str = "no-f64-ops"
    banned: tuple = ("torch.float64", "torch.complex128")
    allowed_scope: str = "compress/fma"

    def check(self, art) -> RuleResult:
        compressed = art.cfg.consensus_compress != "none"
        violations = []
        for rnd, log in _rounds(art):
            bad = Counter()
            for op in log.ops:
                if not any(d in self.banned
                           for d in op.dtypes + op.in_dtypes):
                    continue
                if compressed and self.allowed_scope in op.scopes:
                    continue
                bad[op.name] += 1
            if bad:
                violations.append(f"{art.key.name}: round {rnd} ran "
                                  f"float64 ops {dict(bad)}")
        log = art.logs[0]
        return _result(self.name, violations, {
            "dtypes": sorted({d.removeprefix("torch.") for op in log.ops
                              for d in op.dtypes + op.in_dtypes}),
            "d6_fma_f64_ops": sum(
                1 for op in log.ops if self.allowed_scope in op.scopes
                and any(d in self.banned for d in op.dtypes + op.in_dtypes)),
        })


@dataclasses.dataclass(frozen=True)
class DonationAudit:
    """Torch has no donation; its twin: which client-stacked state
    fields (``core/state.py::CLIENT_STACKED_FIELDS``) the round wrote in
    place (its output shares the input's storage), and the round's
    allocations of a shard's θ block — (N/P, D) on the flat layout —
    outside the kernel wrappers and the local solve.

    The budget is the commit form's, per shard: the fused compact commit
    writes θ/λ/z_prev in place and allocates none; every other form
    writes new ones (ROADMAP D7), and its count is the port's, measured
    and pinned as the terms below.  That a compact flat leg must take
    the fused form is ``fused-admm-pass``'s policy.  Device backend only:
    the host backend keeps the matrices in host memory, as the
    reference's host legs skip.  On the card the metrics carry the
    round's ``peak_bytes`` (``max_memory_allocated`` over round 2 less
    its start).
    """

    name: str = "donated-state-aliases"
    fused_inplace: tuple = ("theta", "lam", "z_prev")
    commit_sync: int = 3  # gated θ/λ/z selects, or the unfused scatters
    commit_stale: int = 6  # the delay pipeline's extra selects
    z_assembly: int = 1  # z = θ + λ⁺ (dense ADMM)
    tree_presolve: int = 3  # λ⁺ = λ + θ − ω and c = ω − λ⁺ (plain)
    ragged_out: int = 1  # the bucket solves' θ output (dense ragged)
    ef: tuple = (("int8", 5), ("bf16", 8))  # δ, the residuals, copies

    def applies(self, art) -> bool:
        return not _host(art)

    def fused(self, art) -> bool:
        return art.cfg.compact and art.cfg.fused_gss

    def budget(self, art) -> int:
        cfg, stale = art.cfg, art.cfg.max_staleness is not None
        per = dict(self.ef).get(cfg.consensus_compress, 0)
        if not self.fused(art):
            per += self.commit_sync
            if stale:
                per += (self.commit_stale if not cfg.compact
                        else self.commit_sync + self.commit_stale)
        if not cfg.compact:
            per += self.z_assembly + (self.ragged_out if art.ragged
                                      else 0)
            per += self.tree_presolve if art.spec is None else 0
        return per * art.world_size

    @staticmethod
    def allocations(art, log) -> list:
        blocks = art.state_block_shapes()
        return [op for op in log.outside(EXCLUDED)
                if not op.inplace and not op.view
                and any(s in blocks for s in op.shapes)]

    def check(self, art) -> RuleResult:
        if not self.applies(art):
            return _skip(self.name, "host backend: the state lives in "
                         "host memory")
        budget = self.budget(art)
        violations = []
        for (rnd, log), aliases in zip(_rounds(art), art.aliases,
                                       strict=True):
            got = len(self.allocations(art, log))
            if got > budget:
                violations.append(
                    f"{art.key.name}: round {rnd} allocated {got} state "
                    f"blocks {sorted(art.state_block_shapes())}, budget "
                    f"{budget}")
            if self.fused(art):
                for f in self.fused_inplace:
                    if aliases.get(f) != "inplace":
                        violations.append(
                            f"{art.key.name}: round {rnd} wrote a new {f} "
                            f"({aliases.get(f)}); the fused commit "
                            "writes it in place")
        metrics = {"fields": art.aliases[0],
                   "state_allocations": len(self.allocations(art,
                                                             art.logs[0])),
                   "budget": budget}
        if art.logs[0].peak_bytes is not None:
            metrics["peak_bytes"] = art.logs[0].peak_bytes
        return _result(self.name, violations, metrics)


@dataclasses.dataclass(frozen=True)
class CollectiveBudget:
    """Bytes copied between shards in a round (logical: what each copy
    moves off a shard's device, ``sharding.clients.collectives``)
    against a byte model, at P shards, N clients, width D:

        consensus   the (D,) partials summed on shard 0 at the wire
                    dtype: (P−1)·D·4 fp32; int8: (P−1)·nb·B code bytes
                    + (P−1)·nb·4 block maxima gathered + 2·(P−1)·nb·4
                    shared scale sent back; bf16: (P−1)·D·2 gathered
        ω           (P−1)·D·4 copied to every shard (twice with
                    compression: ω_prev goes to each shard's level 1)
        RNG         (P−1)·2·8 for the replicated key, (P−1)/P·N·2·8 for
                    the per-client minibatch keys cut by shard
        vectors     (P−1)/P·N·14 for the (N,) metric gathers on shard 0
                    (events, committed: bool; distances, δ, L: fp32),
                    +(P−1)/P·N on the serve step (its arrival mask)
        scalars     ``scalar_allowance_bytes`` (round counter, counts,
                    loss sums)

    and a cap: no single copy larger than ``max(D·4, ⌈N/P⌉·2·8)`` B and
    none shaped (k, D) with k > 1 — no (N/P, D) block and no row of the
    pool data crosses shards.  At P = 2, N = 32, D = 16 the model gives
    880 B for the fp32 legs (64 + 64 + 272 + 224 + 256), 908 B for int8
    and 912 B for bf16, and the cap 256 B.
    """

    name: str = "collective-budget"
    scalar_allowance_bytes: int = 256

    def applies(self, art) -> bool:
        return art.world_size > 1

    def model(self, art) -> dict:
        p, n, d = art.world_size, art.n, art.dim
        mode = art.cfg.consensus_compress
        if mode == "int8":
            nb, b = block_layout(d, art.cfg.compress_block)
            consensus = (p - 1) * (nb * b * WIRE_BYTES["int8"] + 3 * nb * 4)
        else:
            consensus = (p - 1) * d * WIRE_BYTES[mode]
        vectors = (p - 1) * n // p * (14 + (art.key.timing == "serve"))
        return {"consensus": consensus,
                "omega": (p - 1) * d * 4 * (2 if mode != "none" else 1),
                "rng": (p - 1) * 2 * 8 + (p - 1) * n // p * 2 * 8,
                "vectors": vectors,
                "scalars": self.scalar_allowance_bytes}

    def cap(self, art) -> int:
        return max(art.dim * 4, -(-art.n // art.world_size) * 2 * 8)

    def check(self, art) -> RuleResult:
        if not self.applies(art):
            return _skip(self.name, "single device")
        model = self.model(art)
        budget = sum(model.values())
        cap = self.cap(art)
        violations = []
        for rnd, log in _rounds(art):
            total = sum(t.nbytes for t in log.transfers)
            if total > budget:
                violations.append(f"{art.key.name}: round {rnd} copied "
                                  f"{total} B between shards, budget "
                                  f"{budget}")
            for t in log.transfers:
                if t.nbytes > cap or (len(t.shape) == 2 and t.shape[0] > 1
                                      and t.shape[1] == art.dim):
                    violations.append(
                        f"{art.key.name}: round {rnd} sent a {t.dtype} "
                        f"{list(t.shape)} ({t.kind}, {t.nbytes} B) between "
                        f"shards: no state block or pool data may cross "
                        f"(cap {cap} B)")
        log = art.logs[0]
        metrics: dict = {}
        for t in log.transfers:
            m = metrics.setdefault(t.kind, {"count": 0, "bytes": 0})
            m["count"] += 1
            m["bytes"] += t.nbytes
        metrics.update(total_bytes=sum(t.nbytes for t in log.transfers),
                       budget_bytes=budget, model=model, cap_bytes=cap,
                       compress=art.cfg.consensus_compress)
        return _result(self.name, violations, metrics)


@dataclasses.dataclass(frozen=True)
class HostTransferBudget:
    """Reads back to the host (``OpLog.syncs``): none in a device round.

    On the host backend the round reads its plan back by design (span
    ``hoststate/readback``: the slot indices and valid flags, and the
    landing mask under staleness) — that count is pinned — and no other
    sync op runs; no op of the plan and solve legs makes an (N, D)
    tensor (the row stream moves (C, D) tiles, never the state); and the
    planned row stream (θ/λ up, θ'/λ⁺/z down, 5·C·D·4 B) fits
    8·C·D·4 B.
    """

    name: str = "host-transfer-budget"
    readback: str = "hoststate/readback"
    host_readbacks: int = 2  # plan.idx, plan.valid
    stale_readbacks: int = 1  # the landing mask
    streamed_legs: tuple = ("hoststate/plan", "hoststate/solve")
    row_budget_factor: int = 8  # × C·D·4 B per round

    def check(self, art) -> RuleResult:
        host = _host(art)
        want = 0
        if host:
            want = self.host_readbacks + (
                self.stale_readbacks if art.cfg.max_staleness is not None
                else 0)
        violations = []
        for rnd, log in _rounds(art):
            syncs = log.syncs()
            reads = [s for s in syncs if self.readback in s[1]]
            other = [s for s in syncs if self.readback not in s[1]]
            if other:
                violations.append(
                    f"{art.key.name}: round {rnd} synced with the host: "
                    + ", ".join(f"{what} in {'/'.join(sc) or 'round'}"
                                for what, sc in other))
            if len(reads) != want:
                violations.append(f"{art.key.name}: round {rnd} read the "
                                  f"plan back {len(reads)} times, pinned "
                                  f"{want}")
            if host:
                nd = (art.n, art.dim)
                leak = [op.name for op in log.ops
                        if op.within(self.streamed_legs) and nd in op.shapes]
                if leak:
                    violations.append(
                        f"{art.key.name}: round {rnd} made (N, D) tensors "
                        f"in the plan/solve legs: {leak}")
        log = art.logs[0]
        syncs = log.syncs()
        metrics: dict = {
            "syncs": sum(1 for s in syncs if self.readback not in s[1]),
            "plan_readbacks": sum(1 for s in syncs if self.readback in s[1]),
            "backend": art.key.backend}
        if log.cuda:
            metrics["cuda_syncs"] = len(log.cuda_syncs)
        if host:
            planned = art.round_fn.planned_bytes
            streamed = planned["row_stream_h2d"] + planned["row_stream_d2h"]
            budget = self.row_budget_factor * art.capacity * art.dim * 4
            metrics.update(
                planned_row_stream_bytes=streamed,
                row_stream_budget=budget,
                server_pass_bytes=(planned["server_pass_h2d"]
                                   + planned["server_pass_d2h"]))
            if streamed > budget:
                violations.append(
                    f"{art.key.name}: {streamed} planned row-stream "
                    f"bytes/round exceeds the {budget} B budget "
                    f"({self.row_budget_factor}·C·D·4)")
        return _result(self.name, violations, metrics)


#: The port's performance contract, in evaluation order.
RULES = (
    FusedPassBudget(),
    FullWidthSweepBudget(),
    DtypeBan(),
    DonationAudit(),
    CollectiveBudget(),
    HostTransferBudget(),
)


def evaluate(art, rules=RULES) -> list:
    """All rule results for one artifact (skips included)."""
    return [rule.check(art) for rule in rules]

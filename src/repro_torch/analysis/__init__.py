"""The static-invariant checker of the port (the twin of the reference's
``repro.analysis``, "tracecheck").

The port's efficiency story — two kernel passes per flat round and the
right two, no stray (N, D) sweep, no float64, the state written in place
where the round can, copies between shards priced by a byte model, no
read-back inside a round, one op signature across steady rounds — holds
only if the rounds keep it.  This package records one round of the port
per configuration and evaluates the reference's rules, under their
names, against budgets stated as data:

- ``oplog``      — the op log of a round (ATen ops with their spans, host
  reads, kernel calls, copies between shards; on the card the CUDA
  kernels, peak memory and the sync debug mode's warnings);
- ``artifacts``  — the configuration matrix and one recorded round per
  configuration;
- ``rules``      — the rule engine (kernel calls, (N, D) sweeps, float64,
  in-place state, collective bytes, host transfers);
- ``retrace``    — one op signature across steady rounds, and the
  transfer guard;
- ``astlint``    — an AST lint over the round bodies in ``core/``,
  ``kernels/`` and ``utils/``;
- ``cli``        — ``python -m repro_torch.analysis --matrix fast|full
  --device cpu|cuda`` with a committed baseline gate.

It runs on the CPU (the kernels' plain versions) and on the card (the
kernels).  This module imports nothing, so ``astlint`` runs without
torch.
"""

__all__ = ["artifacts", "astlint", "cli", "oplog", "retrace", "rules"]

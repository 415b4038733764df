"""Round artifacts: the op log of the port's round per configuration.

Port of ``repro/analysis/artifacts.py``.  An :class:`EngineArtifact`
bundles what the rule engine looks at — the op logs of two steady
rounds (:class:`~.oplog.OpLog`), which state fields the round wrote in
place, and the static problem facts (N, D, capacity, shard count).
:func:`build_artifact` is the single entry point; the matrices
(``FAST_MATRIX``/``FULL_MATRIX``) are the reference's, key for key and
name for name.

The toy problem is the reference's: small, but large enough that a
full-width (N, D) buffer is clearly bigger than every legitimate control
vector, so the budgets separate signal from noise.  "devices = 2" is a
2-shard client mesh on the one device the checker runs on
(``make_client_mesh(2, [device])``): two CPU shards, or two shards of one
card; copies between shards are counted logically, so the bytes are the
same on both.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Any, Callable

import torch

from repro_torch.core.compact import capacity_bounds
from repro_torch.core.fedback import FLConfig, init_state, make_round_fn
from repro_torch.core.state import CLIENT_STACKED_FIELDS
from repro_torch.data.synthetic import make_least_squares
from repro_torch.device import resolve_device
from repro_torch.sharding.clients import make_client_mesh
from repro_torch.utils.flatstate import make_flat_spec
from repro_torch.utils.pytree import tree_leaves
from repro_torch.utils.ragged import pool_data

from .oplog import OpLog

#: Default toy-problem dimensions (see module docstring).
DEFAULT_N = 32
DEFAULT_POINTS = 8
DEFAULT_DIM = 16


@dataclasses.dataclass(frozen=True, order=True)
class ConfigKey:
    """One point of the engine-configuration matrix."""

    path: str  # "dense" | "compact"
    layout: str  # "flat" | "tree"
    timing: str  # "sync" | "async" | "serve"
    shards: str  # "uniform" | "ragged"
    devices: int = 1
    compress: str = "none"  # consensus wire ("none" | "bf16" | "int8")
    backend: str = "device"  # client-state residency ("device" | "host")

    @property
    def name(self) -> str:
        base = (f"{self.path}-{self.layout}-{self.timing}-"
                f"{self.shards}-{self.devices}d")
        if self.compress != "none":
            base = f"{base}-{self.compress}"
        return base if self.backend == "device" else f"{base}-host"

    @property
    def kernels_on(self) -> bool:
        """Policy: every flat round runs the kernels — on the host
        backend too, whose working set the port's round hands to K1
        and K3 (the reference's host solve program runs none)."""
        return self.layout == "flat"


def _matrix(devices=(1, 2)) -> tuple:
    return tuple(
        ConfigKey(path, layout, timing, shards, dev)
        for path, layout, timing, shards, dev in itertools.product(
            ("dense", "compact"), ("flat", "tree"),
            ("sync", "async", "serve"), ("uniform", "ragged"), devices))


def _compress_matrix() -> tuple:
    """Compressed-consensus legs (flat layout only — the EF residual
    is an (N, D) matrix over the flat state)."""
    legs = []
    for mode in ("bf16", "int8"):
        for path in ("dense", "compact"):
            for dev in (1, 2):
                legs.append(
                    ConfigKey(path, "flat", "sync", "uniform", dev, mode))
    legs.append(ConfigKey("compact", "flat", "async", "ragged", 1, "int8"))
    legs.append(ConfigKey("compact", "flat", "async", "ragged", 2, "int8"))
    legs.append(ConfigKey("compact", "flat", "serve", "uniform", 1, "int8"))
    return tuple(legs)


def _host_matrix() -> tuple:
    """Host-offloaded client-state legs (compact flat, one device)."""
    return (
        ConfigKey("compact", "flat", "sync", "uniform", 1, "none", "host"),
        ConfigKey("compact", "flat", "async", "ragged", 1, "none", "host"),
        ConfigKey("compact", "flat", "sync", "uniform", 1, "int8", "host"),
        ConfigKey("compact", "flat", "async", "ragged", 1, "int8", "host"),
    )


#: All supported configurations: the 48-point uncompressed product, the
#: flat compressed-consensus legs and the host-offloaded state legs.
#: ``timing="serve"`` is the serve step (``arrivals_arg=True``) taking
#: the tick's (N,) bool arrival mask.
FULL_MATRIX = _matrix() + _compress_matrix() + _host_matrix()

#: The gate's subset, the reference's: the canonical dense round, the
#: compacted round, the kitchen sink (compact + async + ragged), the tree
#: layout, the serve step, the 2-shard legs, the int8 and bf16 legs and
#: the two host legs.
FAST_MATRIX = (
    ConfigKey("dense", "flat", "sync", "uniform", 1),
    ConfigKey("compact", "flat", "sync", "uniform", 1),
    ConfigKey("compact", "flat", "async", "ragged", 1),
    ConfigKey("dense", "tree", "sync", "uniform", 1),
    ConfigKey("compact", "flat", "serve", "uniform", 1),
    ConfigKey("dense", "flat", "sync", "uniform", 2),
    ConfigKey("compact", "flat", "async", "ragged", 2),
    ConfigKey("dense", "flat", "sync", "uniform", 1, "int8"),
    ConfigKey("dense", "flat", "sync", "uniform", 2, "int8"),
    ConfigKey("dense", "flat", "sync", "uniform", 2, "bf16"),
    ConfigKey("compact", "flat", "sync", "uniform", 1, "none", "host"),
    ConfigKey("compact", "flat", "async", "ragged", 1, "none", "host"),
)

MATRICES = {"fast": FAST_MATRIX, "full": FULL_MATRIX}


@dataclasses.dataclass
class EngineArtifact:
    """Everything the rule engine inspects for one configuration."""

    key: ConfigKey
    cfg: FLConfig
    n: int
    dim: int
    capacity: int | None  # solver-row budget per shard (compact path)
    world_size: int
    logs: list  # one OpLog per recorded round
    aliases: list  # per recorded round: field → "inplace"/"new"/"partial"
    state: Any  # the state after the recorded rounds
    round_fn: Callable
    spec: Any
    ragged: Any

    @property
    def kernels_on(self) -> bool:
        return self.key.kernels_on

    def state_block_shapes(self) -> set:
        """The shapes of one shard's client-stacked θ leaves: (N/P, D)
        on the flat layout, (N/P, *leaf) on the tree layout."""
        return {tuple(x.shape) for x in tree_leaves(_shards(self.state)[0]
                                                    .theta)}


def ragged_sizes(n: int, n_points: int) -> list:
    """Deterministic non-uniform client shard sizes (3-way cycle)."""
    return [max(n_points - 2 * (i % 3), 2) for i in range(n)]


def build_problem(key: ConfigKey, *, n: int = DEFAULT_N,
                  n_points: int = DEFAULT_POINTS, dim: int = DEFAULT_DIM,
                  device=None):
    """(data, params0, loss_fn, spec, ragged) for one configuration, on
    ``device`` (CUDA by default), from seed 0."""
    device = resolve_device(device)
    data, params0, loss_fn = make_least_squares(
        n, n_points=n_points, dim=dim, device=device)
    ragged = None
    if key.shards == "ragged":
        sizes = ragged_sizes(n, n_points)
        xs, ys = data["x"].cpu().numpy(), data["y"].cpu().numpy()
        data, ragged = pool_data([xs[i][:s] for i, s in enumerate(sizes)],
                                 [ys[i][:s] for i, s in enumerate(sizes)],
                                 device=device)
    spec = make_flat_spec(params0) if key.layout == "flat" else None
    return data, params0, loss_fn, spec, ragged


def build_config(key: ConfigKey, *, n: int = DEFAULT_N,
                 overrides: dict | None = None) -> FLConfig:
    """The FLConfig a configuration key stands for (the reference's).
    ``use_admm_kernel``/``use_trigger_kernel`` are set as there and not
    read by the port."""
    kw: dict = dict(
        n_clients=n,
        participation=0.25,
        rho=1.0,
        lr=0.1,
        momentum=0.0,
        epochs=1,
        batch_size=4,
        compact=key.path == "compact",
        max_staleness=2 if key.timing == "async" else None,
        use_admm_kernel=key.kernels_on,
        use_trigger_kernel=key.kernels_on,
        # Policy (mirrored by the fused-admm-pass rule): the compacted
        # flat round commits through the fused kernel K3.
        fused_gss=key.kernels_on and key.path == "compact",
        consensus_compress=key.compress,
        state_backend=key.backend,
    )
    kw.update(overrides or {})
    return FLConfig(**kw)


def _tensors(tree) -> list:
    """The tensors of a tree of dicts, tuples and NamedTuples."""
    return [x for x in torch.utils._pytree.tree_leaves(tree)
            if isinstance(x, torch.Tensor)]


def _shards(state) -> tuple:
    """A state as its shards: a client mesh's shard list, or one state."""
    return (state,) if hasattr(state, "theta") else tuple(state)


def _leaf_ptrs(state) -> dict:
    """Field → the data pointers of its leaves over every shard."""
    shards = _shards(state)
    out = {}
    for field in CLIENT_STACKED_FIELDS:
        vals = [getattr(s, field) for s in shards]
        if vals[0] is None:
            continue
        out[field] = [x.data_ptr() for v in vals for x in _tensors(v)]
    return out


def state_aliases(before: dict, state) -> dict:
    """Per client-stacked field: ``"inplace"`` if every leaf of the
    round's output shares its input's storage, ``"new"`` if none does,
    else ``"partial"``."""
    after = _leaf_ptrs(state)
    out = {}
    for field, ptrs in before.items():
        same = [a == b for a, b in zip(ptrs, after.get(field, []),
                                       strict=False)]
        out[field] = ("inplace" if same and all(same)
                      else "new" if not any(same) else "partial")
    return out


def build_artifact(key: ConfigKey, *, device=None, body_transform=None,
                   cfg_overrides: dict | None = None) -> EngineArtifact:
    """Build one configuration's toy round, run one warm-up round, then
    record rounds 2 and 3 under an :class:`~.oplog.OpLog` each
    (:func:`record_artifact`).

    ``device`` is where the round runs (CUDA by default: the kernels;
    ``"cpu"``: their plain versions).  ``body_transform`` is the
    mutation hook the self-tests use: it wraps the round, or on the host
    backend (through ``make_round_fn``) the round's solve leg.  A serve leg takes an
    all-ones arrival mask, as the reference traces its serve step.
    """
    device = resolve_device(device)
    data, params0, loss_fn, spec, ragged = build_problem(key, device=device)
    cfg = build_config(key, overrides=cfg_overrides)
    mesh = (make_client_mesh(key.devices, [device]) if key.devices > 1
            else None)
    placement = dict(mesh=mesh) if mesh is not None else dict(device=device)
    state = init_state(cfg, params0, spec=spec, **placement)
    serve = key.timing == "serve"
    host = cfg.state_backend == "host"
    round_fn = make_round_fn(cfg, loss_fn, data, spec=spec, ragged=ragged,
                             arrivals_arg=serve,
                             body_transform=body_transform if host else None,
                             **placement)
    if body_transform is not None and not host:
        round_fn = body_transform(round_fn)
    mask = torch.ones((cfg.n_clients,), dtype=torch.bool, device=device)
    return record_artifact(
        key, cfg, round_fn, state, device=device, spec=spec, ragged=ragged,
        params0=params0, round_args=(lambda i: (mask,)) if serve else None)


def record_artifact(key: ConfigKey, cfg: FLConfig, round_fn, state, *,
                    device, spec, params0, ragged=None, rounds: int = 2,
                    round_args: Callable | None = None) -> EngineArtifact:
    """Run one warm-up round of a built round, then record ``rounds``
    rounds under an :class:`~.oplog.OpLog` each, noting which state
    fields each wrote in place.  ``round_args(i)`` gives the round's
    arguments after the state in round i (0 = the warm-up; e.g. a serve
    tick's arrival mask).  ``key`` names the policy the rules hold the
    round to; ``cfg`` is what it ran.  Any round at any width: the
    checker's toy legs, or a paper-width form on the card."""
    device = torch.device(device)
    args = round_args or (lambda i: ())
    state, _ = round_fn(state, *args(0))
    host = key.backend == "host"
    logs, aliases = [], []
    for i in range(1, 1 + rounds):
        before = {} if host else _leaf_ptrs(state)
        with OpLog(device) as log:
            state, _metrics = round_fn(state, *args(i))
        logs.append(log)
        aliases.append(None if host else state_aliases(before, state))
    capacity = None
    if cfg.compact:
        _, capacity = capacity_bounds(
            cfg.n_clients, cfg.participation, cfg.capacity_slack,
            cfg.capacity, n_shards=key.devices)
    dim_total = spec.dim if spec is not None else sum(
        x.numel() for x in tree_leaves(params0))
    return EngineArtifact(
        key=key, cfg=cfg, n=cfg.n_clients, dim=dim_total, capacity=capacity,
        world_size=key.devices, logs=logs, aliases=aliases, state=state,
        round_fn=round_fn, spec=spec, ragged=ragged)

"""The round's shared ADMM algebra (port of ``repro/core/engine.py``).

    dual ascent   λ_i ← λ_i + θ_i − ω            (Eq. 2.3, dual)
    prox center   c_i = ω − λ_i
    gated commit  state_i ← proposed_i  iff  S_i^k
    consensus     ω = (1/N) Σ_i z_i^prev       (Eq. 2.4)
    participants  ω = mean of z_i over S_i^k   (FedAvg, FedProx)

over stacked trees (:mod:`repro_torch.utils.pytree`): client state has
a leading axis N on every leaf and ω is the unstacked tree.  The flat
layout is the one-leaf case — (N, D) client matrices and a (D,) ω.
Each leaf takes the reference's operations in its order, so the
algebra is bit-exact in fp32.

Under bounded staleness (``max_staleness``) the commit goes through the
delay pipeline below (:func:`staleness_masks`, :func:`staleness_commit`,
the issued-event ring of :func:`record_issue` and
:func:`measured_commits`), the reference's mask algebra.  The ragged
round's padded solves weight their loss by :func:`masked_batch_loss`.

The aggregations (:func:`consensus_mean`, :func:`participant_mean`,
:func:`participant_mean_loss`) also take the per-shard trees of a
client mesh (a list or tuple, one entry per shard): each shard reduces
its own rows and :func:`all_sum` adds the partials in shard order on
shard 0's device, the counterpart of the reference's all-reduce.  One
device's tree is the one-shard case, with the same arithmetic.
"""
from __future__ import annotations

import torch

from repro_torch.sharding.clients import collectives
from repro_torch.utils.pytree import rows_mask, tree_leaves, tree_map, \
    tree_where


def dual_ascent(lam, theta, omega):
    """λ_i^{k+1} = λ_i^k + θ_i^k − ω^k."""
    return tree_map(lambda l, t, w: l + t - w[None], lam, theta, omega)


def prox_center(omega, lam_new):
    """c_i = ω^k − λ_i^{k+1}."""
    return tree_map(lambda w, l: w[None] - l, omega, lam_new)


def gated_commit(events, proposed, current):
    """Row i takes ``proposed`` iff S_i^k, else keeps ``current``."""
    return tree_where(events, proposed, current)


def _shards(x) -> list:
    """Per-shard trees as a list; one device's tree as a list of one."""
    return list(x) if isinstance(x, (list, tuple)) else [x]


def all_sum(parts):
    """Σ of per-shard partials of one shape, added in shard order on
    shard 0's device (copies between devices go device to device)."""
    collectives.add("all-reduce", parts[1:])
    total = parts[0]
    for p in parts[1:]:
        total = total + p.to(total.device, non_blocking=True)
    return total


def consensus_mean(z_prev):
    """ω = (1/N) Σ_i z_i^prev — stale rows included (Eq. 2.4): per leaf,
    each shard's sum over its rows, added over shards, over N."""
    shards = _shards(z_prev)
    n = sum(tree_leaves(z)[0].shape[0] for z in shards)
    return tree_map(lambda *zs: all_sum([torch.sum(z, dim=0) for z in zs])
                    / n, *shards)


def participant_mean(per_client, events, fallback, num_events=None):
    """Mean of the rows whose event fired (FedAvg/FedProx aggregation):
    per leaf, the masked sum in fp32 over max(count, 1), cast to the
    leaf's dtype; ``fallback`` (unstacked) where no client fired.  The
    count stays on the device (no host branch)."""
    shards, masks = _shards(per_client), _shards(events)
    if num_events is None:
        num_events = all_sum([torch.sum(m.to(torch.int32)) for m in masks])

    def avg(w, *zs):
        acc = torch.promote_types(zs[0].dtype, torch.float32)
        total = all_sum([torch.sum(torch.where(
            rows_mask(m, z), z, torch.zeros((), dtype=z.dtype,
                                            device=z.device)).to(acc), dim=0)
            for z, m in zip(zs, masks, strict=True)])
        mean = total / torch.clamp(num_events, min=1).to(acc)
        return torch.where(num_events > 0, mean.to(zs[0].dtype), w)

    return tree_map(avg, fallback, *shards)


def masked_batch_loss(loss_fn, params, xb, yb, weights):
    """Weighted mean of per-example losses from a batch-mean ``loss_fn``.

    The ragged round pads a bucket's minibatches to its capacity, and
    padding must add neither loss nor gradient.  ``loss_fn(params, x,
    y)`` is a mean over its batch, so on singleton batches (``vmap``
    over the batch axis) it gives the per-example losses, reduced here
    as Σ per·w / max(Σ w, 1) under ``weights`` (0 = padding).  All-zero
    weights give 0 (and a zero gradient)."""
    per = torch.func.vmap(
        lambda xe, ye: loss_fn(params, xe[None], ye[None]))(xb, yb)
    return torch.sum(per * weights) / torch.clamp(torch.sum(weights),
                                                  min=1.0)


def participant_mean_loss(losses, events):
    """Mean local train loss among this round's participants."""
    ev = [m.to(torch.float32) for m in _shards(events)]
    total = all_sum([torch.sum(lo * e)
                     for lo, e in zip(_shards(losses), ev, strict=True)])
    return total / torch.clamp(all_sum([torch.sum(e) for e in ev]), min=1.0)


# --- the stale-tolerant commit pipeline (bounded-staleness rounds) -----
#
# Service (the solve runs) and commit (the row lands in θ/λ/z_prev) come
# apart: a solve serviced at round k lands at round k + δ_i.  All of it
# is mask algebra over the client axis, on the card, with no value read
# back; with δ ≡ 0, land and defer are never true and direct is the
# serviced set, so the round is the synchronous one bit for bit.


def staleness_masks(serviced, delay, ttl):
    """One step of the pipeline: (land, direct, defer, new_ttl) —
    payloads whose countdown ends this round (ttl = 1), serviced rows
    with δ_i = 0 (commit now) and with δ_i > 0 (park, ttl = δ_i), and
    the countdown after the round.  land and service are disjoint:
    a serviced client had ttl = 0."""
    land = ttl == 1
    direct = serviced & (delay == 0)
    defer = serviced & (delay > 0)
    new_ttl = torch.where(defer, delay, torch.clamp(ttl - 1, min=0))
    return land, direct, defer, new_ttl.to(torch.int32)


def staleness_commit(current, proposed, parked, land, direct, defer):
    """Route one proposed state field through the pipeline: (committed,
    new_parked) — landing rows take the parked payload, δ = 0 service
    the proposal, the rest keep ``current``; deferred service overwrites
    its parked slot."""
    committed = tree_where(land, parked, tree_where(direct, proposed,
                                                    current))
    return committed, tree_where(defer, proposed, parked)


def staleness_commit_slots(live, parked, old_rows, idx, valid, land,
                           defer):
    """:func:`staleness_commit` for the compacted round's fused commit,
    which has already written the C planned rows' proposals into the
    flat ``live`` (N, D) matrix in place (``kernels.fused_gss``):
    ``old_rows`` are those rows before it.  Per slot, a deferred row's
    proposal goes to its parked slot and its old row comes back; then
    the landing rows take their parked payload.  ``live`` and ``parked``
    are updated in place, with the bits of :func:`staleness_commit`."""
    rows = idx.long()
    keep = (valid & defer[rows])[:, None]
    new_rows = live[rows]
    parked[rows] = torch.where(keep, new_rows, parked[rows])
    live[rows] = torch.where(keep, old_rows, new_rows)
    # land and defer are disjoint, so the parked rows read here are the
    # payloads parked before this round.
    torch.where(rows_mask(land, live), parked, live, out=live)
    return live, parked


def record_issue(hist, issued, rnd):
    """Round ``rnd``'s issued events written into column rnd mod (S+1)
    of the (N, S+1) ring; ``rnd`` is the round's () tensor, read on the
    device."""
    col = (rnd.to(torch.int64) % hist.shape[1]).reshape(1)
    return hist.index_copy(1, col, issued[:, None])


def measured_commits(hist, delay, rnd):
    """The controller's commit-time measurement: client i's issue at
    round k is measured at round k + δ_i, from column (rnd − δ_i) mod
    (S+1) of the ring (rounds before δ_i read its all-False start)."""
    col = (rnd.to(torch.int64) - delay.to(torch.int64)) % hist.shape[1]
    return torch.gather(hist, 1, col[:, None])[:, 0]

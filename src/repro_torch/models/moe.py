"""Mixture-of-Experts layer with scatter-based top-k dispatch
(``repro/models/moe.py``).

Routing follows Mixtral/Qwen3: an fp32 softmax router, the top k
experts of each token, their gates renormalised over the k.  Dispatch
is the reference's scatter, not a one-hot einsum: each of a group's
R = S·k rows (token-major, then k) finds its position in its expert by
a cumulative count over the group (one batch row), and is written into
an (E, C + 1, d) buffer at (expert, position); rows past the capacity C
land in the spill slot C, which is sliced away, so they are dropped
(their combine weight is zero, as in Switch/GShard).  The three expert
products are plain batched products (``torch.einsum``), as the
reference computes them outside any Pallas kernel.  :func:`moe_apply`
is :func:`routing`, :func:`dispatch`, :func:`expert_hidden`,
:func:`expert_out` and :func:`combine` in turn; tensor-parallel serving
runs the last three on a model shard's experts or hidden and output
columns (``sharding/serve.py``).

Autograd sees the dispatch as an out-of-place ``index_put`` (its
backward a gather) and the combine as a gather (its backward a
scatter-add): only the kept rows have unique (expert, slot) indices,
and the dropped rows' gradients are exact zeros, so the backward sums
one nonzero term per element and repeats bit for bit on the card.

Top-k ties: ``jax.lax.top_k`` puts the lower expert first on a tie;
``torch.topk`` promises no order, so the k are read off a stable
descending sort, which keeps the lower index first.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch import prng

from .layers import dense_init, scaled_normal


def moe_init(key, d_model, d_ff, num_experts, dtype, device):
    """The router (d, E) in fp32 whatever ``dtype`` is, and the experts'
    ``w_gate``/``w_up`` (E, d, f) and ``w_down`` (E, f, d) in ``dtype``,
    along the reference's key tree."""
    kr, kg, ku, kd = prng.split(key, 4)
    se = (2.0 / (d_model + d_ff)) ** 0.5
    return {
        "router": dense_init(kr, d_model, num_experts, torch.float32,
                             device),
        "w_gate": scaled_normal(kg, (num_experts, d_model, d_ff), se, dtype,
                                device),
        "w_up": scaled_normal(ku, (num_experts, d_model, d_ff), se, dtype,
                              device),
        "w_down": scaled_normal(kd, (num_experts, d_ff, d_model), se, dtype,
                                device),
    }


def capacity(s: int, top_k: int, num_experts: int,
             capacity_factor: float) -> int:
    """Slots per expert and group: ⌈S·k/E⌉·cf, at most S·k, at least 1
    (the reference's integer arithmetic).  In decode S = 1, so C = 1 and
    one token's k distinct experts never drop."""
    cap = int(-(-s * top_k // num_experts) * capacity_factor)
    return max(min(cap, s * top_k), 1)


def route(router, x, top_k):
    """(probs (B, S, E) fp32, gates (B, S, k) renormalised, expert ids
    (B, S, k) int64, lower index first on a tie)."""
    probs = torch.softmax(x.to(torch.float32) @ router, dim=-1)
    top, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, eids = top[..., :top_k], idx[..., :top_k]
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    return probs, gates, eids


def dispatch_plan(eids, e: int, cap: int):
    """Per group (batch row): each row's expert (B, R), its slot — its
    position in the expert, or ``cap`` (the spill slot) where it is past
    the capacity — and the keep mask (B, R)."""
    b = eids.shape[0]
    eids_f = eids.reshape(b, -1)
    counts = torch.cumsum(F.one_hot(eids_f, e), dim=1)  # (B, R, E)
    pos = torch.take_along_dim(counts, eids_f[..., None], dim=-1)[..., 0] - 1
    keep = pos < cap
    slot = torch.where(keep, pos, cap)
    return eids_f, slot, keep


def routing(p, x, top_k, capacity_factor=1.25):
    """``moe_apply``'s routing of x (B, S, d), as a dict: ``probs`` (B,
    S, E) fp32, ``gates`` and ``eids`` (B, S, k), the rows' experts
    ``eids_f``, ``slot`` and ``keep`` (B, S·k), and the capacity
    ``cap``."""
    e = p["router"].shape[1]
    cap = capacity(x.shape[1], top_k, e, capacity_factor)
    probs, gates, eids = route(p["router"], x, top_k)
    eids_f, slot, keep = dispatch_plan(eids, e, cap)
    return dict(probs=probs, gates=gates, eids=eids, eids_f=eids_f,
                slot=slot, keep=keep, cap=cap)


def dispatch(x, r):
    """The rows of x (B, S, d) in their experts' buffers (B, E, C, d)
    under the routing ``r`` (:func:`routing`); rows past the capacity
    land in the spill slot, which is sliced away."""
    b, _, d = x.shape
    top_k = r["eids"].shape[-1]
    e = r["probs"].shape[-1]
    rows = torch.repeat_interleave(x, top_k, dim=1)  # (B, R, d)
    grp = torch.arange(b, device=x.device)[:, None]
    buf = x.new_zeros((b, e, r["cap"] + 1, d))
    return buf.index_put((grp, r["eids_f"], r["slot"]), rows)[:, :, :r["cap"]]


def expert_hidden(buffers, p):
    """silu(buffers · w_gate) ⊙ (buffers · w_up): (B, E, C, f) for the
    experts and hidden columns ``p`` holds."""
    hgate = F.silu(torch.einsum("becd,edf->becf", buffers, p["w_gate"]))
    hup = torch.einsum("becd,edf->becf", buffers, p["w_up"])
    return hgate * hup


def expert_out(hidden, w_down):
    """The experts' outputs (B, E, C, d) from their hidden rows."""
    return torch.einsum("becf,efd->becd", hidden, w_down)


def combine(hout, r):
    """Each token's output (B, S, d): its kept rows of ``hout`` (B, E, C,
    d) weighted by their gates and summed over its k experts (a dropped
    row adds 0).  Each output column reads only its own column of
    ``hout``, so a block of columns combines on its own."""
    b, _, cap, d = hout.shape
    eids_f, slot, keep = r["eids_f"], r["slot"], r["keep"]
    s, top_k = r["eids"].shape[1:]
    grp = torch.arange(b, device=hout.device)[:, None]
    rows_out = hout[grp, eids_f, torch.clamp(slot, max=cap - 1)]  # (B, R, d)
    rows_out = torch.where(keep[..., None], rows_out, 0.0)
    return (rows_out.reshape(b, s, top_k, d)
            * r["gates"].to(rows_out.dtype)[..., None]).sum(dim=2)


def load_stats(r):
    """The routing's load-balance statistics (2, E) fp32: row 0 the
    count of tokens whose top-1 expert is e (no gradient), row 1 each
    expert's router probability summed over the tokens.  A batch split
    over data shards adds the shards' statistics
    (``sharding/train.py``)."""
    e = r["probs"].shape[-1]
    top1 = r["eids"][..., 0].reshape(-1)
    counts = F.one_hot(top1, e).sum(0).to(torch.float32)
    return torch.stack([counts, r["probs"].reshape(-1, e).sum(0)])


def load_balance(stats, tokens, own=None):
    """Σ over the layers of E·Σ_e f_e·p̄_e from their statistics (…, 2,
    E) over ``tokens`` tokens (:func:`load_stats`, the data shards'
    added): the whole batch's aux.  With ``own``, a data shard's
    statistics: the same sum with p̄ from ``own``, whose gradient is the
    shard's share of the whole batch's (f has none)."""
    e = stats.shape[-1]
    f = stats[..., 0, :] / tokens
    pbar = (stats if own is None else own)[..., 1, :] / tokens
    return e * torch.sum(f.detach() * pbar)


def moe_apply(p, x, *, top_k, capacity_factor=1.25, return_aux=True):
    """x: (B, S, d) → (out (B, S, d), aux load-balance loss (fp32 0-d));
    with ``return_aux="stats"`` the routing's :func:`load_stats` in
    place of aux."""
    e = p["router"].shape[1]
    r = routing(p, x, top_k, capacity_factor)
    # per-group dispatch, the experts (active FLOPs only), the combine
    buffers = dispatch(x, r)
    out = combine(expert_out(expert_hidden(buffers, p), p["w_down"]), r)
    if return_aux == "stats":
        return out, load_stats(r)
    if not return_aux:
        return out, torch.zeros((), dtype=torch.float32, device=x.device)
    # Switch-style load balance: E·Σ_e f_e·p̄_e (top-1 dispatch fraction)
    top1 = r["eids"][..., 0].reshape(-1)
    f = torch.mean(F.one_hot(top1, e).to(torch.float32), dim=0)
    pbar = torch.mean(r["probs"].reshape(-1, e), dim=0)
    return out, e * torch.sum(f * pbar)


def moe_ref(p, x, *, top_k):
    """Dense oracle: every expert for every token (tests only)."""
    _, gates, eids = route(p["router"], x, top_k)
    hg = F.silu(torch.einsum("bsd,edf->besf", x, p["w_gate"]))
    hu = torch.einsum("bsd,edf->besf", x, p["w_up"])
    ho = torch.einsum("besf,efd->besd", hg * hu, p["w_down"])  # (B,E,S,d)
    sel = F.one_hot(eids, ho.shape[1]).to(torch.float32)  # (B,S,k,E)
    w = (sel * gates[..., None]).sum(2)  # (B,S,E)
    return torch.einsum("bse,besd->bsd", w.to(ho.dtype), ho)

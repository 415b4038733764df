"""Training on the model mesh in the reference's four modes: the
gradient of a sharded block, the training step's body, and the
cross-pod round on a ``("pod", "data", "model")`` mesh — what the
reference gets from ``jax.jit`` of its ``make_train_step`` and
``make_cross_pod_round`` with ``param_specs(mode=...)`` shardings
(``launch/steps.py``, ``launch/train.py``).

The parameters are a ``sharding.params.ShardedTree`` over a ``("data",
"model")`` mesh (a pod's sub-mesh across pods).  A data shard is the
batch block of one ``data`` position and the coordinates that hold it,
as in the serving steps (``sharding/serve.py``).

* **fsdp.**  The data shard runs the unsharded loss on its first
  coordinate (data d, model 0) and reads the parameters ZeRO-3 style
  through a :class:`GradView`: each leaf is put together from its
  blocks when the model reads it (:class:`_Gather`, reported as
  ``"all-gather"``), each layer inside its group of
  ``models.transformer._run_groups``, so that under ``cfg.remat``
  backward gathers the group again and no gathered layer is kept from
  forward to backward.  Backward cuts the gathered leaf's gradient into
  every coordinate's share and copies it there (``"reduce-scatter"``;
  a leaf replicated over an axis sends each replica its share), and
  each block adds its shares of the data shards' gradients in
  data-shard order (``.grad`` accumulation).
* **tp, fsdp_tp and ep: serving's executor with autograd.**  Each model
  shard j of a data shard reads its blocks through a :class:`GradView`
  that keeps the model axis (a leaf cut over data — fsdp_tp, and ep's
  experts where E is not cut over model — gathered over it, its
  gradient reduce-scattered back); :class:`_TpTrain` runs
  ``serve._TpGroup``'s per-family blocks (attention heads, Megatron
  MLP, the MoE's hidden or expert cut, mamba heads; ``TpLayout`` reads
  the cuts, refusing by name any it cannot train) with the attention
  through ``blockwise_attention``, the SSD scan through
  ``ssd_scan_ref`` and every remat group recomputed in backward.  The
  collectives are autograd functions (``sharding.params.all_reduce``,
  ``all_gather``): a forward all-reduce's backward adds the replicas'
  gradients and sends the sum to each partial (``"all-reduce"``), a
  forward all-gather's slices each shard's block of the summed
  gradients (``"reduce-scatter"``).  The loss is vocabulary-parallel:
  per chunk of ``chunked_lm_sums`` each shard's max, Σ exp and label
  logit over its columns of the head are gathered on the first shard
  (the (B, S, V) logits never are).  Each shard's replica of h carries
  only the part of dh that flows through its own columns, so after
  backward a leaf's gradient is added, in coordinate order, over the
  coordinates that hold the same block — the axes its spec does not
  cut (the norms over data and model, every leaf under tp over data) —
  and the sum is each replica's (``"all-reduce"``).
* **The loss is the whole batch's.**  Each data shard's term is its
  Σ −log p over the count of labelled positions of the whole batch
  (the counts are added first, in data-shard order), so the shards'
  gradients add up to the whole batch's and the loss is Σ over the
  shards of their sums over that count (``models.transformer
  .loss_terms``).  The MoE load-balance loss E·Σ_e f_e·p̄_e of a layer
  is a product of two means over the whole batch's routing: every data
  shard's forward runs first, keeping its graph, and gives its top-1
  counts and probability sums per layer (``moe.load_stats``); these are
  added over the data shards (``"all-reduce"`` of (L, 2, E) fp32), and
  shard d's backward term is nll_d / n + aux_coef · Σ_ℓ E · F_ℓ ·
  s_dℓ / T (F the whole batch's top-1 shares, no gradient; T = B·S), so
  the shards' terms add up to the whole batch's loss and gradient.  The
  tp executor always takes this path; fsdp on one data shard keeps
  ``moe_apply``'s aux, and every family there is the unsharded loss bit
  for bit.

Bytes each collective kind moves in a tp, fsdp_tp or ep step
(:func:`step_bytes`; grad_accum 1), per data shard of B rows over M
model shards, S positions (a vlm's prefix and text), S_t the text or
labelled positions, d the width, e the bytes of an activation element,
with one pass of the stack

* all-gather A: a mamba layer's in_proj output M(M − 1) · B·S·(2·d_in +
  2N + H)/M · e; an attention block's k and v where they come from
  column blocks 2·M(M − 1) · B·S·Kv·hd/M · e; the MoE's hidden cut
  M(M − 1) · B·E·C·f/M · e and its combined columns M(M − 1) ·
  B·S·d/M · e, its expert cut M(M − 1) · B·(E/M)·C·d · e (C the
  capacity);
* all-reduce R: (M − 1) · B·S·d · (4 + e) for each row-parallel product
  (the attention's wo, the MLP's w_down, a mamba layer's out_proj; the
  GQA fallback's wk and wv at Kv·hd in place of d), fp32 partials in
  and one rounded copy out, and 2(M − 1) · B·S · 4 for a mamba layer's
  sums of squares;

the step moves

* forward: A + R, the embedding's all-gather M(M − 1) · B·S_t·d/M · e
  and the head's (M − 1) · 3·B·S_t · 4 (max, Σ exp, label logit);
* backward: R again (each all-reduce's adjoint), and a reduce-scatter
  of A plus the embedding's and the head's bytes;
* remat: each group's forward again, but for what follows its last
  saved tensor (``torch.utils.checkpoint`` stops its recompute there):
  a group's last row-parallel all-reduce (MLP, out_proj) or the MoE
  hidden cut's column gather; and the head's gather again per chunk
  where ``cfg.loss_chunk`` cuts the sequence;
* gradient sync: 2(r − 1) · |leaf| bytes of all-reduce for each leaf
  held by r coordinates alike;
* fsdp_tp and ep: a leaf cut over data moves (n − 1)/parts of itself to
  each coordinate at each read (a stacked layer's again under remat)
  as an all-gather, and as much once as a reduce-scatter; with n > 1
  data shards the label counts and losses (12 (n − 1) bytes) and the
  MoE's statistics 2(n − 1) · L·2·E · 4 as all-reduce.

granite-3-2b whole in bf16 on tp (1, 4), B = 2, S = 2048 (remat, loss
chunks of 1024): R = 80 · 3 · B·S·d · 6 = 12.080 GB, moved forward,
backward and, less the 40 trailing MLP sums, again in the recompute:
all-reduce 30.201 GB (2.0 MB of it the norms' gradients), all-gather
0.0506 GB, reduce-scatter 0.0505 GB (``chip_smoke.py`` phase 14b holds
the formula on the card).

The cross-pod round keeps ``core/crosspod.py``'s algorithm and its
steps (``pod_mean``, ``sq_distances``, ``trigger``, ``dual_and_center``,
``solve``, ``commit``, ``round_metrics``); the state is a ShardedTree
of a ``CrossPodState`` (θ, λ, z_prev cut by ``pod_stacked_specs``, the
controller, key and round replicated on every coordinate):

* ω at each (data, model) position is :func:`pod_mean` of the pods'
  blocks there, on pod 0's coordinate, then one copy on each pod's
  (``"all-reduce"``; on a shared card the same tensor);
* each pod's ‖z − ω‖² is the sum over its coordinates (in order) of
  the sum over the leaves each *owns* — a leaf replicated over an axis
  is counted on the coordinates at position 0 of that axis only (the
  norms on one, the embedding and the head on data 0);
* the controller steps once, on the first coordinate, and its state,
  the key and the round are copied to the others (``"broadcast"``);
* pods are solved one at a time, a pod that did not fire is not solved,
  and a fired pod's blocks are committed in place.
"""
from __future__ import annotations

import functools
import math

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import prng
from repro_torch.core.controller import ControllerState, init_controller
from repro_torch.core.crosspod import CrossPodConfig, CrossPodState, \
    commit, dual_and_center, pod_mean, round_metrics, solve, \
    sq_distances, trigger
from repro_torch.core.engine import all_sum
from repro_torch.kernels.ssd_scan import ssd_scan_ref
from repro_torch.launch.mesh import DeviceMesh
from repro_torch.models import moe
from repro_torch.models.api import abstract_params
from repro_torch.models.layers import chunked_lm_sums, rmsnorm
from repro_torch.models.moe import load_balance
from repro_torch.models.transformer import IGNORE_LABEL, _attention, \
    _groups, _intra_dtype, _remat_groups, _run_groups, loss_terms
from repro_torch.optim.adam import AdamState, adam_step
from repro_torch.sharding.clients import ClientMesh, shard_targets
from repro_torch.utils.pytree import tree_broadcast_like, tree_leaves, \
    tree_map
from repro_torch.utils.spans import span

from .params import ShardedTree, _axes, all_gather, all_reduce, \
    block_slices, gather_leaf, gather_tree, report_copies
from .serve import EVERY_DATA_SHARD, TpLayout, _spec_paths, _TpGroup, \
    data_shards, stand_in
from .specs import param_specs, pod_stacked_specs

TRAIN_MODES = ("fsdp", "tp", "fsdp_tp", "ep")
POD_AXES = ("pod", "data", "model")


def check_train_mode(mode: str) -> None:
    if mode not in TRAIN_MODES:
        raise ValueError(f"unknown training mode {mode!r}; the modes are "
                         f"{', '.join(TRAIN_MODES)}")


def _build(template, leaves):
    it = iter(leaves)
    return tree_map(lambda _: next(it), template)


# ----------------------------------------------------------------------
# the gradient of a sharded block
# ----------------------------------------------------------------------


def _sources(spec, mesh, at, keep):
    """The coordinates ``gather_leaf`` takes a leaf's blocks from: every
    coordinate where ``keep`` is empty (fsdp: each replica takes its
    share of the gradient), else those equal to ``at`` on every axis
    but the ones that cut the leaf."""
    if not keep:
        return mesh.coords()
    names = list(mesh.axis_names)
    cut = {a for e in spec for a in _axes(e)} - set(keep)
    return [c for c in mesh.coords()
            if all(c[i] == at[i] for i, a in enumerate(names)
                   if a not in cut)]


class _Gather(torch.autograd.Function):
    """Forward: a leaf put together on ``at``'s device from its blocks
    (one per coordinate, row-major; ``gather_leaf``, whole but along
    ``keep``).  Backward: each source coordinate's share of the
    gradient, copied to its device (``"reduce-scatter"``)."""

    @staticmethod
    def forward(ctx, spec, mesh, at, keep, *blocks):
        ctx.spec, ctx.mesh, ctx.at, ctx.keep = spec, mesh, at, keep
        whole = gather_leaf(list(blocks), spec, mesh, at, keep=keep)
        # a leaf whole on every coordinate comes back as at's own block
        return whole.clone() if any(whole is b for b in blocks) else whole

    @staticmethod
    def backward(ctx, grad):
        mesh, at = ctx.mesh, ctx.at
        parts, moved = [None] * mesh.size, []
        for c in _sources(ctx.spec, mesh, at, ctx.keep):
            part = grad[block_slices(grad.shape, ctx.spec, mesh, c,
                                     keep=ctx.keep)].to(mesh.device(c),
                                                        copy=True)
            parts[mesh.index(c)] = part
            if c != at:
                moved.append(part)
        report_copies("reduce-scatter", moved)
        return (None, None, None, None, *parts)


class GradView:
    """A sharded parameter tree read by one coordinate ``at`` through
    autograd: ``view[key]`` gathers that leaf or subtree when it is
    read, and :meth:`layers` gives one callable per layer that gathers
    the layer's rows (the layer axis is never cut).  With ``keep`` (the
    tp executor's model axis) a leaf stays ``at``'s block along those
    axes: one cut over no other axis is ``at``'s own block, its
    gradient ``at``'s alone (:func:`value_and_grad` adds the
    replicas')."""

    def __init__(self, sharded: ShardedTree, at, keep=()):
        self.sharded, self.at, self.keep = sharded, tuple(at), tuple(keep)
        self._own = sharded.mesh.index(self.at)

    def _own_block(self, spec) -> bool:
        """Whether the leaf cut by ``spec`` is ``at``'s own block."""
        return bool(self.keep) and not (
            {a for e in spec for a in _axes(e)} - set(self.keep))

    def _gather(self, blocks, spec):
        if self._own_block(spec):
            return blocks[self._own]
        return _Gather.apply(tuple(spec), self.sharded.mesh, self.at,
                             self.keep, *blocks)

    def __contains__(self, key) -> bool:
        return key in self.sharded.blocks[0]

    def __getitem__(self, key):
        sh = self.sharded
        leaves = [tree_leaves(b[key]) for b in sh.blocks]
        return _build(sh.blocks[0][key], [
            self._gather([ls[k] for ls in leaves], s)
            for k, s in enumerate(tree_leaves(sh.specs[key]))])

    def layers(self, n: int) -> list:
        sh = self.sharded
        specs = tree_leaves(sh.specs["layers"])
        for s in specs:
            if s and s[0] is not None:
                raise ValueError(f"the layer axis is cut ({s}); it never "
                                 "is under the sharding rules")
        # one unbind per block leaf read: its backward stacks the
        # layers' gradients once, as the unsharded path's does
        leaves = [tree_leaves(b["layers"]) for b in sh.blocks]
        rows: dict = {}

        def row(c, k):
            if (c, k) not in rows:
                rows[c, k] = leaves[c][k].unbind(0)
            return rows[c, k]

        def read(i, k, spec):
            if self._own_block(spec):
                return row(self._own, k)[i]
            return self._gather([row(c, k)[i] for c in range(len(leaves))],
                                spec)

        def layer(i):
            return _build(sh.blocks[0]["layers"], [
                read(i, k, tuple(s)[1:]) for k, s in enumerate(specs)])

        return [functools.partial(layer, i) for i in range(n)]


# ----------------------------------------------------------------------
# the tp executor in training (tp, fsdp_tp, ep)
# ----------------------------------------------------------------------


class _TpTrain(_TpGroup):
    """One data shard's model shards in training: serving's executor
    (:class:`~repro_torch.sharding.serve._TpGroup`, its per-family
    blocks) over :class:`GradView`\\ s that keep the model axis, with
    the attention through ``blockwise_attention``, the SSD scan through
    ``ssd_scan_ref``, each remat group recomputed in backward, and the
    loss vocabulary-parallel (the module note)."""

    def __init__(self, cfg, lay, params, group, model_axis="model"):
        super().__init__(cfg, lay, params, group, model_axis, views=[
            GradView(params, c, keep=(model_axis,)) for c in group])

    def _layer(self, i):
        """Layer i's trees on every shard, read when called (inside its
        remat group)."""
        return lambda: [layers[i]() for layers in self.layers]

    def loss_terms(self, parts):
        """``models.transformer.loss_terms`` of the data shard's batch
        (``parts[j]`` on shard j) → (Σ −log p, the count of labelled
        positions, the MoE blocks' load statistics (L, 2, E); 0 without
        MoE), on the first shard's device."""
        cfg, lay, devs = self.cfg, self.lay, self.devs
        m = len(devs)
        if cfg.family == "audio":
            hs = [bp["features"].to(cfg.param_dtype) @ p["frontend_proj"]
                  for bp, p in zip(parts, self.ps, strict=True)]
        else:
            hs = self.embed([bp["tokens"] for bp in parts])
        mask = dict(mask_mode="bidir" if cfg.family == "audio"
                    else "causal")
        if cfg.family == "vlm":
            hs = [torch.cat([bp["patches"].to(cfg.param_dtype)
                             @ p["patch_proj"], h], dim=1)
                  for bp, p, h in zip(parts, self.ps, hs, strict=True)]
            mask = dict(mask_mode="prefix", prefix_len=cfg.prefix_tokens)
        positions = [torch.arange(hs[0].shape[1], device=d) for d in devs]

        def attend(j, lp, x, kv, q):
            y, _ = _attention(cfg, lp, x, positions[j],
                              window=cfg.sliding_window,
                              num_heads=lay.heads, num_kv_heads=lay.kv_heads,
                              kv=kv, project=False, blockwise=True, q=q,
                              **mask)
            return y

        def mamba(lps, hs):
            return self.mamba(lps, hs, intra_dtype=_intra_dtype(cfg),
                              scan=ssd_scan_ref)[0]

        def body(state, *group):
            hs, stats = list(state[:m]), state[m]
            for lps in group:
                if isinstance(lps, tuple):  # the hybrid's group
                    for lp in lps[0]:
                        hs = mamba(lp, hs)
                    lps = lps[1]
                elif cfg.family == "ssm":
                    hs = mamba(lps, hs)
                    continue
                hs, plan = self.block(lps, hs, attend)
                if plan is not None:
                    stats = torch.cat([stats, moe.load_stats(plan)[None]])
            return (*hs, stats)

        stats = torch.zeros((0, 2, cfg.num_experts) if lay.moe else (0,),
                            dtype=torch.float32, device=devs[0])
        layer = [self._layer(i) for i in range(cfg.num_layers)]
        if cfg.family == "hybrid":
            shared = [p["shared"] for p in self.ps]

            def hybrid(idx):
                return lambda: ([layer[i]() for i in idx], shared)

            groups = [[hybrid(g)] for g in _groups(cfg)]
        else:
            groups = _remat_groups(cfg, layer)
        state = _run_groups(cfg, (*hs, stats), groups, body)
        hs = [rmsnorm(h, p["final_ln"], cfg.norm_eps)
              for h, p in zip(state[:m], self.ps, strict=True)]
        if cfg.family == "vlm":
            hs = [h[:, cfg.prefix_tokens:] for h in hs]
        nll, n = self.lm_sums(hs, [bp["labels"] for bp in parts])
        aux = state[m] if lay.moe else torch.zeros(
            (), dtype=torch.float32, device=devs[0])
        return nll, n, aux

    def lm_sums(self, hs, labels):
        """``chunked_lm_sums`` with the head cut on the vocabulary: per
        chunk each shard's max, Σ exp and label logit over its columns,
        gathered on the first shard and combined in shard order; each
        chunk recomputed in backward where the sequence is chunked."""
        cfg = self.cfg
        heads = [p["lm_head"] for p in self.ps]
        if not self.lay.head_cut:
            return chunked_lm_sums(hs[0], heads[0], labels[0],
                                   cfg.loss_chunk, ignore_index=IGNORE_LABEL,
                                   valid_vocab=cfg.vocab_size)

        def sums(ys, *hcs):
            return _vocab_parallel_sums(hcs, heads, ys, self.devs,
                                        cfg.vocab_size)

        s, chunk = hs[0].shape[1], cfg.loss_chunk
        if not chunk or s <= chunk:
            return sums(labels, *hs)
        nll = torch.zeros((), dtype=torch.float32, device=self.devs[0])
        n = torch.zeros((), dtype=torch.int64, device=self.devs[0])
        for i in range(0, s, chunk):
            li, ti = checkpoint(sums, [y[:, i:i + chunk] for y in labels],
                                *(h[:, i:i + chunk] for h in hs),
                                use_reentrant=False)
            nll, n = nll + li, n + ti
        return nll, n


def _vocab_parallel_sums(hs, heads, labels, devs, vocab_size):
    """(Σ −log p(label) over the labelled positions, their count) of one
    chunk from each shard's normed h and vocabulary block of the head:
    shard j's max m_j, Σ exp(logit − m_j) and label logit over its
    columns (padded columns past ``vocab_size`` at −1e30), gathered on
    the first shard's device (``"all-gather"``); there log Σ exp =
    M + log Σ_j e^(m_j − M) Σ_j, M = max_j m_j, added in shard order.
    The maxima carry no gradient, so each shard's logits get the
    softmax less the label's one-hot."""
    cols = heads[0].shape[-1]
    parts = []
    for j, (h, w, y) in enumerate(zip(hs, heads, labels, strict=True)):
        logits = (h @ w).to(torch.float32)
        if (j + 1) * cols > vocab_size:
            col = j * cols + torch.arange(cols, device=logits.device)
            logits = torch.where(col < vocab_size, logits, -1e30)
        top = logits.amax(-1).detach()
        sumexp = torch.exp(logits - top[..., None]).sum(-1)
        local = y - j * cols
        inside = (local >= 0) & (local < cols)
        picked = torch.take_along_dim(
            logits, torch.clamp(local, 0, cols - 1)[..., None], dim=-1)[..., 0]
        parts.append(torch.stack([top, sumexp,
                                  torch.where(inside, picked, 0.0)])[None])
    (got,) = all_gather(parts, 0, devs[:1], homes=devs)
    top = got[:, 0].amax(0)
    total, label = got[0, 1] * torch.exp(got[0, 0] - top), got[0, 2]
    for j in range(1, got.shape[0]):
        total = total + got[j, 1] * torch.exp(got[j, 0] - top)
        label = label + got[j, 2]
    ll = label - top - torch.log(total)
    valid = labels[0] != IGNORE_LABEL
    return -torch.sum(torch.where(valid, ll, 0.0)), torch.sum(valid)


def _sync_replicas(params: ShardedTree, grads) -> None:
    """Under tp, fsdp_tp and ep each coordinate's block of a leaf holds
    the gradient of the reads made from that coordinate alone: a leaf's
    gradient is the sum over the coordinates that hold the same block
    (the axes its spec does not cut), added in coordinate order, the sum
    on each (``"all-reduce"``).  ``grads[i][k]`` is coordinate i's of
    leaf k, replaced in place."""
    mesh = params.mesh
    names = list(mesh.axis_names)
    for k, spec in enumerate(tree_leaves(params.specs)):
        cut = {a for e in spec for a in _axes(e)}
        replicas: dict = {}
        for i, c in enumerate(mesh.coords()):
            key = tuple(x for x, a in zip(c, names, strict=True) if a in cut)
            replicas.setdefault(key, []).append(i)
        for idx in replicas.values():
            if len(idx) > 1:
                out = all_reduce([grads[i][k] for i in idx],
                                 [mesh.devices[i] for i in idx])
                for i, g in zip(idx, out, strict=True):
                    grads[i][k] = g


def _shard_terms(cfg, params, group, parts, lay, stats):
    """(nll, count, aux or load statistics) of one data shard's batch:
    the unsharded loss over a :class:`GradView` from its first
    coordinate under fsdp (``parts`` one batch), the tp executor over
    its coordinates (``parts`` one batch each) otherwise."""
    if lay is None:
        return loss_terms(cfg, GradView(params, group[0]), parts, stats)
    return _TpTrain(cfg, lay, params, group).loss_terms(parts)


def value_and_grad(cfg, params: ShardedTree, micro, groups, lay=None,
                   shards=EVERY_DATA_SHARD):
    """(the whole batch's loss, each coordinate's gradient leaves) of
    the model ``cfg`` at ``params`` (ShardedTree blocks that require
    grad), data shard d (``groups[d]``, its coordinates) taking
    ``micro[d]``: under fsdp (``lay`` None) one batch on its first
    coordinate's device, under tp, fsdp_tp and ep (``lay`` the
    ``TpLayout``) one per coordinate (the module note); ``shards`` the
    loop over the data shards (``sharding.serve.EveryDataShard``)."""
    first = [m if lay is None else m[0] for m in micro]
    counts = all_sum([torch.sum(m["labels"] != IGNORE_LABEL) for m in first])
    # the MoE's load statistics of the whole batch: every data shard's
    # forward before any backward (one data shard under fsdp: its aux)
    split = cfg.family == "moe" and (lay is not None or len(groups) > 1)
    mesh = params.mesh
    nlls, kept, loss = [], [], None
    for s, grp in shards.each(groups, mesh):
        with torch.enable_grad():
            nll, _, aux = _shard_terms(cfg, params, grp, micro[s], lay,
                                       split)
            n = torch.clamp(counts.to(mesh.device(grp[0]),
                                      non_blocking=True), min=1)
            nlls.append(nll.detach())
            if split:
                kept.append((nll, n, aux))
                continue
            term = nll / n + cfg.aux_coef * aux
            term.backward()
        loss = term.detach()
    for s in shards.skipped(groups):
        here = mesh.device(groups[s][0])
        nlls.append(stand_in(nlls[1], here))
        aux = stand_in(aux, here)  # the last data shard's, read below
        if split:
            kept.append((None, None, stand_in(kept[1][2].detach(), here)))
    if split:
        tokens = sum(m["tokens"].numel() for m in first)  # routed ones
        total = all_reduce([st.detach() for _, _, st in kept],
                           [mesh.device(g[0]) for g in groups])
        for s, _ in shards.each(groups, mesh):
            nll, n, st = kept[s]
            with torch.enable_grad():
                (nll / n + cfg.aux_coef * load_balance(total[s], tokens,
                                                       own=st)).backward()
        del kept
        aux = load_balance(total[0], tokens)
    if split or len(nlls) > 1:  # aux is 0 here without MoE
        loss = all_sum(nlls) / torch.clamp(counts, min=1) \
            + cfg.aux_coef * aux.detach()
    leaves = [tree_leaves(b) for b in params.blocks]
    for s in shards.skipped(groups):  # their gradients, as the second's stand
        for c, like in zip(groups[s], groups[1], strict=True):
            for p, q in zip(leaves[mesh.index(c)], leaves[mesh.index(like)],
                            strict=True):
                if p.grad is None and q.grad is not None:
                    p.grad = stand_in(q.grad, mesh.device(c))
    grads = []
    for ls in leaves:
        gs = []
        for p in ls:
            gs.append(torch.zeros_like(p) if p.grad is None else p.grad)
            p.grad = None
        grads.append(gs)
    if lay is not None:
        _sync_replicas(params, grads)
    return loss, grads


def _leaf_reads(path, cfg) -> int:
    """How often a coordinate reads a leaf in one step: a stacked layer
    leaf once more under ``cfg.remat`` (its group recomputed in
    backward), every other leaf once."""
    return 2 if path[0] == "layers" and cfg.remat else 1


def _leaves(p_abs, pspec):
    """(path, bytes, spec) of every leaf."""
    out = []
    for path, spec in _spec_paths(pspec):
        leaf = p_abs
        for k in path:
            leaf = leaf[k]
        out.append((path, leaf.numel() * leaf.element_size(), spec))
    return out


def _cut(spec) -> set:
    return {a for x in spec for a in _axes(x)}


def step_bytes(cfg, p_abs, pspec, mesh, mode, *, batch, seq,
               batch_axes=("data",)) -> dict:
    """The bytes each collective kind moves in one training step
    (grad_accum 1) of ``batch`` rows of ``seq`` positions under
    ``mode``: the module note's formula, from the widths of ``cfg``, the
    shapes of ``p_abs`` and the cuts of ``pspec``."""
    n = len(data_shards(mesh, batch_axes))
    out = {"all-gather": 0, "all-reduce": 0, "reduce-scatter": 0}
    if n > 1:  # the label counts and the losses added over data shards
        out["all-reduce"] += (n - 1) * (8 + 4)
        if cfg.family == "moe":  # and the MoE's load statistics
            out["all-reduce"] += 2 * (n - 1) * cfg.num_layers * 2 \
                * cfg.num_experts * 4
    if mode == "fsdp":
        for path, size, spec in _leaves(p_abs, pspec):
            parts = math.prod(mesh.shape[a] for a in _cut(spec))
            out["all-gather"] += n * size * (parts - 1) // parts \
                * _leaf_reads(path, cfg)
            out["reduce-scatter"] += n * (mesh.size - 1) * size // parts
        return out
    lay = TpLayout(cfg, pspec, mesh, train=True)
    m, b = lay.model_size, batch // n
    e = torch.empty((), dtype=cfg.param_dtype).element_size()
    d = cfg.d_model
    s_tok = seq - cfg.prefix_tokens if cfg.family == "vlm" else seq
    pair = m * (m - 1)  # blocks an all-gather over the model shards moves
    row = (m - 1) * b * seq * d * (4 + e)  # a row-parallel product's sum
    # one pass of the stack per data shard, [all-gather, all-reduce]; and
    # what a remat group's recompute leaves out: the collectives after
    # its last saved tensor (checkpoint's recompute stops there)
    stack, tail = [0, 0], [0, 0]
    if cfg.family != "ssm":
        block = [0, row]  # the attention's all-reduce
        kv = cfg.num_kv_heads * cfg.head_dim
        if lay.source == "column":
            block[0] += 2 * pair * b * seq * kv // m * e
        if lay.q_spans:  # the query heads straddle wq's blocks
            block[0] += pair * b * seq * lay.cols * e
        elif lay.source == "row":
            block[1] += 2 * (m - 1) * b * seq * kv * (4 + e)
        if cfg.family == "moe":
            cap = moe.capacity(seq, cfg.top_k, cfg.num_experts,
                               cfg.capacity_factor)
            if lay.moe == "experts":
                block[0] += pair * b * cfg.num_experts // m * cap * d * e
                last = [0, 0]
            else:
                block[0] += pair * b * cfg.num_experts * cap * cfg.d_ff \
                    // m * e
                last = [pair * b * seq * d // m * e, 0]
        else:
            last = [0, row]
        n_blocks = (cfg.num_layers // cfg.attn_every
                    if cfg.family == "hybrid" else cfg.num_layers)
        stack = [n_blocks * (x + y) for x, y in zip(block, last,
                                                    strict=True)]
    if cfg.family in ("ssm", "hybrid"):
        d_in = cfg.expand * d
        proj = 2 * d_in + 2 * cfg.ssm_state + d_in // cfg.ssm_head_dim
        stack[0] += cfg.num_layers * pair * b * seq * proj // m * e
        stack[1] += cfg.num_layers * (2 * (m - 1) * b * seq * 4 + row)
        if cfg.family == "ssm":
            last = [0, row]
    groups = (len(_groups(cfg)) if cfg.family == "hybrid"
              else len(_remat_groups(cfg, range(cfg.num_layers))))
    if cfg.remat:
        tail = [groups * x for x in last]
    again = [x - y for x, y in zip(stack, tail, strict=True)] \
        if cfg.remat else [0, 0]
    out["all-gather"] += n * (stack[0] + again[0])
    out["all-reduce"] += n * (2 * stack[1] + again[1])
    out["reduce-scatter"] += n * stack[0]
    if lay.embed_cut:
        emb = n * pair * b * s_tok * d // m * e
        out["all-gather"] += emb
        out["reduce-scatter"] += emb
    if lay.head_cut:
        head = n * (m - 1) * 3 * b * s_tok * 4
        chunked = cfg.loss_chunk and s_tok > cfg.loss_chunk
        out["all-gather"] += head * (2 if chunked else 1)
        out["reduce-scatter"] += head
    for path, size, spec in _leaves(p_abs, pspec):
        cut = _cut(spec)
        parts = math.prod(mesh.shape[a] for a in cut)
        gathered = math.prod(mesh.shape[a] for a in cut if a != "model")
        if gathered > 1:  # each coordinate's read gathers it over data
            moved = mesh.size * (gathered - 1) * size // parts
            out["all-gather"] += moved * _leaf_reads(path, cfg)
            out["reduce-scatter"] += moved
        replicas = mesh.size // parts  # the gradient added over them
        out["all-reduce"] += 2 * (replicas - 1) * size
    return out


# ----------------------------------------------------------------------
# the training step (launch.steps.make_train_step with a mesh)
# ----------------------------------------------------------------------


def _microbatches(batch: ShardedTree, groups, grad_accum: int,
                  per_coord: bool) -> list:
    """Per microbatch, each data shard's rows on its first coordinate's
    device (``per_coord``: on each of its coordinates', a list):
    microbatch i is rows [i·B/g, (i+1)·B/g) of the whole batch, then
    split over the data shards (the reference's order)."""
    def places(g):
        return g if per_coord else g[:1]

    if grad_accum == 1:
        out = [[batch.at(c) for c in places(g)] for g in groups]
    else:
        n = len(groups)
        wholes = [[gather_tree(batch, at=c) for c in places(g)]
                  for g in groups]
        out = []
        for i in range(grad_accum):
            def rows(x, d, i=i):
                b = x.shape[0] // grad_accum
                return x[i * b:(i + 1) * b][d * (b // n):(d + 1) * (b // n)]

            out.append([[tree_map(lambda x, d=d: rows(x, d), w) for w in ws]
                        for d, ws in enumerate(wholes)])
        return [[m if per_coord else m[0] for m in mb] for mb in out]
    return [[m if per_coord else m[0] for m in out]]


def train_layout(cfg, pspec, mesh, mode):
    """The tp executor's ``TpLayout`` of ``pspec`` under ``mode``; None
    under fsdp.  An unknown mode, or a model cut the executor cannot
    train, raises naming it."""
    check_train_mode(mode)
    if mode == "fsdp":
        return None
    return TpLayout(cfg, pspec, mesh, train=True)


def make_train_step_on_mesh(cfg, mesh, specs, *, rho, lr, grad_accum,
                            batch_axes, mode="fsdp"):
    """``train_step(params, opt, center, batch) -> (params, opt, loss)``
    over ShardedTrees cut by ``specs`` = (param specs, AdamState specs,
    param specs, batch specs) under ``mode``: the gradient of the whole
    batch's loss (microbatches averaged as the unsharded step averages
    them), the prox pull and AdamW on each block; the loss on the mesh's
    first device."""
    groups = data_shards(mesh, batch_axes)
    lay = train_layout(cfg, specs[0], mesh, mode)

    def train_step(params, opt, center, batch, *,
                   shards=EVERY_DATA_SHARD):
        for x, s in zip((params, opt, center, batch), specs, strict=True):
            if not isinstance(x, ShardedTree) or x.specs != s:
                raise ValueError("the step's inputs are ShardedTrees cut "
                                 "by its in_specs")
        live = ShardedTree(tuple(
            tree_map(lambda p: p.detach().requires_grad_(True), b)
            for b in params.blocks), params.specs, mesh)
        micro = _microbatches(batch, groups, grad_accum, lay is not None)
        if grad_accum > 1:
            loss = torch.zeros((), dtype=torch.float32,
                               device=mesh.devices[0])
            g = [[torch.zeros_like(p) for p in tree_leaves(b)]
                 for b in params.blocks]
            for m in micro:
                li, gi = value_and_grad(cfg, live, m, groups, lay, shards)
                loss = loss + li / grad_accum
                g = [[a + b / grad_accum for a, b in zip(x, y, strict=True)]
                     for x, y in zip(g, gi, strict=True)]
        else:
            loss, g = value_and_grad(cfg, live, micro[0], groups, lay,
                                     shards)
        new_p, new_opt = [], []
        for i, (pc, cc, oc) in enumerate(zip(params.blocks, center.blocks,
                                             opt.blocks, strict=True)):
            # each coordinate's gradient let go once its block is updated
            gc, g[i] = _build(pc, g[i]), None
            gc = tree_map(lambda gl, p, c: gl + rho * (
                p.to(torch.float32) - c.to(torch.float32)).to(gl.dtype),
                gc, pc, cc)
            p, o = adam_step(pc, gc, oc, lr)
            del gc
            new_p.append(p)
            new_opt.append(o)
        return (ShardedTree(tuple(new_p), params.specs, mesh),
                ShardedTree(tuple(new_opt), opt.specs, mesh), loss)

    return train_step


def adam_specs(pspec) -> AdamState:
    """The AdamW state's specs: μ and ν cut as the parameters, the step
    replicated (the reference's ``opt_spec``)."""
    return AdamState(mu=pspec, nu=pspec, step=())


# ----------------------------------------------------------------------
# the cross-pod round on a pod × data × model mesh
# ----------------------------------------------------------------------


def cross_pod_specs(pspec) -> CrossPodState:
    """The state's specs: θ, λ, z_prev cut by ``pod_stacked_specs``, the
    controller, key and round replicated (the reference's
    ``state_spec``)."""
    pod = pod_stacked_specs(pspec)
    return CrossPodState(theta=pod, lam=pod, z_prev=pod,
                         ctrl=ControllerState(*((),) * 4), rng=(),
                         round=())


def cross_pod_batch_specs(batch_abs):
    """(pods, local_steps, rows, ...) leaves: pods over ``pod``, rows
    over ``data`` (the reference's ``P("pod", None, "data", ...)``)."""
    return tree_map(lambda x: ("pod", None, "data")
                    + (None,) * (x.dim() - 3), batch_abs)


def pod_submesh(mesh: DeviceMesh, p: int) -> DeviceMesh:
    """Pod ``p``'s ("data", "model") mesh: its coordinates, in order."""
    return DeviceMesh(mesh.axis_names[1:], mesh.sizes[1:], tuple(
        mesh.device(c) for c in mesh.coords() if c[0] == p))


def _check_pod_mesh(mesh, n_pods: int) -> None:
    if tuple(mesh.axis_names) != POD_AXES:
        raise ValueError(f"the cross-pod mesh's axes are {POD_AXES}; got "
                         f"{tuple(mesh.axis_names)}")
    if mesh.shape["pod"] != n_pods:
        raise ValueError(f"{n_pods} pods on a pod axis of "
                         f"{mesh.shape['pod']}")


def init_cross_pod_state_on_mesh(cfg: CrossPodConfig, params0,
                                 mesh, mode="fsdp") -> ShardedTree:
    """``init_cross_pod_state``'s state (θ_i = z_i = params0, λ_i = 0,
    the controller at δ⁰, the key ``PRNGKey(0)``, round 0) cut by
    :func:`cross_pod_specs` of ``mode``'s over ``mesh``, made block by
    block on each coordinate's device without the whole state."""
    _check_pod_mesh(mesh, cfg.n_pods)
    check_train_mode(mode)
    specs = cross_pod_specs(param_specs(params0, mesh, mode=mode))
    dev = mesh.devices[0]
    theta = tree_broadcast_like(params0, cfg.n_pods)
    whole = CrossPodState(
        theta=theta, z_prev=theta,
        lam=tree_map(lambda x: x.new_zeros(()).expand(x.shape), theta),
        ctrl=init_controller(cfg.n_pods, cfg.controller, device=dev),
        rng=prng.PRNGKey(0, device=dev),
        round=torch.zeros((), dtype=torch.int32, device=dev))
    blocks = tuple(tree_map(
        lambda x, s, c=c: x[block_slices(x.shape, s, mesh, c)].to(
            mesh.device(c), copy=True), whole, specs) for c in mesh.coords())
    report_copies("scatter", [x for b in blocks[1:] for x in tree_leaves(b)])
    return ShardedTree(blocks, specs, mesh)


def _owns(spec, names, coord) -> bool:
    """Whether the coordinate ``coord`` (of a mesh with axes ``names``)
    counts its block of a leaf cut by ``spec`` once in a sum over the
    mesh: it lies at position 0 of every axis the leaf is replicated
    over."""
    cut = {a for e in spec for a in ((e,) if isinstance(e, str)
                                     else (e or ()))}
    return all(i == 0 for a, i in zip(names, coord, strict=True)
               if a not in cut)


def make_cross_pod_round_on_mesh(cfg: CrossPodConfig, model, mesh, *,
                                 mode: str = "fsdp",
                                 every_pod_fires: bool = False):
    """``round_fn(state, batch) -> (state, metrics)`` over ``mesh``
    (axes ``("pod", "data", "model")``, the pod axis of ``cfg.n_pods``):
    ``state`` the ShardedTree of :func:`init_cross_pod_state_on_mesh`
    with the same ``mode`` (its θ, λ and z_prev blocks updated in
    place), ``batch`` a ShardedTree of (pods, local_steps, rows, ...)
    leaves cut by :func:`cross_pod_batch_specs`; the metrics on the
    mesh's first device.  ``every_pod_fires`` as in
    ``make_cross_pod_round``."""
    _check_pod_mesh(mesh, cfg.n_pods)
    mcfg = model.config
    n_pods = cfg.n_pods
    pspec = param_specs(abstract_params(model), mesh, mode=mode)
    specs = cross_pod_specs(pspec)
    subs = [pod_submesh(mesh, p) for p in range(n_pods)]
    groups = data_shards(subs[0], ("data",))
    lay = train_layout(mcfg, pspec, subs[0], mode)
    sub = subs[0].coords()
    pods = [[(p,) + c for c in sub] for p in range(n_pods)]
    leaf_specs = tree_leaves(pspec)
    owned = [[k for k, s in enumerate(leaf_specs)
              if _owns(s, subs[0].axis_names, c)] for c in sub]
    dev0 = mesh.devices[0]
    ctrl_cfg = cfg.controller._replace(target_rate=shard_targets(
        cfg.controller.target_rate, ClientMesh((dev0,)))[0])

    def leaves(state, field, p):
        """Pod p's blocks of one field: per sub-coordinate, its leaves
        ((1, ...) blocks)."""
        return [tree_leaves(getattr(state.at((p,) + c), field))
                for c in sub]

    def flat(lists):
        return [x for ls in lists for x in ls]

    def consensus(zs):
        """ω per sub-coordinate and leaf, one copy on each pod's."""
        omega = []
        for ci, c in enumerate(sub):
            dev = mesh.device((0,) + c)
            report_copies("all-reduce", flat(zs[p][ci]
                                             for p in range(1, n_pods)))
            omega.append([pod_mean([zs[p][ci][k][0].to(dev, non_blocking=True)
                                    for p in range(n_pods)], n_pods)
                          for k in range(len(leaf_specs))])
        out = []
        for p in range(n_pods):
            mine = [[w.to(mesh.device((p,) + c), non_blocking=True)
                     for w in ws] for c, ws in zip(sub, omega, strict=True)]
            if p:
                report_copies("all-reduce", flat(mine))
            out.append(mine)
        return out

    def distances(zs, omegas):
        """‖z_p − ω‖ of every pod (P,) on the first device."""
        per_pod = []
        for p in range(n_pods):
            parts = [sq_distances([zs[p][ci][k] for k in ks],
                                  [omegas[p][ci][k] for k in ks])
                     for ci, ks in enumerate(owned) if ks]
            per_pod.append(all_sum(parts))
        report_copies("all-gather", per_pod[1:])
        return torch.sqrt(torch.cat([d.to(dev0, non_blocking=True)
                                     for d in per_pod]))

    def local_solve(p, omega, center, batch, shards):
        """:func:`solve` from ω on pod p's sub-mesh → (θ_out leaves, the
        mean loss)."""
        params = [w.clone() for w in omega]
        n = len(leaf_specs)
        live = ShardedTree(tuple(
            _build(pspec, params[i * n:(i + 1) * n])
            for i in range(len(sub))), pspec, subs[p])

        def vg(step):
            micro = [[tree_map(lambda x: x[0, step], batch.at((p,) + c))
                      for c in (g if lay else g[:1])] for g in groups]
            if lay is None:
                micro = [m[0] for m in micro]
            loss, grads = value_and_grad(mcfg, live, micro, groups, lay,
                                         shards)
            return loss, flat(grads)

        return params, solve(cfg, params, center, vg)

    @torch.no_grad()
    def round_fn(state, batch, *, shards=EVERY_DATA_SHARD):
        if not isinstance(state, ShardedTree) or state.specs != specs:
            raise ValueError("the state is a ShardedTree cut by the "
                             "cross-pod step's in_specs[0]")
        if not isinstance(batch, ShardedTree) or any(
                tuple(s)[:3] != ("pod", None, "data")
                for s in tree_leaves(batch.specs)):
            raise ValueError("the batch is a ShardedTree cut by "
                             "cross_pod_batch_specs")
        with span("crosspod/trigger"):
            zs = [leaves(state, "z_prev", p) for p in range(n_pods)]
            omegas = consensus(zs)
            dist = distances(zs, omegas)
            events, ctrl = trigger(dist, state.blocks[0].ctrl, ctrl_cfg)
        losses = torch.zeros((n_pods,), dtype=torch.float32, device=dev0)
        if every_pod_fires:  # a pod's data shards are looped inside it
            run = shards.each(pods, mesh, runs=1)
        else:
            fired = events.tolist()  # the one host read
            run = [(p, g) for p, g in enumerate(pods) if fired[p]]
        got = {}
        for p, _ in run:
            theta = flat(leaves(state, "theta", p))
            lam = flat(leaves(state, "lam", p))
            with span("crosspod/solve"):
                lam_new, center = dual_and_center(
                    [x[0] for x in lam], [x[0] for x in theta],
                    flat(omegas[p]))
                theta_out, got[p] = local_solve(p, flat(omegas[p]),
                                                center, batch, shards)
                del center
            with span("crosspod/commit"):
                commit(theta, lam, flat(leaves(state, "z_prev", p)), 0,
                       theta_out, lam_new)
                del theta_out, lam_new
        for p in shards.skipped(pods, runs=1) if every_pod_fires else ():
            got[p] = stand_in(got[0], mesh.device(pods[p][0]))
        for p, loss in sorted(got.items()):
            losses[p] = loss
        metrics = round_metrics([events], [dist], [ctrl], [losses])
        rng, _ = prng.split(state.blocks[0].rng)
        rnd = state.blocks[0].round + 1
        blocks, moved = [], []
        for i, b in enumerate(state.blocks):
            new = b._replace(ctrl=ctrl, rng=rng, round=rnd)
            if i:
                new = new._replace(**{f: tree_map(
                    lambda x, i=i: x.to(mesh.devices[i], copy=True),
                    getattr(new, f)) for f in ("ctrl", "rng", "round")})
                moved += [*new.ctrl, new.rng, new.round]
            blocks.append(new)
        report_copies("broadcast", moved)
        return ShardedTree(tuple(blocks), specs, mesh), metrics

    return round_fn

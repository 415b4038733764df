"""Serving on a model mesh (``launch/mesh.py``): the prefill and decode
of every family that serves, in the four modes of ``sharding/specs.py``
— what the reference gets from ``jax.jit`` of its ``make_prefill_step``
/ ``make_decode_step`` with ``param_specs(mode=...)`` shardings
(``launch/steps.py``).

The parameters, the batch and the cache are ``sharding.params``'
ShardedTrees over a mesh whose axes are the batch axes and "model".  A
data shard is the batch block of one position along the batch axes and
the coordinates that hold it, in model order; data shards run one after
the other.  Every coordinate stores exactly the blocks its specs give
it (its bytes are ``per_device_bytes``).

* **fsdp.**  Each data shard runs the unsharded prefill / decode
  (``models/transformer.py``) on its batch block on its first
  coordinate, reading the parameters through a ``GatheredParams`` view
  (each layer's blocks gathered right before the layer runs, every
  other leaf when it is read), so K4 and K5 launch once per data shard
  per layer.  The cache follows ``cache_specs``: a data shard's cache
  is cut over the model axis after prefill and gathered for each decode
  step.
* **tp, fsdp_tp and ep: one executor.**  Each model shard j of a data
  shard reads its parameters through ``GatheredParams(keep=("model",))``:
  a leaf the specs cut over a batch axis (fsdp_tp, and ep's experts
  where E does not go over model) is gathered over it right before its
  layer runs, and stays the shard's block along the model axis.
  :class:`TpLayout` reads the model-axis cuts and refuses, naming the
  leaf and its spec, any it cannot serve.  ``h`` is replicated over the
  data shard's model shards.  A row-parallel product's partials (wo,
  w_down, out_proj, the GQA fallback's wk / wv) are taken in fp32
  (``models.layers.matmul_fp32``: bf16 operands' exact products summed
  in fp32) and added in shard order, then rounded once to the
  activations' dtype, as the unsharded product rounds its one fp32
  accumulation (``all_reduce``; ROADMAP D15).

  - Embedding: cut on d, the looked-up rows gathered along d; head: cut
    on the vocabulary, the last position's slices gathered.
  - Attention (dense, moe, vlm, the hybrid's shared block): shard j
    holds its heads' columns of wq and rows of wo; its kv heads are its
    own column block of wk / wv where the kv heads split over the model
    axis, else it takes the kv heads its query heads need from the
    whole k / v, put together from column blocks, row-parallel partials
    (the specs' GQA fallback) or a replicated weight.  K4 launches once
    per model shard and layer under the causal mask; the vlm's prefix
    mask runs ``blockwise_attention`` on the shard's heads.
  - MLP: w_gate / w_up columns, w_down rows (Megatron).
  - MoE: the fp32 router and the dispatch plan are computed on each
    shard from the replicated h, so routing, capacity and drops are the
    unsharded ones.  Under the hidden cut (tp, fsdp_tp; w_gate / w_up
    (E, d, f) cut on f, w_down (E, f, d) on d) each shard computes its
    f/M columns of silu(x·w_gate) ⊙ (x·w_up) for every expert, the
    blocks are gathered along f (w_down contracts over all of f), each
    shard takes its d/M output columns, combines them, and the columns
    are gathered along d.  Under the expert cut (ep) each shard runs its
    E/M experts' buffers, and the expert outputs are gathered along E
    before the combine.
  - Mamba (ssm, the hybrid's mamba layers): in_proj (d, 2·d_in + 2N +
    H) is cut on its columns, in blocks that straddle z | x | B | C |
    dt; the blocks are gathered, and each shard takes its H/M heads' z,
    x and dt and the shared B and C.  The conv, K5 and the decode
    recurrence run on the shard's heads (``models/ssm.py::ssm_mix``,
    ``ssm_mix_step``).  The gated RMSNorm's fp32 sums of squares over
    the shards' d_in/M channels are added in shard order; out_proj's
    rows are the shard's heads, its partial products added in shard
    order.
  - Cache: k / v keep each shard's kv heads (not ``cache_specs``'
    layout: ROADMAP D14); the SSM state (L, B, H, P, N) is cut on H, the
    shard's own heads, as ``cache_specs`` cuts it; the conv ring (L, B,
    K − 1, d_in + 2N) as ``cache_specs`` cuts it (on its channels, in
    blocks that straddle x | B | C): each decode step gathers a layer's
    ring, and each shard keeps its block of the new ring.

Bytes each collective kind moves (``clients.collectives``), per data
shard of B rows over M model shards, S positions (1 in decode), e bytes
an activation element:

* embedding: all-gather M(M − 1) · B·S·d/M · e;
* attention block: all-reduce (M − 1) · B·S·d · (4 + e) of the
  attention's output (M − 1 fp32 partials in, M − 1 copies of the sum
  out); the kv all-gather M(M − 1) · B·S·Kv·hd/M · e for each of k and
  v where the source is column blocks;
* MLP: all-reduce (M − 1) · B·S·d · (4 + e);
* MoE, hidden cut: all-gather M(M − 1) · B·E·C·f/M · e of the hidden
  blocks and M(M − 1) · B·S·d/M · e of the combined columns (C the
  capacity); expert cut: all-gather M(M − 1) · B·(E/M)·C·d · e;
* mamba layer: all-gather M(M − 1) · B·S·(2·d_in + 2N + H)/M · e of
  in_proj's output; all-reduce 2(M − 1) · B·S · 4 of the norm's sums of
  squares and (M − 1) · B·S·d · (4 + e) of out_proj's; in decode also the
  ring's all-gather M(M − 1) · B·(K − 1)·(d_in + 2N)/M · e where the
  ring is cut;
* head: all-gather (M − 1) · B·V/M · 4 (fp32) to the first shard;
* fsdp_tp: the data-cut leaves' all-gathers on top, every time a layer
  is read.
"""
from __future__ import annotations

import torch

from repro_torch.models import moe, ssm
from repro_torch.models.layers import matmul_fp32, rmsnorm, swiglu_hidden
from repro_torch.models.transformer import ATTN_STACK, _attention, \
    _attention_step, _check_room, _embed, _fit_kv_cache, _groups, \
    _layers, check_decodes, decode_step, init_cache, prefill
from repro_torch.utils.pytree import tree_leaves, tree_map

from .params import GatheredParams, ShardedTree, all_gather, all_reduce, \
    block_slices, cut_leaf, gather_tree, put_blocks, report_copies
from .specs import cache_specs

SERVE_MODES = ("fsdp", "tp", "fsdp_tp", "ep")

def check_serve_mode(mode: str) -> None:
    if mode not in SERVE_MODES:
        raise ValueError(f"unknown serving mode {mode!r}; the modes are "
                         f"{', '.join(SERVE_MODES)}")


def data_shards(mesh, batch_axes, model_axis="model") -> list:
    """The mesh's data shards in batch order (row-major over
    ``batch_axes``), each the list of its coordinates in model order.
    Every axis of the mesh must be a batch axis or the model axis."""
    names = list(mesh.axis_names)
    if model_axis not in names or set(names) != set(batch_axes) | {
            model_axis}:
        raise ValueError(f"a serving mesh's axes are the batch axes "
                         f"{tuple(batch_axes)} and {model_axis!r}; got "
                         f"{tuple(names)}")
    groups: dict = {}
    for c in mesh.coords():
        key = tuple(c[names.index(a)] for a in batch_axes)
        groups.setdefault(key, []).append(c)
    return [groups[k] for k in sorted(groups)]


class EveryDataShard:
    """How the executors loop over data shards (and an all-firing
    cross-pod round over its pods): every one runs.  A caller may pass
    another loop as ``shards=``; the dry-run passes a sample of them
    (``launch/dryrun.py::DataShardSample``), which runs the first
    ``runs`` (the last of them standing for the others) and leaves the
    others' outputs to :func:`stand_in`."""

    def each(self, groups, mesh, runs=2):
        """``(s, group)`` for each of ``groups`` (lists of ``mesh``'s
        coordinates) that runs, in order."""
        return enumerate(groups)

    def skipped(self, groups, runs=2) -> range:
        """The indices of ``groups`` that :meth:`each` left out."""
        return range(len(groups), len(groups))


EVERY_DATA_SHARD = EveryDataShard()


def stand_in(tree, device):
    """The output of a data shard that ``shards.skipped`` names: each
    tensor of ``tree`` (the second data shard's) as an empty one on
    ``device``, anything else as it is."""
    return tree_map(lambda x: torch.empty_like(x, device=device)
                    if isinstance(x, torch.Tensor) else x, tree)


def _gather_batch(parts, device):
    """Per-data-shard tensors concatenated along the batch on
    ``device``."""
    report_copies("all-gather", parts[1:])
    return torch.cat([p.to(device, non_blocking=True) for p in parts], 0)


def _batch_entry(batch_axes):
    return batch_axes[0] if len(batch_axes) == 1 else tuple(batch_axes)


def _spec_paths(specs, path=()):
    """(path, spec) of every leaf of a spec tree, in sorted-key order."""
    if isinstance(specs, dict):
        return [x for k in sorted(specs) for x in _spec_paths(specs[k],
                                                               path + (k,))]
    return [(path, tuple(specs))]


def _model_dim(spec, model_axis="model"):
    """The dim a spec cuts over the model axis, or None."""
    for d, e in enumerate(spec):
        if e == model_axis:
            return d
    return None


class TpLayout:
    """How a family's blocks split over the M model shards of a data
    shard under ``param_specs(mode=...)`` for tp, fsdp_tp or ep (their
    cuts over the batch axes are gathered before a leaf is read):
    ``heads`` and ``kv_heads`` per shard, and where a shard's k / v
    come from — ``"own"`` (its column block of wk / wv), else the whole
    k / v put together from column blocks (``"column"``), row-parallel
    partials (``"row"``, the specs' GQA fallback) or a replicated weight
    (``"whole"``), of which shard j keeps the kv heads ``take[j]``;
    ``moe`` the MoE cut (``"hidden"`` or ``"experts"``, None without
    MoE); ``ssm_heads`` the mamba heads per shard (0 without mamba).  A
    model cut it cannot serve raises ``ValueError`` naming the leaf and
    its spec.  ``train=True`` reads the cuts for training
    (``sharding/train.py``), which the audio encoder takes too."""

    def __init__(self, cfg, specs, mesh, model_axis="model", train=False):
        if not train:
            check_decodes(cfg)
        m = mesh.shape[model_axis]
        self.model_size = m
        given = dict(_spec_paths(specs))
        # each leaf's cut over the model axis, the layer axis dropped
        cuts = {p: tuple(e if e == model_axis else None
                         for e in (s[1:] if p[0] == "layers" else s))
                for p, s in given.items()}
        col, row, whole = (None, model_axis), (model_axis, None), (None,
                                                                    None)
        served = set()

        def cut(path, *allowed, why):
            got = cuts[path]
            if got not in allowed:
                raise ValueError(f"{'/'.join(path)} is cut as "
                                 f"{given[path]}: {why}")
            served.add(path)
            return got

        self.embed_cut = ("embed",) in cuts and cut(
            ("embed",), col, whole,
            why="the embedding is served cut on d or whole") == col
        self.head_cut = cut(("lm_head",), col, whole,
                            why="the head is served cut on its vocabulary "
                            "or whole") == col
        self.heads = self.kv_heads = self.ssm_heads = 0
        self.source, self.take, self.moe = None, None, None
        self.q_spans = None
        if cfg.family in ATTN_STACK or cfg.family == "hybrid":
            self._attention(cfg, cut, given, (
                ("shared",) if cfg.family == "hybrid" else ("layers",)),
                col, row, whole, model_axis)
        if cfg.family in ("ssm", "hybrid"):
            d_in = cfg.expand * cfg.d_model
            n = d_in // cfg.ssm_head_dim
            cut(("layers", "ssm", "in_proj"), col,
                why="tp needs in_proj cut on its columns")
            out = ("layers", "ssm", "out_proj")
            cut(out, row, why="tp needs out_proj cut on its rows")
            if n % m:
                raise ValueError(f"{n} mamba heads do not split over a "
                                 f"model axis of {m} ({'/'.join(out)} is "
                                 f"cut as {given[out]})")
            self.ssm_heads = n // m
        for path, c in cuts.items():
            if path not in served and any(c):
                raise ValueError(f"{'/'.join(path)} is cut as "
                                 f"{given[path]}: the tp executor serves "
                                 "no model cut of this leaf")

    def _attention(self, cfg, cut, given, base, col, row, whole,
                   model_axis):
        m = self.model_size
        h, kv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
        wq = base + ("attn", "wq")
        cut(wq, col, why="tp needs wq cut on its columns (heads)")
        self.head_dim, self.cols = hd, h * hd // m
        self.q_spans = None
        if h % m:
            # a shard's columns of wq straddle heads: it takes the heads
            # they touch from the gathered q, and its columns of their
            # output for its rows of wo
            spans = [(j * self.cols // hd, -(-(j + 1) * self.cols // hd))
                     for j in range(m)]
            if len({b - a for a, b in spans}) != 1:
                raise ValueError(f"{h} query heads of {hd} do not split "
                                 f"over a model axis of {m} in spans of "
                                 f"one width ({'/'.join(wq)} is cut as "
                                 f"{given[wq]})")
            self.q_spans = spans
        cut(base + ("attn", "wo"), row, why="tp needs wo cut on its rows")
        kinds = {col: "column", row: "row", whole: "whole"}
        wk = cut(base + ("attn", "wk"), *kinds,
                 why="tp takes wk cut on its columns or rows, or whole")
        cut(base + ("attn", "wv"), wk, why=f"wk is cut as {wk} and wv "
            "apart")
        if cfg.family == "moe":
            hidden = (None, None, model_axis)
            experts = (model_axis, None, None)
            why = ("tp serves the experts cut on their last dim (hidden "
                   "and output columns) or on E")
            kind = cut(base + ("moe", "w_gate"), hidden, experts, why=why)
            for w in ("w_up", "w_down"):
                cut(base + ("moe", w), kind,
                    why=f"w_gate is cut as {kind} and {w} apart")
            self.moe = "hidden" if kind == hidden else "experts"
            cut(base + ("moe", "router"), whole,
                why="the router is served whole")
        else:
            for w, want in (("w_gate", col), ("w_up", col),
                            ("w_down", row)):
                cut(base + ("mlp", w), want,
                    why=f"tp needs {w} cut as {want}")
        spans = self.q_spans or [(j * (h // m), (j + 1) * (h // m))
                                 for j in range(m)]
        self.heads, g = spans[0][1] - spans[0][0], h // kv
        self.source = kinds[wk]
        if kv % m == 0 and self.source == "column" and not self.q_spans:
            self.kv_heads, self.take = kv // m, None
            self.source = "own"
        else:
            # kv % m != 0 (so do the row fallback and a replicated wk),
            # or the query heads straddle the blocks: a shard's query
            # heads straddle kv groups, and K4 takes one group size, so
            # it takes one kv head per query head.
            self.kv_heads = self.heads
            self.take = [[q // g for q in range(a, b)] for a, b in spans]

    def q(self, lps, xs, devs):
        """Each shard's (B, S, heads·hd) query projection where its
        heads straddle the column blocks of wq (the blocks' products
        gathered), else None (each projects its own)."""
        if self.q_spans is None:
            return None
        hd = self.head_dim
        whole = all_gather([x @ lp["attn"]["wq"]
                            for x, lp in zip(xs, lps, strict=True)], -1, devs)
        return [w[..., a * hd:b * hd]
                for w, (a, b) in zip(whole, self.q_spans, strict=True)]

    def own_columns(self, j: int, y):
        """Shard j's columns of its heads' output y: those its rows of wo
        take (y itself unless the heads straddle the blocks)."""
        if self.q_spans is None:
            return y
        start = j * self.cols - self.q_spans[j][0] * self.head_dim
        return y[..., start:start + self.cols]

    def ssm_range(self, j: int) -> range:
        """Model shard j's mamba heads."""
        return range(j * self.ssm_heads, (j + 1) * self.ssm_heads)

    def kv(self, lps, xs, devs, head_dim):
        """Each shard's (k, v) before RoPE, (B, S, kv_heads, hd), or
        None where each takes its own column block."""
        if self.source == "own":
            return None
        b, s, d = xs[0].shape
        whole = []
        for w in ("wk", "wv"):
            if self.source == "column":
                t = all_gather([x @ lp["attn"][w]
                                for x, lp in zip(xs, lps, strict=True)],
                               -1, devs)
            elif self.source == "row":
                n = d // self.model_size
                t = all_reduce([matmul_fp32(x[..., j * n:(j + 1) * n],
                                            lp["attn"][w])
                                for j, (x, lp) in enumerate(zip(
                                    xs, lps, strict=True))], devs,
                               dtype=xs[0].dtype)
            else:
                t = [x @ lp["attn"][w] for x, lp in zip(xs, lps, strict=True)]
            whole.append([x.reshape(b, s, -1, head_dim) for x in t])
        out = []
        for j, dev in enumerate(devs):
            idx = torch.tensor(self.take[j], device=dev)
            out.append(tuple(torch.index_select(t[j], 2, idx)
                             for t in whole))
        return out


class _TpGroup:
    """One data shard's model shards under tp, fsdp_tp or ep: each
    shard's parameters read as its model blocks (``GatheredParams`` with
    ``keep`` the model axis, or the ``views`` given: training's
    ``sharding.train.GradView``), its device, and the blocks of the
    stack."""

    def __init__(self, cfg, lay, params, group, model_axis="model",
                 views=None):
        self.cfg, self.lay = cfg, lay
        self.ps = views or [GatheredParams(params, c, keep=(model_axis,))
                            for c in group]
        self.devs = [params.mesh.device(c) for c in group]
        self.layers = [_layers(p, cfg.num_layers) for p in self.ps]

    def at(self, i):
        """Layer i's tree on each shard."""
        return [layers[i] for layers in self.layers]

    def embed(self, tokens):
        """h on each model shard: the looked-up rows of each shard's
        embedding block, gathered along d where the embedding is cut."""
        rows = [_embed(p, t) for p, t in zip(self.ps, tokens, strict=True)]
        return all_gather(rows, -1, self.devs) if self.lay.embed_cut \
            else rows

    def logits(self, hs):
        """The last position's fp32 logits (B, 1, vocab_size) on the
        first shard's device: each shard's vocabulary slice, gathered."""
        cfg = self.cfg
        parts = [(rmsnorm(h[:, -1:], p["final_ln"], cfg.norm_eps)
                  @ p["lm_head"]).to(torch.float32)
                 for h, p in zip(hs, self.ps, strict=True)]
        if not self.lay.head_cut:
            return parts[0][..., :cfg.vocab_size]
        report_copies("all-gather", parts[1:])
        logits = torch.cat([x.to(self.devs[0], non_blocking=True)
                            for x in parts], -1)
        return logits[..., :cfg.vocab_size]

    def block(self, lps, hs, attend):
        """One attention + MLP (or MoE) block over the model shards →
        (h on each shard, the first shard's MoE routing or None):
        ``attend(j, lp, x, kv, q)`` gives shard j's heads' output before
        wo;
        the partial products with the shards' rows of wo and w_down
        summed in shard order."""
        cfg, devs, dtype = self.cfg, self.devs, hs[0].dtype
        xs = [rmsnorm(h, lp["ln1"], cfg.norm_eps)
              for h, lp in zip(hs, lps, strict=True)]
        kvs = self.lay.kv(lps, xs, devs, cfg.head_dim)
        qs = self.lay.q(lps, xs, devs)
        att = all_reduce([
            matmul_fp32(self.lay.own_columns(j, attend(
                j, lp, x, None if kvs is None else kvs[j],
                None if qs is None else qs[j])), lp["attn"]["wo"])
            for j, (lp, x) in enumerate(zip(lps, xs, strict=True))], devs,
            dtype=dtype)
        hs = [h + a for h, a in zip(hs, att, strict=True)]
        xs = [rmsnorm(h, lp["ln2"], cfg.norm_eps)
              for h, lp in zip(hs, lps, strict=True)]
        plan = None
        if self.lay.moe:
            ys, plan = self.moe(xs, lps)
        else:
            ys = all_reduce([matmul_fp32(swiglu_hidden(lp["mlp"], x),
                                         lp["mlp"]["w_down"])
                             for x, lp in zip(xs, lps, strict=True)], devs,
                            dtype=dtype)
        return [h + y for h, y in zip(hs, ys, strict=True)], plan

    def moe(self, xs, lps):
        """The MoE block's output on each shard from its (replicated)
        normed input (the module note), and the first shard's
        routing."""
        cfg, devs = self.cfg, self.devs
        plans = [moe.routing(lp["moe"], x, cfg.top_k, cfg.capacity_factor)
                 for x, lp in zip(xs, lps, strict=True)]
        bufs = [moe.dispatch(x, r) for x, r in zip(xs, plans, strict=True)]
        if self.lay.moe == "experts":
            n = bufs[0].shape[1] // self.lay.model_size
            hout = all_gather([
                moe.expert_out(moe.expert_hidden(
                    b[:, j * n:(j + 1) * n], lp["moe"]), lp["moe"]["w_down"])
                for j, (b, lp) in enumerate(zip(bufs, lps, strict=True))],
                1, devs)
            return [moe.combine(h, r) for h, r in zip(
                hout, plans, strict=True)], plans[0]
        hidden = all_gather([moe.expert_hidden(b, lp["moe"])
                             for b, lp in zip(bufs, lps, strict=True)],
                            -1, devs)
        cols = [moe.combine(moe.expert_out(hd, lp["moe"]["w_down"]), r)
                for hd, lp, r in zip(hidden, lps, plans, strict=True)]
        return all_gather(cols, -1, devs), plans[0]

    def _ssm_kw(self):
        cfg = self.cfg
        return dict(d_inner=cfg.expand * cfg.d_model,
                    ssm_state=cfg.ssm_state, head_dim=cfg.ssm_head_dim)

    def _mamba_out(self, lps, ys):
        """out_proj of the gated norm of each shard's y (its heads'
        channels) on each shard: the norm's sums of squares and the
        partial products added in shard order."""
        d_in = self.cfg.expand * self.cfg.d_model
        sq = all_reduce([torch.sum(torch.square(y.to(torch.float32)), -1,
                                   keepdim=True) for y in ys], self.devs)
        heads = self.lay.ssm_heads * self.cfg.ssm_head_dim
        return all_reduce([
            matmul_fp32(rmsnorm(y, lp["ssm"]["norm_g"][
                j * heads:(j + 1) * heads], mean_sq=t / d_in),
                lp["ssm"]["out_proj"])
            for j, (y, t, lp) in enumerate(zip(ys, sq, lps, strict=True))],
            self.devs, dtype=ys[0].dtype)

    def mamba(self, lps, hs, **mix):
        """One mamba layer's prefill → (h per shard, each shard's final
        state of its heads, the layer's conv tail (B, K − 1, d_in + 2N)
        on each shard); ``mix`` as ``ssm.ssm_mix`` takes it (training's
        ``intra_dtype`` and ``scan``)."""
        cfg, kw = self.cfg, self._ssm_kw()
        xs = [rmsnorm(h, lp["ln"], cfg.norm_eps)
              for h, lp in zip(hs, lps, strict=True)]
        zx = all_gather([x @ lp["ssm"]["in_proj"]
                         for x, lp in zip(xs, lps, strict=True)], -1,
                        self.devs)
        ys, states = [], []
        for j, (z, lp) in enumerate(zip(zx, lps, strict=True)):
            y, st = ssm.ssm_mix(lp["ssm"], z, chunk=cfg.chunk,
                                heads=self.lay.ssm_range(j), **kw, **mix)
            ys.append(y)
            states.append(st)
        out = self._mamba_out(lps, ys)
        d_in, n = kw["d_inner"], kw["ssm_state"]
        tails = [z[:, -(cfg.conv_kernel - 1):, d_in:2 * d_in + 2 * n]
                 for z in zx]
        return [h + o for h, o in zip(hs, out, strict=True)], states, tails

    def mamba_step(self, lps, hs, caches, i, ring_dim):
        """One mamba layer's decode step; each shard's state and ring
        block of layer i updated in place (``ring_dim`` the dim of a
        layer's (B, K − 1, d_in + 2N) ring cut over the model axis, or
        None)."""
        cfg, kw = self.cfg, self._ssm_kw()
        xs = [rmsnorm(h, lp["ln"], cfg.norm_eps)
              for h, lp in zip(hs, lps, strict=True)]
        zx = all_gather([x[:, 0] @ lp["ssm"]["in_proj"]
                         for x, lp in zip(xs, lps, strict=True)], -1,
                        self.devs)
        rings = [c["layers"]["conv"][i] for c in caches]
        if ring_dim is not None:
            rings = all_gather(rings, ring_dim, self.devs)
        d_in, n = kw["d_inner"], kw["ssm_state"]
        ys = []
        for j, (z, lp, ring, c) in enumerate(zip(zx, lps, rings, caches,
                                                 strict=True)):
            heads = self.lay.ssm_range(j)
            y, _, state = ssm.ssm_mix_step(
                lp["ssm"], z, ssm.head_channels(ring, heads, d_inner=d_in,
                                                head_dim=kw["head_dim"]),
                c["layers"]["ssm"][i], heads=heads, **kw)
            ys.append(y)
            c["layers"]["ssm"][i] = state
            new = torch.cat([ring, z[:, None, d_in:2 * d_in + 2 * n]], 1)[
                :, 1:]
            if ring_dim is not None:
                size = new.shape[ring_dim] // self.lay.model_size
                new = new.narrow(ring_dim, j * size, size)
            c["layers"]["conv"][i] = new
        out = self._mamba_out(lps, ys)
        return [h + o[:, None] for h, o in zip(hs, out, strict=True)]

    def prefill(self, parts, max_seq):
        """The data shard's prefill (``parts`` its batch block on each
        shard) → (logits, one cache per shard; the conv ring whole)."""
        cfg, lay = self.cfg, self.lay
        hs = self.embed([bp["tokens"] for bp in parts])
        mask = {}
        if cfg.family == "vlm":
            hs = [torch.cat([bp["patches"].to(cfg.param_dtype)
                             @ p["patch_proj"], h], dim=1)
                  for bp, p, h in zip(parts, self.ps, hs, strict=True)]
            mask = dict(mask_mode="prefix", prefix_len=cfg.prefix_tokens)
        s = hs[0].shape[1]
        positions = [torch.arange(s, device=d) for d in self.devs]
        m = len(self.devs)
        kvs = [([], []) for _ in range(m)]
        states, tails = [[] for _ in range(m)], [[] for _ in range(m)]

        def attend(j, lp, x, kv, q):
            y, (k, v) = _attention(
                cfg, lp, x, positions[j], window=cfg.sliding_window,
                num_heads=lay.heads, num_kv_heads=lay.kv_heads, kv=kv,
                project=False, q=q, **mask)
            kvs[j][0].append(k)
            kvs[j][1].append(v)
            return y

        def mamba(hs, i):
            hs, st, tl = self.mamba(self.at(i), hs)
            for j in range(m):
                states[j].append(st[j])
                tails[j].append(tl[j])
            return hs

        if cfg.family in ATTN_STACK:
            for i in range(cfg.num_layers):
                hs, _ = self.block(self.at(i), hs, attend)
        elif cfg.family == "ssm":
            for i in range(cfg.num_layers):
                hs = mamba(hs, i)
        else:
            for group in _groups(cfg):
                for i in group:
                    hs = mamba(hs, i)
                hs, _ = self.block([p["shared"] for p in self.ps], hs,
                                   attend)
        caches = []
        for j in range(m):
            k, v = kvs[j]
            cache = (_fit_kv_cache(cfg, torch.stack(k), torch.stack(v),
                                   max_seq, s) if k else {"pos": s})
            if states[j]:
                cache["layers"] = {"ssm": torch.stack(states[j]),
                                   "conv": torch.stack(tails[j])}
            caches.append(cache)
        return self.logits(hs), caches

    def decode(self, tokens, caches, ring_dim):
        """The data shard's decode step; each shard's cache updated in
        place."""
        cfg, lay = self.cfg, self.lay
        pos = caches[0]["pos"]
        _check_room(cfg, caches[0])
        hs = self.embed(tokens)

        def attend_at(gi):
            def attend(j, lp, x, kv, q):
                return _attention_step(
                    cfg, lp, x, (caches[j]["k"][gi], caches[j]["v"][gi]),
                    pos, window=cfg.sliding_window, num_heads=lay.heads,
                    num_kv_heads=lay.kv_heads, kv=kv, project=False, q=q)
            return attend

        if cfg.family in ATTN_STACK:
            for i in range(cfg.num_layers):
                hs, _ = self.block(self.at(i), hs, attend_at(i))
        elif cfg.family == "ssm":
            for i in range(cfg.num_layers):
                hs = self.mamba_step(self.at(i), hs, caches, i, ring_dim)
        else:
            for gi, group in enumerate(_groups(cfg)):
                for i in group:
                    hs = self.mamba_step(self.at(i), hs, caches, i,
                                         ring_dim)
                hs, _ = self.block([p["shared"] for p in self.ps], hs,
                                   attend_at(gi))
        for c in caches:
            c["pos"] = pos + 1
        return self.logits(hs)


def tp_cache_specs(cfg, batch, mesh, batch_axes=("data",),
                   model_axis="model"):
    """The layout of the tp executor's cache of ``batch`` rows: k / v
    with the batch over ``batch_axes`` and the kv heads over ``model``
    (ROADMAP D14), the SSM state and conv ring as ``cache_specs``."""
    entry = _batch_entry(batch_axes)
    specs = cache_specs(init_cache(cfg, batch, 1, device="meta"), mesh,
                        batch_axes=entry, model_axis=model_axis)
    for k in ("k", "v"):
        if k in specs:
            specs[k] = (None, entry, None, model_axis, None)
    if "layers" in specs and specs["layers"]["ssm"][2] != model_axis:
        raise ValueError(f"the SSM state is cut as {specs['layers']['ssm']}"
                         "; tp keeps each model shard's heads (dim 2)")
    return specs


@torch.no_grad()
def prefill_on_mesh(cfg, params, batch, max_seq=None, *, mode="fsdp",
                    batch_axes=("data",), shards=EVERY_DATA_SHARD):
    """Prefill on a model mesh (``params`` and ``batch`` are
    ShardedTrees over one mesh) → (the last position's fp32 logits (B,
    1, vocab_size), put together on the mesh's first device; the cache,
    a ShardedTree: ``cache_specs``' layout under fsdp,
    :func:`tp_cache_specs`' under tp, fsdp_tp and ep).  ``shards``: the
    loop over data shards (:class:`EveryDataShard`)."""
    check_decodes(cfg)
    check_serve_mode(mode)
    mesh = params.mesh
    groups = data_shards(mesh, batch_axes)
    blocks = [None] * mesh.size
    logits = []
    if mode == "fsdp":
        specs = None
        for _, group in shards.each(groups, mesh):
            lg, cache = prefill(cfg, GatheredParams(params, group[0]),
                                batch.at(group[0]), max_seq)
            logits.append(lg)
            if specs is None:
                whole = tree_map(lambda x: torch.empty(
                    (x.shape[0], x.shape[1] * len(groups)) + x.shape[2:],
                    device="meta") if isinstance(x, torch.Tensor) else x,
                    cache)
                specs = cache_specs(whole, mesh,
                                    batch_axes=_batch_entry(batch_axes))
            for c in group:
                blocks[mesh.index(c)] = tree_map(
                    lambda x, sp, c=c: cut_leaf(x, sp, mesh, c,
                                                keep=batch_axes),
                    cache, specs)
                if c != group[0]:
                    report_copies("scatter",
                                  tree_leaves(blocks[mesh.index(c)]))
    else:
        lay = TpLayout(cfg, params.specs, mesh)
        rows = batch.at(groups[0][0])["tokens"].shape[0]
        specs = tp_cache_specs(cfg, rows * len(groups), mesh, batch_axes)
        for _, group in shards.each(groups, mesh):
            parts = [batch.at(c) for c in group]
            lg, caches = _TpGroup(cfg, lay, params, group).prefill(
                parts, max_seq or parts[0]["tokens"].shape[1])
            logits.append(lg)
            for c, cache in zip(group, caches, strict=True):
                if "layers" in cache:
                    ring = cache["layers"]["conv"]
                    cache["layers"]["conv"] = ring[block_slices(
                        ring.shape, specs["layers"]["conv"], mesh, c,
                        keep=batch_axes)].contiguous()
                blocks[mesh.index(c)] = cache
    for s in shards.skipped(groups):
        logits.append(stand_in(logits[1], mesh.device(groups[s][0])))
        for c, like in zip(groups[s], groups[1], strict=True):
            blocks[mesh.index(c)] = stand_in(blocks[mesh.index(like)],
                                             mesh.device(c))
    return (_gather_batch(logits, mesh.devices[0]),
            ShardedTree(tuple(blocks), specs, mesh))


@torch.no_grad()
def decode_step_on_mesh(cfg, params, token, cache, *, mode="fsdp",
                        batch_axes=("data",), shards=EVERY_DATA_SHARD):
    """One token (a ShardedTree of the (B, 1) tokens) against a filled
    mesh cache → (fp32 logits (B, 1, vocab_size) on the mesh's first
    device, the cache, its blocks updated in place).  ``shards``: the
    loop over data shards (:class:`EveryDataShard`)."""
    check_decodes(cfg)
    check_serve_mode(mode)
    mesh = params.mesh
    groups = data_shards(mesh, batch_axes)
    logits = []
    if mode == "fsdp":
        for _, group in shards.each(groups, mesh):
            at = group[0]
            local = gather_tree(cache, at=at, keep=batch_axes)
            lg, local = decode_step(cfg, GatheredParams(params, at),
                                    token.at(at), local)
            logits.append(lg)
            put_blocks(cache, local, group, at, keep=batch_axes)
    else:
        lay = TpLayout(cfg, params.specs, mesh)
        ring_dim = None
        if "layers" in cache.specs:
            ring_dim = _model_dim(cache.specs["layers"]["conv"][1:])
        for _, group in shards.each(groups, mesh):
            logits.append(_TpGroup(cfg, lay, params, group).decode(
                [token.at(c) for c in group], [cache.at(c) for c in group],
                ring_dim))
    for s in shards.skipped(groups):
        logits.append(stand_in(logits[1], mesh.device(groups[s][0])))
        for c, like in zip(groups[s], groups[1], strict=True):
            if "pos" in cache.at(c):
                cache.at(c)["pos"] = cache.at(like)["pos"]
    return _gather_batch(logits, mesh.devices[0]), cache

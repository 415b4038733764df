"""Step builders of the LM paths (port of ``repro/launch/steps.py``).

Every step is the paper's computation at its scope:

* :func:`make_train_step` (one pod) — one client-local FedBack inner
  iteration (Eq. 2.3): the gradient of the loss plus the prox pull
  ρ(θ − c) toward the ADMM centre c = ω − λ (taken in fp32 and cast to
  the gradient's dtype), then an AdamW step (``optim/adam.py``);
  ``grad_accum`` > 1 splits the batch into microbatches whose losses
  and gradients are averaged in the reference's order;
* :func:`make_cross_pod_step` — a full FedBack round with one silo per
  pod (``core/crosspod.py``): trigger norms, controller, gated local
  updates and the consensus mean over the pods;
* :func:`make_prefill_step` / :func:`make_decode_step` — the serving
  paths with a KV cache (K4 in prefill);
* :func:`make_encode_step` — the audio encoder's serving pass, which
  has no prefill or cache: frames through the bidirectional stack to
  per-frame logits (the port's own; the reference's prefill raises for
  the encoder, and so does its dry-run of ``prefill_32k``).

Each builder returns ``(step, abstract_args)``: the step function and
its arguments as tensors on the meta device (shapes and dtypes, no
storage), the counterpart of the reference's ``ShapeDtypeStruct``\\ s.
Parameters are in the reference's layout, as ``Model.init`` gives them.

Every step takes ``mesh=`` (a ``launch.mesh.DeviceMesh``) and
``mode=`` as the reference's do; ``mesh=None`` is the one-device step.
The serving steps' mesh has the axes ``batch_axes`` and ``"model"``,
their modes are the reference's four — ``"fsdp"`` (its default),
``"tp"``, ``"fsdp_tp"`` and ``"ep"`` — for every family that serves
(``sharding/serve.py``); the training step's mesh has the axes
``batch_axes`` and ``"model"``, the cross-pod step's ``("pod", "data",
"model")``, and both train in the same four modes every family, on any
data axis (``sharding/train.py``).  With a mesh a step takes and returns
``sharding.params.ShardedTree``\\ s — parameters, AdamW moments and
the centre cut by ``param_specs``, the cross-pod state by
``pod_stacked_specs`` (the controller, key and round replicated), the
batch by ``batch_specs`` (the cross-pod batch's rows over ``data``),
the cache as ``sharding.serve.prefill_on_mesh`` says — with logits,
losses and metrics on the mesh's first device, and ``abstract_args``
is a :class:`MeshArgs`: the same meta tensors, with ``in_specs`` and
``out_specs`` — the reference's ``in_shardings`` / ``out_shardings`` as
spec trees (``None`` where the reference leaves the placement to XLA).
A mesh step also takes ``shards=``, its loop over the data shards
(``sharding.serve.EveryDataShard``: every one runs; the dry-run passes
a sample of them).  ``make_mesh_serve_steps`` gives the serving two for
whole batches and tokens.  ``core.crosspod``'s own ``mesh=`` (a client
mesh) places whole pods on cards instead.
"""
from __future__ import annotations

import torch

from repro_torch.core.controller import ControllerConfig, init_controller
from repro_torch.core.crosspod import CrossPodConfig, CrossPodState, \
    make_cross_pod_round
from repro_torch.models.api import META, Model, abstract_cache, \
    abstract_params, input_specs
from repro_torch.models.layers import rmsnorm
from repro_torch.models.transformer import forward_hidden
from repro_torch.optim.adam import adam_init, adam_step
from repro_torch.sharding.params import shard_tree
from repro_torch.sharding.serve import EVERY_DATA_SHARD, TpLayout, \
    check_serve_mode, data_shards, decode_step_on_mesh, prefill_on_mesh
from repro_torch.sharding.specs import batch_specs, cache_specs, \
    param_specs
from repro_torch.sharding.train import adam_specs, check_train_mode, \
    cross_pod_batch_specs, cross_pod_specs, make_cross_pod_round_on_mesh, \
    make_train_step_on_mesh
from repro_torch.utils.pytree import tree_leaves, tree_map

DEFAULT_RHO = 1e-4
DEFAULT_LR = 3e-4


def make_train_step(model: Model, mesh=None, *, batch: int, seq: int,
                    mode: str = "fsdp", rho: float = DEFAULT_RHO,
                    lr: float = DEFAULT_LR, batch_axes=("data",),
                    grad_accum: int = 1):
    """``train_step(params, opt, center, batch) -> (params, opt, loss)``
    and its abstract (params, AdamState, center, batch).  With ``mesh``
    (axes ``batch_axes`` and ``"model"``; ``mode`` one of the four):
    ShardedTrees in and out, the loss on the mesh's first device, and a
    :class:`MeshArgs` (the module note)."""
    cfg = model.config
    p_abs = abstract_params(model)
    opt_abs = adam_init(p_abs)
    b_abs = input_specs(cfg, mode="train", batch=batch, seq=seq)
    if mesh is not None:
        check_train_mode(mode)
        n_data = len(data_shards(mesh, batch_axes))
        if batch % (grad_accum * n_data):
            raise ValueError(f"batch {batch} does not split into "
                             f"{grad_accum} microbatches over {n_data} "
                             "data shards")
        pspec = param_specs(p_abs, mesh, mode=mode)
        baxes = tuple(batch_axes) if len(batch_axes) > 1 else batch_axes[0]
        in_specs = (pspec, adam_specs(pspec), pspec,
                    batch_specs(b_abs, batch_axes=baxes))
        step = make_train_step_on_mesh(
            cfg, mesh, in_specs, rho=rho, lr=lr, grad_accum=grad_accum,
            batch_axes=tuple(batch_axes), mode=mode)
        return step, MeshArgs((p_abs, opt_abs, p_abs, b_abs),
                              in_specs=in_specs,
                              out_specs=(pspec, in_specs[1], None))

    def value_and_grad(params, micro):
        leaves = [p.detach().requires_grad_(True)
                  for p in tree_leaves(params)]
        it = iter(leaves)
        live = tree_map(lambda _: next(it), params)
        with torch.enable_grad():
            loss = model.loss(live, micro)
            grads = torch.autograd.grad(loss, leaves)
        it = iter(grads)
        return loss.detach(), tree_map(lambda _: next(it), params)

    def train_step(params, opt, center, batch):
        if grad_accum > 1:
            loss = torch.zeros((), dtype=torch.float32,
                               device=tree_leaves(params)[0].device)
            g = tree_map(torch.zeros_like, params)
            for i in range(grad_accum):
                micro = tree_map(lambda x, i=i: x.reshape(
                    (grad_accum, x.shape[0] // grad_accum)
                    + tuple(x.shape[1:]))[i], batch)
                li, gi = value_and_grad(params, micro)
                loss = loss + li / grad_accum
                g = tree_map(lambda a, b: a + b / grad_accum, g, gi)
        else:
            loss, g = value_and_grad(params, batch)
        g = tree_map(lambda gl, p, c: gl + rho * (
            p.to(torch.float32) - c.to(torch.float32)).to(gl.dtype),
            g, params, center)
        params, opt = adam_step(params, g, opt, lr)
        return params, opt, loss

    return train_step, (p_abs, opt_abs, p_abs, b_abs)


def make_cross_pod_step(model: Model, mesh=None, *, batch: int, seq: int,
                        n_pods: int | None = None, local_steps: int = 2,
                        mode: str = "fsdp", rho: float = DEFAULT_RHO,
                        lr: float = DEFAULT_LR, target_rate: float = 0.5,
                        every_pod_fires: bool = False):
    """A full FedBack round across pods: ``(round_fn, (state_abs,
    batch_abs))``, the batch (pods, local_steps, batch // (pods ·
    local_steps), seq); ``every_pod_fires`` as in
    ``make_cross_pod_round`` (the meta-device count).  On one device
    ``n_pods`` defaults to 2.  With ``mesh`` (axes ``("pod", "data",
    "model")``; ``mode`` one of the four) the pods are
    ``mesh.shape["pod"]``, the round is
    ``sharding.train.make_cross_pod_round_on_mesh``'s and
    ``abstract_args`` a :class:`MeshArgs` (the module note)."""
    cfg = model.config
    if mesh is not None:
        check_train_mode(mode)
        if n_pods not in (None, mesh.shape["pod"]):
            raise ValueError(f"n_pods {n_pods} on a pod axis of "
                             f"{mesh.shape['pod']}")
        n_pods = mesh.shape["pod"]
    n_pods = n_pods or 2
    cp = CrossPodConfig(
        n_pods=n_pods, rho=rho, lr=lr, local_steps=local_steps,
        controller=ControllerConfig(K=0.5, alpha=0.9,
                                    target_rate=target_rate))
    per_step = batch // (n_pods * local_steps)
    if per_step < 1:
        raise ValueError(f"batch {batch} is smaller than {n_pods} pods × "
                         f"{local_steps} local steps")
    p_abs = abstract_params(model)

    def pods(x):
        return torch.empty((n_pods,) + tuple(x.shape), dtype=x.dtype,
                           device=META)

    theta = tree_map(pods, p_abs)
    state_abs = CrossPodState(
        theta=theta, lam=theta, z_prev=theta,
        ctrl=init_controller(n_pods, cp.controller, device=META),
        rng=torch.empty((2,), dtype=torch.int64, device=META),
        round=torch.empty((), dtype=torch.int32, device=META))
    flat = input_specs(cfg, mode="train", batch=per_step, seq=seq)
    b_abs = tree_map(lambda x: torch.empty(
        (n_pods, local_steps) + tuple(x.shape), dtype=x.dtype, device=META),
        flat)
    if mesh is None:
        return make_cross_pod_round(
            cp, model.loss, every_pod_fires=every_pod_fires), (state_abs,
                                                               b_abs)
    if per_step % mesh.shape["data"]:
        raise ValueError(f"{per_step} rows a step do not split over a data "
                         f"axis of {mesh.shape['data']}")
    state_spec = cross_pod_specs(param_specs(p_abs, mesh, mode=mode))
    round_fn = make_cross_pod_round_on_mesh(cp, model, mesh, mode=mode,
                                            every_pod_fires=every_pod_fires)
    return round_fn, MeshArgs((state_abs, b_abs), in_specs=(
        state_spec, cross_pod_batch_specs(b_abs)), out_specs=(state_spec,
                                                              None))


class MeshArgs(tuple):
    """A mesh step's abstract arguments (a tuple of meta trees) with
    ``in_specs`` (one spec tree per argument) and ``out_specs`` (one per
    output), the counterparts of the reference's ``in_shardings`` and
    ``out_shardings``."""

    def __new__(cls, args, *, in_specs, out_specs):
        self = super().__new__(cls, args)
        self.in_specs, self.out_specs = in_specs, out_specs
        return self


def _mesh_specs(model, mesh, mode, batch_axes, batch, seq):
    """(param specs, batch entry, cache specs) of a serving step on
    ``mesh``; raises where the mode or the batch does not fit."""
    check_serve_mode(mode)
    n_data = len(data_shards(mesh, batch_axes))
    if batch % n_data:
        raise ValueError(f"batch {batch} does not split over {n_data} "
                         f"data shards of {tuple(batch_axes)}")
    pspec = param_specs(abstract_params(model), mesh, mode=mode)
    if mode != "fsdp":
        TpLayout(model.config, pspec, mesh)  # raises where it cannot serve
    baxes = tuple(batch_axes) if len(batch_axes) > 1 else batch_axes[0]
    cspec = cache_specs(abstract_cache(model, batch, seq), mesh,
                        batch_axes=baxes)
    return pspec, baxes, cspec


def _check_specs(params, pspec):
    if params.specs != pspec:
        raise ValueError("the parameters were not cut by this step's "
                         "param_specs; shard them with its in_specs[0]")


def make_prefill_step(model: Model, mesh=None, *, batch: int, seq: int,
                      mode: str = "fsdp", batch_axes=("data",)):
    """``prefill_step(params, batch) -> (last logits, cache)`` with a
    cache of ``seq`` positions; abstract (params, batch).  With
    ``mesh``: ShardedTrees in and out (the module note)."""
    p_abs = abstract_params(model)
    b_abs = input_specs(model.config, mode="prefill", batch=batch, seq=seq)
    if mesh is None:
        def prefill_step(params, batch):
            return model.prefill(params, batch, seq)

        return prefill_step, (p_abs, b_abs)
    pspec, baxes, cspec = _mesh_specs(model, mesh, mode, batch_axes, batch,
                                      seq)
    bspec = batch_specs(b_abs, batch_axes=baxes)

    def mesh_prefill_step(params, batch, *, shards=EVERY_DATA_SHARD):
        _check_specs(params, pspec)
        return prefill_on_mesh(model.config, params, batch, seq, mode=mode,
                               batch_axes=tuple(batch_axes), shards=shards)

    return mesh_prefill_step, MeshArgs((p_abs, b_abs), in_specs=(
        pspec, bspec), out_specs=(None, cspec))


def make_decode_step(model: Model, mesh=None, *, batch: int, seq: int,
                     mode: str = "fsdp", batch_axes=("data",)):
    """``decode_step(params, token, cache) -> (logits, cache)``: one new
    token against a ``seq``-position cache; abstract (params, token,
    cache).  With ``mesh``: ShardedTrees in and out (the module note);
    the token is cut over the batch axes where ``batch`` > 1."""
    p_abs = abstract_params(model)
    tok_abs = input_specs(model.config, mode="decode", batch=batch,
                          seq=seq)["token"]
    cache_abs = abstract_cache(model, batch, seq)
    if mesh is None:
        def decode_step(params, token, cache):
            return model.decode_step(params, token, cache)

        return decode_step, (p_abs, tok_abs, cache_abs)
    pspec, baxes, cspec = _mesh_specs(model, mesh, mode, batch_axes, batch,
                                      seq)
    tspec = (baxes, None) if batch > 1 else ()

    def mesh_decode_step(params, token, cache, *,
                         shards=EVERY_DATA_SHARD):
        _check_specs(params, pspec)
        return decode_step_on_mesh(model.config, params, token, cache,
                                   mode=mode, batch_axes=tuple(batch_axes),
                                   shards=shards)

    return mesh_decode_step, MeshArgs((p_abs, tok_abs, cache_abs),
                                      in_specs=(pspec, tspec, cspec),
                                      out_specs=(None, cspec))


def make_mesh_serve_steps(model: Model, mesh, *, batch: int, seq: int,
                          mode: str = "fsdp", batch_axes=("data",)):
    """The mesh's serving steps on plain inputs → ``(prefill(params,
    batch), decode(params, token, cache), the prefill's MeshArgs)``:
    the batch and the token are whole tensors, as the one-device steps
    take them, and are cut by the steps' ``in_specs``; the parameters
    (cut by ``in_specs[0]``) and the cache stay ShardedTrees."""
    pre, pargs = make_prefill_step(model, mesh, batch=batch, seq=seq,
                                   mode=mode, batch_axes=batch_axes)
    dec, dargs = make_decode_step(model, mesh, batch=batch, seq=seq,
                                  mode=mode, batch_axes=batch_axes)

    def prefill(params, batch):
        return pre(params, shard_tree(batch, pargs.in_specs[1], mesh))

    def decode(params, token, cache):
        return dec(params, shard_tree(token, dargs.in_specs[1], mesh), cache)

    return prefill, decode, pargs


def make_encode_step(model: Model, *, batch: int, seq: int):
    """``encode_step(params, features) -> logits`` (B, S, V) of the audio
    family over ``seq`` frames (``forward_hidden``, the final norm and
    the head, no gradient); abstract (params, features)."""
    cfg = model.config
    if cfg.family != "audio":
        raise ValueError(f"{cfg.name} is not an encoder: serve it with "
                         "make_prefill_step")
    p_abs = abstract_params(model)
    f_abs = input_specs(cfg, mode="train", batch=batch,
                        seq=seq)["features"]

    @torch.no_grad()
    def encode_step(params, features):
        h, _ = forward_hidden(cfg, params, {"features": features})
        return rmsnorm(h, params["final_ln"], cfg.norm_eps) \
            @ params["lm_head"]

    return encode_step, (p_abs, f_abs)

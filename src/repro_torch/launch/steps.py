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
There are no shardings: the reference's ``in_shardings`` /
``out_shardings`` (``jax.sharding`` placement over a pod × data × model
mesh) have no counterpart on one card; ``core.crosspod``'s ``mesh=``
places pods on cards instead.  Parameters are in the reference's
layout, as ``Model.init`` gives them.
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
from repro_torch.utils.pytree import tree_leaves, tree_map

DEFAULT_RHO = 1e-4
DEFAULT_LR = 3e-4


def make_train_step(model: Model, *, batch: int, seq: int,
                    rho: float = DEFAULT_RHO, lr: float = DEFAULT_LR,
                    grad_accum: int = 1):
    """``train_step(params, opt, center, batch) -> (params, opt, loss)``
    and its abstract (params, AdamState, center, batch)."""
    cfg = model.config
    p_abs = abstract_params(model)
    opt_abs = adam_init(p_abs)
    b_abs = input_specs(cfg, mode="train", batch=batch, seq=seq)

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


def make_cross_pod_step(model: Model, *, batch: int, seq: int,
                        n_pods: int = 2, local_steps: int = 2,
                        rho: float = DEFAULT_RHO, lr: float = DEFAULT_LR,
                        target_rate: float = 0.5,
                        every_pod_fires: bool = False):
    """A full FedBack round across pods on one device: ``(round_fn,
    (state_abs, batch_abs))``, the batch (pods, local_steps, batch //
    (pods · local_steps), seq); ``every_pod_fires`` as in
    ``make_cross_pod_round`` (the meta-device count)."""
    cfg = model.config
    cp = CrossPodConfig(
        n_pods=n_pods, rho=rho, lr=lr, local_steps=local_steps,
        controller=ControllerConfig(K=0.5, alpha=0.9,
                                    target_rate=target_rate))
    round_fn = make_cross_pod_round(cp, model.loss,
                                    every_pod_fires=every_pod_fires)
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
    return round_fn, (state_abs, b_abs)


def make_prefill_step(model: Model, *, batch: int, seq: int):
    """``prefill_step(params, batch) -> (last logits, cache)`` with a
    cache of ``seq`` positions; abstract (params, batch)."""
    p_abs = abstract_params(model)
    b_abs = input_specs(model.config, mode="prefill", batch=batch, seq=seq)

    def prefill_step(params, batch):
        return model.prefill(params, batch, seq)

    return prefill_step, (p_abs, b_abs)


def make_decode_step(model: Model, *, batch: int, seq: int):
    """``decode_step(params, token, cache) -> (logits, cache)``: one new
    token against a ``seq``-position cache; abstract (params, token,
    cache)."""
    p_abs = abstract_params(model)
    tok_abs = input_specs(model.config, mode="decode", batch=batch,
                          seq=seq)["token"]
    cache_abs = abstract_cache(model, batch, seq)

    def decode_step(params, token, cache):
        return model.decode_step(params, token, cache)

    return decode_step, (p_abs, tok_abs, cache_abs)


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

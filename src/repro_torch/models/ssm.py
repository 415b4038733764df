"""Mamba-2 (SSD — state-space duality) mixer layer
(``repro/models/ssm.py``), n_groups = 1.

  in_proj  : d → [z (d_in), x (d_in), B (N), C (N), dt (H)]
  conv1d   : causal depthwise over the concatenated (x, B, C) channels
  SSD core : h_t = a_t h_{t-1} + dt_t (B_t ⊗ x_t),  a_t = exp(A·dt_t)
             y_t = C_t · h_t + D ⊙ x_t           (scalar-per-head A < 0)
  gate     : y ← RMSNorm(y · silu(z)); out_proj: d_in → d

Prefill and training run the chunked SSD algorithm: the intra-chunk
terms are plain torch einsums (XLA computes them outside Pallas in the
JAX package) and the inter-chunk scan is the one function named by
``scan=``: ``kernels.ops.ssd_scan`` (K5) in prefill, the default
(looked up when the layer runs, so the dry-run's meta-device stand-in
takes its place: ``launch/dryrun.py``), and
the plain, differentiable ``kernels.ssd_scan.ssd_scan_ref`` in the
training loss (the reference's training SSD is a ``lax.scan``; K5 has no
backward and refuses an input that requires grad).  Decode is the O(1)
recurrence with a (conv ring, ssm state) cache.  Between the two
projections every step is per head or per conv channel
(:func:`ssm_mix`, :func:`ssm_mix_step` take a range of heads), which
tensor-parallel serving runs on each model shard's heads
(``sharding/serve.py``).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch import prng
from repro_torch.kernels import ops

from .layers import dense_init, rmsnorm, scaled_normal


def softplus(x):
    """``jax.nn.softplus`` (log(1 + eˣ) with no cut-over threshold)."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype,
                                          device=x.device))


def ssm_dims(d_model, expand, ssm_state, head_dim):
    d_inner = expand * d_model
    n_heads = d_inner // head_dim
    conv_dim = d_inner + 2 * ssm_state
    return d_inner, n_heads, conv_dim


def ssm_init(key, d_model, *, expand, ssm_state, head_dim, conv_kernel,
             dtype, device):
    d_inner, n_heads, conv_dim = ssm_dims(d_model, expand, ssm_state,
                                          head_dim)
    k1, k2, k3, _ = prng.split(key, 4)
    proj_out = 2 * d_inner + 2 * ssm_state + n_heads
    return {
        **ssm_fixed_params(n_heads, device),
        "in_proj": dense_init(k1, d_model, proj_out, dtype, device),
        "conv_w": scaled_normal(k2, (conv_kernel, conv_dim),
                                (1.0 / conv_kernel) ** 0.5, dtype, device),
        "conv_b": torch.zeros((conv_dim,), dtype=dtype, device=device),
        "norm_g": torch.ones((d_inner,), dtype=dtype, device=device),
        "out_proj": dense_init(k3, d_inner, d_model, dtype, device),
    }


def linspace_f32(start: float, stop: float, num: int) -> torch.Tensor:
    """``jnp.linspace(start, stop, num)`` in fp32 on the host, as XLA
    compiles it: step = i·f32(1/(num−1)), then
    fma(i, f32(stop·f32(1/(num−1))), start·(1 − step)), the endpoint
    appended.  (The FMA is taken in float64: the product of two fp32
    values is exact there.)"""
    f32 = torch.float32
    if num == 1:
        return torch.tensor([start], dtype=f32)
    i = torch.arange(num - 1, dtype=f32)
    c1 = torch.tensor(1.0 / (num - 1), dtype=f32)
    left = torch.tensor(start, dtype=f32) * (1 - i * c1)
    right = torch.tensor(stop, dtype=f32) * c1
    out = (i.double() * right.double() + left.double()).to(f32)
    return torch.cat([out, torch.tensor([stop], dtype=f32)])


def ssm_fixed_params(n_heads, device):
    """A_log = log(linspace(1, 16)), D = 1 and dt_bias =
    log(exp(linspace(1e-3, 0.1)) − 1 + 1e-9), in fp32 as the JAX
    package computes them, on the host (the same values on every
    device).  The linspace is bit-equal to the JAX package's; XLA's CPU
    log is not correctly rounded, so A_log and dt_bias may differ from
    the JAX package's by an ulp (ROADMAP Queue 3 D3)."""
    device = torch.device(device)
    if device.type == "meta":
        return {k: torch.empty((n_heads,), device=device)
                for k in ("A_log", "D", "dt_bias")}
    out = {
        "A_log": torch.log(linspace_f32(1.0, 16.0, n_heads)),
        "D": torch.ones((n_heads,), dtype=torch.float32),
        "dt_bias": torch.log(torch.exp(linspace_f32(1e-3, 0.1, n_heads))
                             - 1.0 + 1e-9),
    }
    return {k: v.to(device) for k, v in out.items()}


def _causal_conv(xbc, w, b):
    """Depthwise causal conv over (B, S, Cdim) with kernel (K, Cdim)."""
    k = w.shape[0]
    pad = F.pad(xbc, (0, 0, k - 1, 0))
    out = sum(pad[:, i:i + xbc.shape[1], :] * w[i] for i in range(k))
    return F.silu(out + b)


def ssd_chunked(x, dt, a_log, bmat, cmat, *, chunk, intra_dtype=None,
                scan=None):
    """Chunked SSD core.

    x: (B, S, H, P); dt: (B, S, H); bmat/cmat: (B, S, N).
    Returns y: (B, S, H, P) fp32 and the final state (B, H, P, N) fp32.
    ``scan(states, decays) -> (h_prev, h_last)`` is the inter-chunk
    scan: K5 (``ops.ssd_scan``, for ``None``) or its plain version
    ``ssd_scan_ref``, which autograd differentiates.

    Precision policy as in the JAX package: the large tensors (x, B, C,
    the 5-D decay kernel, chunk states) in the input dtype
    (``intra_dtype`` overrides); the per-step log-decays, their
    cumulative sums and the scan's carry in fp32.  The einsums of bf16
    operands return bf16 before the fp32 cast (XLA's
    ``preferred_element_type`` keeps fp32); in fp32 the two agree.
    """
    b, s, h, p = x.shape
    n = bmat.shape[-1]
    q = chunk
    s_orig = s
    if s % q:
        # pad with dt=0 steps: decay exp(0·A)=1, zero input → h untouched
        pad = q - s % q
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        bmat = F.pad(bmat, (0, 0, 0, pad))
        cmat = F.pad(cmat, (0, 0, 0, pad))
        s = s + pad
    nc = s // q
    wide = intra_dtype or x.dtype  # big-tensor dtype (bf16 at scale)
    f32 = torch.float32
    a = -torch.exp(a_log)  # (H,) negative
    loga = dt.to(f32) * a  # (B, S, H) log decay per step

    xc = x.reshape(b, nc, q, h, p).to(wide)
    dtc = dt.reshape(b, nc, q, h)  # fp32 (from softplus)
    bc = bmat.reshape(b, nc, q, n).to(wide)
    cc = cmat.reshape(b, nc, q, n).to(wide)
    cum = torch.cumsum(loga.reshape(b, nc, q, h), dim=2)  # inclusive, fp32

    # --- intra-chunk (quadratic within the chunk) ---------------------
    g = torch.einsum("bcin,bcjn->bcij", cc, bc).to(f32)  # (B, nc, Q, Q)
    seg = cum[:, :, :, None, :] - cum[:, :, None, :, :]  # (B,nc,Qi,Qj,H)
    li = torch.ones((q, q), dtype=torch.bool, device=x.device).tril()
    decay = torch.exp(seg.masked_fill(~li[None, None, :, :, None],
                                      float("-inf"))).to(wide)
    m = g.to(wide)[..., None] * decay  # (B, nc, Qi, Qj, H)
    xdt = xc * dtc[..., None].to(wide)
    y_intra = torch.einsum("bcijh,bcjhp->bcihp", m, xdt).to(f32)

    # --- chunk states + inter-chunk scan (``scan``) ---------------------
    # The three-operand einsums are written as two steps each, in an
    # order that never forms a (B, nc, Q, H, P, N) intermediate.
    decay_to_end = torch.exp(cum[:, :, -1:, :] - cum).to(wide)
    states = torch.einsum("bcjhp,bcjn->bchpn",
                          xdt * decay_to_end[..., None], bc)
    chunk_decay = torch.exp(cum[:, :, -1, :]).contiguous()  # (B, nc, H)
    h_prevs, h_last = (scan or ops.ssd_scan)(states.to(wide).contiguous(),
                                             chunk_decay)

    y_inter = (torch.einsum("bcin,bchpn->bcihp", cc, h_prevs)
               * torch.exp(cum).to(wide)[..., None]).to(f32)
    y = (y_intra + y_inter).reshape(b, s, h, p)
    return y[:, :s_orig], h_last


def _head_range(heads, n_heads):
    return (0, n_heads) if heads is None else (heads.start, heads.stop)


def head_channels(t, heads, *, d_inner, head_dim):
    """The conv channels of ``heads`` (a range of the layer's heads; all
    for ``None``) along t's last dim (conv_dim = d_in + 2N): their x
    channels, then the B and C channels every head shares."""
    h0, h1 = _head_range(heads, d_inner // head_dim)
    if (h0, h1) == (0, d_inner // head_dim):
        return t
    return torch.cat([t[..., h0 * head_dim:h1 * head_dim],
                      t[..., d_inner:]], dim=-1)


def _split_heads(zxbcdt, heads, d_inner, ssm_state, head_dim):
    """(z, x, B|C, dt) of ``heads`` from a whole in_proj output."""
    h0, h1 = _head_range(heads, d_inner // head_dim)
    x0, x1 = h0 * head_dim, h1 * head_dim
    dt0 = 2 * d_inner + 2 * ssm_state
    return (zxbcdt[..., x0:x1], zxbcdt[..., d_inner + x0:d_inner + x1],
            zxbcdt[..., 2 * d_inner:dt0], zxbcdt[..., dt0 + h0:dt0 + h1])


def ssm_mix(params, zxbcdt, *, d_inner, ssm_state, head_dim, chunk,
            heads=None, intra_dtype=None, scan=None):
    """The mixer between the two projections on ``heads`` (a range of
    the layer's H heads; all for ``None``): from the whole in_proj
    output zxbcdt (B, S, 2·d_in + 2N + H), the causal conv over the
    heads' x channels and the shared B, C, the SSD core (``scan`` as in
    :func:`ssd_chunked`), the D skip and the z gate → (y (B, S,
    |heads|·P) before the gated norm, the final state (B, |heads|, P, N)
    fp32).  Every step is per head or per channel, so a model shard
    runs its own heads from the layer's replicated conv weights, A_log,
    D and dt_bias."""
    b, s, _ = zxbcdt.shape
    h0, h1 = _head_range(heads, d_inner // head_dim)
    z, x, bc, dt = _split_heads(zxbcdt, heads, d_inner, ssm_state, head_dim)
    kw = dict(heads=heads, d_inner=d_inner, head_dim=head_dim)
    xbc = _causal_conv(torch.cat([x, bc], dim=-1),
                       head_channels(params["conv_w"], **kw),
                       head_channels(params["conv_b"], **kw))
    nx = x.shape[-1]
    x, bmat, cmat = (xbc[..., :nx], xbc[..., nx:nx + ssm_state],
                     xbc[..., nx + ssm_state:])
    dt = softplus(dt.to(torch.float32) + params["dt_bias"][h0:h1])
    xh = x.reshape(b, s, h1 - h0, head_dim)
    y, h_last = ssd_chunked(xh, dt, params["A_log"][h0:h1], bmat, cmat,
                            chunk=chunk, intra_dtype=intra_dtype, scan=scan)
    y = y.to(zxbcdt.dtype) + (params["D"][h0:h1].to(zxbcdt.dtype)
                              [None, None, :, None] * xh)
    return y.reshape(b, s, nx) * F.silu(z), h_last


def ssm_forward(params, hidden, *, expand, ssm_state, head_dim, conv_kernel,
                chunk, return_state=False, intra_dtype=None,
                scan=None):
    """Full Mamba-2 mixer. hidden: (B, S, d); ``scan`` as in
    :func:`ssd_chunked`."""
    d_inner = expand * hidden.shape[-1]
    y, h_last = ssm_mix(params, hidden @ params["in_proj"], d_inner=d_inner,
                        ssm_state=ssm_state, head_dim=head_dim, chunk=chunk,
                        intra_dtype=intra_dtype, scan=scan)
    y = rmsnorm(y, params["norm_g"])
    out = y @ params["out_proj"]
    if return_state:
        return out, h_last
    return out


# ----------------------------------------------------------------------
# O(1) decode recurrence
# ----------------------------------------------------------------------

def ssm_cache_init(batch, d_model, *, expand, ssm_state, head_dim,
                   conv_kernel, dtype, device):
    d_inner, n_heads, conv_dim = ssm_dims(d_model, expand, ssm_state,
                                          head_dim)
    return {
        "conv": torch.zeros((batch, conv_kernel - 1, conv_dim), dtype=dtype,
                            device=device),
        "ssm": torch.zeros((batch, n_heads, head_dim, ssm_state),
                           dtype=torch.float32, device=device),
    }


def ssm_mix_step(params, zxbcdt, conv, state, *, d_inner, ssm_state,
                 head_dim, heads=None):
    """One decode step of the mixer on ``heads`` (as :func:`ssm_mix`):
    zxbcdt (B, 2·d_in + 2N + H) whole, ``conv`` the ring of the heads'
    conv channels (B, K−1, |heads|·P + 2N), ``state`` their (B, |heads|,
    P, N) fp32 → (y (B, |heads|·P) before the gated norm, the new ring,
    the new state)."""
    b = zxbcdt.shape[0]
    h0, h1 = _head_range(heads, d_inner // head_dim)
    z, x, bc, dt = _split_heads(zxbcdt, heads, d_inner, ssm_state, head_dim)
    kw = dict(heads=heads, d_inner=d_inner, head_dim=head_dim)
    window = torch.cat([conv, torch.cat([x, bc], dim=-1)[:, None]],
                       dim=1)  # (B, K, C)
    conv_out = torch.einsum("bkc,kc->bc", window,
                            head_channels(params["conv_w"], **kw))
    xbc = F.silu(conv_out + head_channels(params["conv_b"], **kw))
    nx = x.shape[-1]
    x, bmat, cmat = (xbc[:, :nx], xbc[:, nx:nx + ssm_state],
                     xbc[:, nx + ssm_state:])
    dt = softplus(dt.to(torch.float32) + params["dt_bias"][h0:h1])  # (B, H)
    a = torch.exp(-torch.exp(params["A_log"][h0:h1]) * dt)  # (B, H)
    xh = x.reshape(b, h1 - h0, head_dim).to(torch.float32)
    upd = (dt[..., None] * xh)[..., None] * bmat[:, None, None, :]
    h_new = state * a[..., None, None] + upd  # (B, H, P, N)
    y = torch.einsum("bhpn,bn->bhp", h_new, cmat.to(torch.float32))
    y = y + params["D"][h0:h1][None, :, None] * xh
    y = y.reshape(b, nx).to(zxbcdt.dtype)
    return y * F.silu(z), window[:, 1:], h_new


def ssm_decode_step(params, hidden, cache, *, expand, ssm_state, head_dim,
                    conv_kernel):
    """hidden: (B, 1, d) → (out (B, 1, d), new cache)."""
    d_inner = expand * hidden.shape[-1]
    y, conv, h_new = ssm_mix_step(
        params, hidden[:, 0] @ params["in_proj"], cache["conv"],
        cache["ssm"], d_inner=d_inner, ssm_state=ssm_state,
        head_dim=head_dim)
    y = rmsnorm(y, params["norm_g"])
    out = (y @ params["out_proj"])[:, None]
    return out, {"conv": conv, "ssm": h_new}

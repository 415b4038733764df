"""LM serving on one card: batched prefill + greedy decode
(the port of ``repro/launch/serve_lm.py``).

    python -m repro_torch.launch.serve_lm --arch zamba2-2.7b \\
        --batch 4 --prompt-len 2048 --new-tokens 32

builds the model on the card from the reference's seeded init (the
JAX package's weights for ``--seed``), makes the prompts from a seeded numpy generator,
warms prefill and decode up off the clock, then times one prefill and
``new_tokens − 1`` decode steps (the first new token falls out of
prefill) and prints prefill ms, decode ms per step, tok/s and the
kernels' launch counts.  A vlm request (``--arch paligemma-3b``)
carries its ``prefix_tokens`` patch embeddings, drawn as the
reference's launcher draws them (normal × 0.2 in the parameter dtype,
from the prompts' generator), and its cache counts them (prefix +
prompt + new positions).  The audio encoder (hubert-xlarge) has no
decode path: the launcher exits for it, as the reference's does.  On a
machine without a card:

    PYTHONPATH=src python -m repro_torch.launch.serve_lm \\
        --arch zamba2-2.7b --reduced --device cpu

(the kernels' plain versions; times are the CPU's, not the card's).
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.device import resolve_device
from repro_torch.kernels import ops
from repro_torch.models import build_model, param_count


def make_request(cfg, batch: int, prompt_len: int, seed: int, device):
    """The prefill batch: ``tokens`` (B, prompt_len) from a numpy
    generator seeded with ``seed``, and for the vlm ``patches`` (B,
    prefix_tokens, frontend_dim), normal × 0.2 from the same generator
    after the tokens, in the parameter dtype."""
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, (batch, prompt_len))
    out = {"tokens": torch.from_numpy(tokens).to(device)}
    if cfg.family == "vlm":
        patches = rng.normal(size=(batch, cfg.prefix_tokens,
                                   cfg.frontend_dim)) * 0.2
        out["patches"] = torch.from_numpy(patches).to(
            device=device, dtype=cfg.param_dtype)
    return out


def cache_len(cfg, prompt_len: int, new_tokens: int) -> int:
    """Positions a request's cache holds: its prompt, its new tokens
    and, for the vlm, its prefix (ROADMAP D11: the reference's launcher
    leaves the prefix out, and its decode overwrites the last prompt
    position)."""
    return cfg.prefix_tokens * (cfg.family == "vlm") + prompt_len \
        + new_tokens


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def generate(model, params, request, new_tokens: int):
    """Greedy: prefill ``request`` (``make_request``'s batch), then
    ``new_tokens − 1`` decode steps.  Returns (generated tokens (B,
    new_tokens), prefill logits, per-phase host times in ms and the
    kernels' launches in each phase)."""
    device = request["tokens"].device
    max_seq = cache_len(model.config, request["tokens"].shape[1], new_tokens)
    c0 = ops.launch_counts()
    t0 = time.perf_counter()
    logits, cache = model.prefill(params, request, max_seq)
    tok = logits[:, -1].argmax(-1)[:, None]
    _sync(device)
    t1 = time.perf_counter()
    c1 = ops.launch_counts()
    out = [tok]
    for _ in range(new_tokens - 1):
        step_logits, cache = model.decode_step(params, tok, cache)
        tok = step_logits[:, -1].argmax(-1)[:, None]
        out.append(tok)
    _sync(device)
    t2 = time.perf_counter()
    c2 = ops.launch_counts()
    counts = {"prefill": {k: c1[k] - c0[k] for k in c0},
              "decode": {k: c2[k] - c1[k] for k in c0}}
    return torch.cat(out, 1), logits, {
        "prefill_ms": (t1 - t0) * 1e3,
        "decode_ms_per_step": (t2 - t1) * 1e3 / max(new_tokens - 1, 1),
        "launches": counts}


def serve(cfg, *, batch: int, prompt_len: int, new_tokens: int, seed: int,
          device=None, params=None) -> dict:
    """Build (unless ``params`` is given), warm up, and time one
    generation; returns the report (and the tokens under "tokens")."""
    if not cfg.supports_decode:
        raise ValueError(f"{cfg.name} is encoder-only: no decode path")
    device = resolve_device(device)
    model = build_model(cfg)
    if params is None:
        params = model.init(seed, device=device)
    request = make_request(cfg, batch, prompt_len, seed, device)
    # Warm-up off the clock: the kernels' first launch builds and loads
    # the library, and cuBLAS picks its algorithms.
    generate(model, params, request, min(new_tokens, 2))
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    generated, _, report = generate(model, params, request, new_tokens)
    n = batch * (new_tokens - 1)
    report.update(
        arch=cfg.name, params=param_count(cfg), batch=batch,
        prompt_len=prompt_len, new_tokens=new_tokens, device=str(device),
        decode_tok_per_s=n / max(report["decode_ms_per_step"]
                                 * (new_tokens - 1) / 1e3, 1e-9),
        tokens=generated.cpu().tolist())
    if device.type == "cuda":
        report["peak_memory_bytes"] = torch.cuda.max_memory_allocated(device)
        report["device_name"] = torch.cuda.get_device_name(device)
    return report


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--arch", default="zamba2-2.7b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=2048)
    ap.add_argument("--new-tokens", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    if args.new_tokens < 1:
        ap.error("--new-tokens must be at least 1")

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if not cfg.supports_decode:
        raise SystemExit(f"{cfg.name} is encoder-only: no decode path")
    print(f"serving {cfg.name} ({param_count(cfg) / 1e6:.1f}M params) on "
          f"{resolve_device(args.device)}")
    report = serve(cfg, batch=args.batch, prompt_len=args.prompt_len,
                   new_tokens=args.new_tokens, seed=args.seed,
                   device=args.device)
    tokens = report.pop("tokens")
    print(f"prefill {args.batch}×{args.prompt_len}: "
          f"{report['prefill_ms']:.1f} ms")
    print(f"decode: {report['decode_ms_per_step']:.2f} ms/step "
          f"({report['decode_tok_per_s']:.0f} tok/s over "
          f"{args.new_tokens - 1} steps)")
    print(f"launches: {report['launches']}")
    print("request 0:", tokens[0])
    print(json.dumps(report))


if __name__ == "__main__":
    main()

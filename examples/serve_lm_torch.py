"""Serve a small LM on the PyTorch/CUDA port: batched prefill and greedy
decode (the twin of ``examples/serve_lm.py``).

Builds the reference's small granite-family decoder (4 layers, d_model
512, 8 heads over 4 KV heads, vocabulary 8192: 21.0M parameters, where
the reference's docstring says ~45M), prefills a batch
of prompts — through K4 on the card — then decodes greedily, through
``launch/serve_lm.py``'s ``serve`` (the paths ``chip_smoke.py`` serves at
full size).  What differs: it runs on the card unless ``--device cpu``;
the model is in fp32 as ``reduced()`` makes it in both packages, and
there is no ``jit``: ``serve`` runs one generation off the clock first
(kernel build, cuBLAS's choices), then times one.  The prompts
(``serve_lm.make_request``: numpy's ``default_rng(seed)`` integers) and
the weights (``model.init(seed)``, the threefry twin of
``PRNGKey(seed)``) are the reference's, both at seed 0.

    PYTHONPATH=src python examples/serve_lm_torch.py --batch 8 \\
        --prompt-len 64 --new-tokens 32
"""
import argparse

from repro_torch.configs import get_config
from repro_torch.device import resolve_device
from repro_torch.launch.serve_lm import serve
from repro_torch.models import param_count


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--new-tokens", type=int, default=32)
    ap.add_argument("--arch", default="granite-3-2b")
    ap.add_argument("--device", default=None,
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    if args.new_tokens < 2:
        ap.error("--new-tokens must be at least 2")

    cfg = get_config(args.arch).reduced(
        num_layers=4, d_model=512, num_heads=8, num_kv_heads=4, head_dim=64,
        d_ff=1536, vocab_size=8192, kv_block=64)
    device = resolve_device(args.device)
    print(f"model: {cfg.name} ({param_count(cfg) / 1e6:.1f}M params) on "
          f"{device}")
    report = serve(cfg, batch=args.batch, prompt_len=args.prompt_len,
                   new_tokens=args.new_tokens, seed=0, device=device)
    n_tok = args.batch * (args.new_tokens - 1)
    prefill_s = report["prefill_ms"] / 1e3
    decode_s = report["decode_ms_per_step"] * (args.new_tokens - 1) / 1e3
    print(f"prefill: {args.batch}×{args.prompt_len} tokens "
          f"in {report['prefill_ms']:.0f} ms "
          f"({args.batch * args.prompt_len / prefill_s:.0f} tok/s)")
    print(f"decode:  {n_tok} tokens in {decode_s * 1e3:.0f} ms "
          f"({n_tok / max(decode_s, 1e-9):.0f} tok/s)")
    print(f"sample continuation (request 0): {report['tokens'][0][:16]}")
    return report


if __name__ == "__main__":
    main()

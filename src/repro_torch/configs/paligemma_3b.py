"""paligemma-3b — VLM: SigLIP patches + Gemma-2B decoder [arXiv:2407.07726]
(a copy of ``repro/configs/paligemma_3b.py``).

Transformer backbone only (assignment carve-out): the SigLIP vision
tower is a stub — ``input_specs`` feeds 256 precomputed patch embeddings
(SigLIP-So400m width 1152) through a learned projector; the language
model is the Gemma-2B decoder (18L, d 2048, 8 heads / kv=1 (MQA),
head_dim 256, d_ff 16384, vocab 257216) with PaliGemma's prefix-LM mask
(bidirectional over image+prompt prefix, causal over the suffix).
"""
from repro_torch.configs.model_config import ModelConfig

CONFIG = ModelConfig(
    name="paligemma-3b",
    family="vlm",
    num_layers=18,
    d_model=2048,
    num_heads=8,
    num_kv_heads=1,
    head_dim=256,
    d_ff=16384,
    vocab_size=257216,
    prefix_tokens=256,  # 224/14 = 16×16 SigLIP patches
    frontend_dim=1152,  # SigLIP-So400m embedding width
    rope_theta=1e4,
    dtype="bfloat16",
    loss_chunk=512,
    source="PaliGemma [arXiv:2407.07726]; SigLIP frontend stubbed",
)

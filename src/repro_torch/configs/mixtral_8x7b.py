"""mixtral-8x7b — MoE, 8 experts top-2, sliding-window attention
[arXiv:2401.04088]
(a copy of ``repro/configs/mixtral_8x7b.py``).

32 layers, d_model 4096, 32 heads (GQA kv=8, head_dim 128), expert
d_ff 14336, vocab 32000, sliding window 4096.  SWA makes ``long_500k``
eligible (O(W) attention per token, ring-buffer KV cache).
"""
from repro_torch.configs.model_config import ModelConfig

CONFIG = ModelConfig(
    name="mixtral-8x7b",
    family="moe",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=32000,
    num_experts=8,
    top_k=2,
    capacity_factor=1.25,
    sliding_window=4096,
    rope_theta=1e6,
    dtype="bfloat16",
    loss_chunk=1024,
    source="Mixtral 8x7B [arXiv:2401.04088]",
)

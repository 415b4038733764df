"""qwen3-moe-235b-a22b — MoE, 128 experts top-8 [hf:Qwen/Qwen3-30B-A3B
family scaled per assignment]
(a copy of ``repro/configs/qwen3_moe_235b_a22b.py``).

94 layers, d_model 4096, 64 heads (GQA kv=4, head_dim 128), expert
d_ff 1536, 128 experts top-8, vocab 151936.
"""
from repro_torch.configs.model_config import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-235b-a22b",
    family="moe",
    num_layers=94,
    d_model=4096,
    num_heads=64,
    num_kv_heads=4,
    head_dim=128,
    d_ff=1536,
    vocab_size=151936,
    num_experts=128,
    top_k=8,
    capacity_factor=1.25,
    rope_theta=1e6,
    dtype="bfloat16",
    loss_chunk=512,
    source="Qwen3-MoE 235B-A22B [hf:Qwen/Qwen3-30B-A3B]",
)

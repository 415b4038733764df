"""moonshot-v1-16b-a3b — MoE decoder (Moonlight)
[hf:moonshotai/Moonlight-16B-A3B]
(a copy of ``repro/configs/moonshot_v1_16b_a3b.py``).

48 layers, d_model 2048, 16 heads (kv=16, head_dim 128), expert d_ff
1408, 64 experts top-6, vocab 163840.  (Moonlight's dense first layer
and shared expert are folded into the uniform MoE stack.)
"""
from repro_torch.configs.model_config import ModelConfig

CONFIG = ModelConfig(
    name="moonshot-v1-16b-a3b",
    family="moe",
    num_layers=48,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    head_dim=128,
    d_ff=1408,
    vocab_size=163840,
    num_experts=64,
    top_k=6,
    capacity_factor=1.25,
    rope_theta=5e4,
    dtype="bfloat16",
    loss_chunk=1024,
    source="Moonlight 16B-A3B [hf:moonshotai/Moonlight-16B-A3B]",
)

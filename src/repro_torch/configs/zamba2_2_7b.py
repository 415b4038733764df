"""zamba2-2.7b — hybrid: Mamba-2 backbone + shared attention block
[arXiv:2411.15242] (a copy of ``repro/configs/zamba2_2_7b.py``).

54 mamba layers (d_model 2560, ssm_state 64) with ONE shared
attention+MLP block (32 heads, kv=32, head_dim 80, d_ff 10240,
parameters re-used at every application) applied after every 6 mamba
layers.  vocab 32000.  The shared attention runs with a 4096 sliding
window.
"""
from repro_torch.configs.model_config import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-2.7b",
    family="hybrid",
    num_layers=54,
    d_model=2560,
    num_heads=32,
    num_kv_heads=32,
    head_dim=80,
    d_ff=10240,
    vocab_size=32000,
    ssm_state=64,
    ssm_head_dim=64,
    expand=2,
    conv_kernel=4,
    chunk=64,
    attn_every=6,
    sliding_window=4096,
    dtype="bfloat16",
    loss_chunk=512,
    source="Zamba2 2.7B [arXiv:2411.15242]",
)

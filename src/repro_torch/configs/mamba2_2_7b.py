"""mamba2-2.7b — attention-free SSM (SSD) [arXiv:2405.21060]
(a copy of ``repro/configs/mamba2_2_7b.py``).

64 layers, d_model 2560 (d_inner 5120 = 2×), ssm_state 128, head dim 64
(80 heads), vocab 50280.  Decode state is O(1) in sequence length.
"""
from repro_torch.configs.model_config import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-2.7b",
    family="ssm",
    num_layers=64,
    d_model=2560,
    num_heads=0,
    num_kv_heads=0,
    head_dim=0,
    d_ff=0,
    vocab_size=50280,
    ssm_state=128,
    ssm_head_dim=64,
    expand=2,
    conv_kernel=4,
    chunk=64,
    dtype="bfloat16",
    loss_chunk=512,
    source="Mamba-2 2.7B, SSD [arXiv:2405.21060]",
)

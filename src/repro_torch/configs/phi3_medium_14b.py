"""phi3-medium-14b — dense decoder, RoPE + SwiGLU + GQA [arXiv:2404.14219]
(a copy of ``repro/configs/phi3_medium_14b.py``).

40 layers, d_model 5120, 40 heads (GQA kv=10, head_dim 128), d_ff 17920,
vocab 100352.
"""
from repro_torch.configs.model_config import ModelConfig

CONFIG = ModelConfig(
    name="phi3-medium-14b",
    family="dense",
    num_layers=40,
    d_model=5120,
    num_heads=40,
    num_kv_heads=10,
    head_dim=128,
    d_ff=17920,
    vocab_size=100352,
    rope_theta=1e4,
    dtype="bfloat16",
    loss_chunk=512,
    source="Phi-3 Medium [arXiv:2404.14219]",
)

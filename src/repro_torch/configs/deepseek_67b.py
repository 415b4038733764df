"""deepseek-67b — dense llama-arch decoder [arXiv:2401.02954]
(a copy of ``repro/configs/deepseek_67b.py``).

95 layers, d_model 8192, 64 heads (GQA kv=8), d_ff 22016, vocab 102400.
134.9 GB of bf16 parameters: more than one 80 GB card holds, so the port
runs it reduced.
"""
from repro_torch.configs.model_config import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-67b",
    family="dense",
    num_layers=95,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=22016,
    vocab_size=102400,
    rope_theta=1e4,
    dtype="bfloat16",
    loss_chunk=512,
    source="DeepSeek LLM 67B [arXiv:2401.02954]",
)

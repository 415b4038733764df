"""granite-3-2b — dense GQA decoder [hf:ibm-granite/granite-3.0-2b-base]
(a copy of ``repro/configs/granite_3_2b.py``).

40 layers, d_model 2048, 32 heads (GQA kv=8, head_dim 64), d_ff 8192,
vocab 49155 (padded to 49408 in the embedding and the head).
"""
from repro_torch.configs.model_config import ModelConfig

CONFIG = ModelConfig(
    name="granite-3-2b",
    family="dense",
    num_layers=40,
    d_model=2048,
    num_heads=32,
    num_kv_heads=8,
    head_dim=64,
    d_ff=8192,
    vocab_size=49155,
    rope_theta=1e4,
    dtype="bfloat16",
    loss_chunk=1024,
    source="Granite 3.0 2B [hf:ibm-granite/granite-3.0-2b-base]",
)

"""hubert-xlarge — encoder-only audio transformer [arXiv:2106.07447]
(a copy of ``repro/configs/hubert_xlarge.py``).

48 layers, d_model 1280, 16 heads (kv=16, head_dim 80), d_ff 5120,
vocab 504 (masked-prediction codebook targets).  The conv waveform
feature extractor is a stub (assignment carve-out): ``input_specs``
provides precomputed 512-dim frame embeddings.  Encoder-only ⇒ no
decode shapes.
"""
from repro_torch.configs.model_config import ModelConfig

CONFIG = ModelConfig(
    name="hubert-xlarge",
    family="audio",
    num_layers=48,
    d_model=1280,
    num_heads=16,
    num_kv_heads=16,
    head_dim=80,
    d_ff=5120,
    vocab_size=504,
    frontend_dim=512,  # wav2vec2/HuBERT conv extractor output width
    encoder_only=True,
    dtype="bfloat16",
    loss_chunk=0,
    source="HuBERT X-Large [arXiv:2106.07447]; conv frontend stubbed",
)

"""The model zoo's configuration dataclass (``repro/models/api.py``).

A copy of the JAX package's ``ModelConfig``: its fields,
``vocab_padded``, ``supports_decode``, ``subquadratic`` and
``reduced()`` exactly as written there.  ``param_dtype`` gives the
torch dtype.
"""
from __future__ import annotations

import dataclasses

import torch

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int
    # moe
    num_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    aux_coef: float = 0.01
    # ssm / hybrid
    ssm_state: int = 0
    ssm_head_dim: int = 64
    expand: int = 2
    conv_kernel: int = 4
    chunk: int = 64
    ssd_intra_dtype: str = "float32"
    attn_every: int = 0
    # attention
    sliding_window: int = 0
    rope_theta: float = 1e4
    kv_block: int = 512
    # modality frontends (stubbed: precomputed embeddings)
    prefix_tokens: int = 0
    frontend_dim: int = 0
    encoder_only: bool = False
    norm_eps: float = 1e-5
    dtype: str = "float32"
    loss_chunk: int = 0
    remat: bool = True
    remat_group: int = 1
    unroll_inner: bool = False
    unroll_layers: bool = False
    source: str = ""  # citation for the assigned architecture

    @property
    def param_dtype(self) -> torch.dtype:
        return _DTYPES[self.dtype]

    @property
    def vocab_padded(self) -> int:
        """Vocab rounded to a 256 multiple; padded logit columns are
        sliced off in serving."""
        return -(-self.vocab_size // 256) * 256

    @property
    def supports_decode(self) -> bool:
        return not self.encoder_only and self.family != "audio"

    @property
    def subquadratic(self) -> bool:
        return self.family in ("ssm", "hybrid") or self.sliding_window > 0

    def reduced(self, **overrides) -> "ModelConfig":
        """Smoke-test variant of the same family (≤2 layers, small dims;
        4 layers in 2 groups for the hybrid)."""
        kw = dict(
            name=self.name + "-smoke",
            num_layers=min(self.num_layers, 2),
            d_model=min(self.d_model, 128),
            num_heads=min(self.num_heads, 4),
            num_kv_heads=min(self.num_kv_heads, 2),
            head_dim=min(self.head_dim, 32),
            d_ff=min(self.d_ff, 256) if self.d_ff else 0,
            vocab_size=min(self.vocab_size, 512),
            num_experts=min(self.num_experts, 4),
            top_k=min(self.top_k, 2),
            capacity_factor=float(max(self.num_experts, 1)),
            ssm_state=min(self.ssm_state, 16),
            ssm_head_dim=min(self.ssm_head_dim, 16),
            chunk=8,
            attn_every=2 if self.attn_every else 0,
            sliding_window=min(self.sliding_window, 16)
            if self.sliding_window else 0,
            prefix_tokens=min(self.prefix_tokens, 4),
            frontend_dim=min(self.frontend_dim, 32)
            if self.frontend_dim else 0,
            kv_block=8,
            loss_chunk=0,
            dtype="float32",
            remat=False,
        )
        if self.family == "hybrid":
            kw["num_layers"] = 4  # 2 groups of 2
        kw.update(overrides)
        return dataclasses.replace(self, **kw)

"""granite-8b — [dense] 36L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=49152; llama-architecture code model (SwiGLU, RMSNorm, RoPE, tied).
[arXiv:2405.04324; hf-verified]
"""

from repro_torch.models.config import ModelConfig

FULL = ModelConfig(
    name="granite-8b",
    family="dense",
    n_layers=36,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=49152,
    activation="swiglu",
    rope_theta=10_000_000.0,
    tie_embeddings=True,
)

SMOKE = FULL.replace(
    n_layers=3,
    d_model=64,
    n_heads=4,
    n_kv_heads=1,
    head_dim=16,
    d_ff=192,
    vocab_size=512,
    dtype="float32",
    param_dtype="float32",
)

"""command-r-plus-104b — [dense] 64L d_model=12288 96H (GQA kv=8)
d_ff=33792 vocab=256000; parallel attention+FFN blocks (single input norm),
no biases, tied embeddings, LayerNorm.
[hf:CohereForAI/c4ai-command-r-v01; unverified-tier]
"""

from repro_torch.models.config import ModelConfig

FULL = ModelConfig(
    name="command-r-plus-104b",
    family="dense",
    n_layers=64,
    d_model=12288,
    n_heads=96,
    n_kv_heads=8,
    head_dim=128,
    d_ff=33792,
    vocab_size=256000,
    parallel_block=True,
    norm_type="layernorm",
    norm_eps=1e-5,
    activation="swiglu",
    rope_theta=75_000_000.0,
    tie_embeddings=True,
)

SMOKE = FULL.replace(
    n_layers=2,
    d_model=64,
    n_heads=8,
    n_kv_heads=2,
    head_dim=8,
    d_ff=192,
    vocab_size=512,
    dtype="float32",
    param_dtype="float32",
)

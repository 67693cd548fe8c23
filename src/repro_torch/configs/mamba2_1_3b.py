"""mamba2-1.3b — [ssm] 48L d_model=2048 attn-free d_ff=0 vocab=50280,
ssm_state=128; SSD (state-space duality) chunked evaluation.
[arXiv:2405.21060; unverified-tier]

d_inner = 2*2048 = 4096, head_dim 64 -> 64 SSD heads; single B/C group.
The mixer IS the whole layer (no FFN).
"""

from repro_torch.models.config import ModelConfig

FULL = ModelConfig(
    name="mamba2-1.3b",
    family="ssm",
    n_layers=48,
    d_model=2048,
    n_heads=1,       # unused (attention-free)
    n_kv_heads=1,
    d_ff=0,
    vocab_size=50280,
    ssm_state=128,
    ssm_expand=2,
    ssm_head_dim=64,
    ssm_conv_kernel=4,
    ssm_chunk=256,
    tie_embeddings=True,
)

SMOKE = FULL.replace(
    n_layers=4,
    d_model=64,
    vocab_size=512,
    ssm_state=16,
    ssm_head_dim=16,
    ssm_chunk=8,
    dtype="float32",
    param_dtype="float32",
)

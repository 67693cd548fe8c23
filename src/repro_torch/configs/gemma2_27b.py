"""gemma2-27b — [dense] 46L d_model=4608 32H (GQA kv=16) d_ff=36864
vocab=256000; local(4096)/global alternating, attn logit softcap 50, final
logit softcap 30, sandwich RMS norms with (1+w) scaling, GeGLU, scaled
embeddings. [arXiv:2408.00118; hf-verified]
"""

from repro_torch.models.config import ModelConfig

FULL = ModelConfig(
    name="gemma2-27b",
    family="dense",
    n_layers=46,
    d_model=4608,
    n_heads=32,
    n_kv_heads=16,
    head_dim=128,
    d_ff=36864,
    vocab_size=256000,
    activation="geglu",
    local_global_alternating=True,
    sliding_window=4096,
    attn_logit_softcap=50.0,
    final_logit_softcap=30.0,
    post_sublayer_norm=True,
    rms_one_offset=True,
    embed_scale=True,
    tie_embeddings=True,
)

SMOKE = FULL.replace(
    n_layers=4,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    head_dim=16,
    d_ff=256,
    vocab_size=512,
    sliding_window=16,
    dtype="float32",
    param_dtype="float32",
)

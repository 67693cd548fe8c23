"""qwen3-14b — [dense] 40L d_model=5120 40H (GQA kv=8) d_ff=17408
vocab=151936; per-head RMS qk-norm, head_dim=128, untied embeddings.
[hf:Qwen/Qwen3-8B family; hf-verified]

40 heads / 8 kv heads are NOT divisible by the 16-way model axis — this arch
exercises the sequence-parallel attention fallback (DESIGN.md §5).
"""

from repro_torch.models.config import ModelConfig

FULL = ModelConfig(
    name="qwen3-14b",
    family="dense",
    n_layers=40,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    head_dim=128,
    d_ff=17408,
    vocab_size=151936,
    qk_norm=True,
    rope_theta=1_000_000.0,
    tie_embeddings=False,
)

SMOKE = FULL.replace(
    n_layers=2,
    d_model=80,
    n_heads=5,
    n_kv_heads=1,
    head_dim=16,
    d_ff=192,
    vocab_size=512,
    dtype="float32",
    param_dtype="float32",
)

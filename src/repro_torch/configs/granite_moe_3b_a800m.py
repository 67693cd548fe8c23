"""granite-moe-3b-a800m — [moe] 32L d_model=1536 24H (GQA kv=8) d_ff=512
(per routed expert) vocab=49155, MoE 40e top-8.
[hf:ibm-granite/granite-3.0-1b-a400m-base; hf-verified]

Notes: head_dim = 1536/24 = 64; no shared experts; every layer is MoE.
24 heads / 8 kv heads are NOT divisible by the 16-way model axis — this arch
exercises the sequence-parallel attention fallback (DESIGN.md §5).
"""

from repro_torch.models.config import ModelConfig

FULL = ModelConfig(
    name="granite-moe-3b-a800m",
    family="moe",
    n_layers=32,
    d_model=1536,
    n_heads=24,
    n_kv_heads=8,
    head_dim=64,
    d_ff=512,
    vocab_size=49155,
    n_experts=40,
    top_k=8,
    moe_d_ff=512,
    tie_embeddings=True,
)

SMOKE = FULL.replace(
    n_layers=2,
    d_model=96,
    n_heads=6,
    n_kv_heads=2,
    head_dim=16,
    d_ff=64,
    vocab_size=512,
    n_experts=8,
    top_k=4,
    moe_d_ff=64,
    dtype="float32",
    param_dtype="float32",
)

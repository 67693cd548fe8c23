"""jamba-v0.1-52b — [hybrid] 32L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=65536, MoE 16e top-2; Mamba+attention 1:7 interleave (attention every
8th layer, offset 4), MoE every 2nd layer (offset 1).
[arXiv:2403.19887; hf-verified]

Backbone notes: Jamba v0.1 uses Mamba-1 mixers (d_state=16, d_conv=4,
expand=2); this framework implements the Mamba-2/SSD formulation — same
state dimension and interface, chunked-dual evaluation on TPU (DESIGN.md §2
hardware-adaptation). Recorded as an adapted assumption.
"""

from repro_torch.models.config import ModelConfig

FULL = ModelConfig(
    name="jamba-v0.1-52b",
    family="hybrid",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=65536,
    attn_layer_period=8,
    attn_layer_offset=4,
    n_experts=16,
    top_k=2,
    moe_layer_period=2,
    moe_layer_offset=1,
    moe_d_ff=14336,
    ssm_state=16,
    ssm_expand=2,
    ssm_head_dim=64,
    ssm_conv_kernel=4,
    ssm_chunk=256,
    tie_embeddings=False,
)

SMOKE = FULL.replace(
    n_layers=8,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    head_dim=16,
    d_ff=128,
    vocab_size=512,
    n_experts=4,
    top_k=2,
    moe_d_ff=128,
    ssm_state=8,
    ssm_head_dim=16,
    ssm_chunk=8,
    dtype="float32",
    param_dtype="float32",
)

"""qwen2-moe-a2.7b — [moe] 24L d_model=2048 16H (GQA kv=16) d_ff=1408
vocab=151936, MoE 60e top-4, 4 shared experts.
[hf:Qwen/Qwen1.5-MoE-A2.7B; hf-verified]

Notes: per-expert hidden 1408; the 4 shared experts form one fused shared
MLP of hidden 4x1408 = 5632 with a sigmoid gate (HF ``shared_expert`` +
``shared_expert_gate``); ``norm_topk_prob=False`` (top-k softmax weights are
not renormalised).
"""

from repro_torch.models.config import ModelConfig

FULL = ModelConfig(
    name="qwen2-moe-a2.7b",
    family="moe",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    head_dim=128,
    d_ff=1408,
    vocab_size=151936,
    n_experts=60,
    top_k=4,
    n_shared_experts=4,
    moe_d_ff=1408,
    shared_d_ff=5632,
    moe_norm_topk=False,
    rope_theta=1_000_000.0,
    tie_embeddings=False,
)

SMOKE = FULL.replace(
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    head_dim=16,
    d_ff=96,
    vocab_size=512,
    n_experts=8,
    top_k=4,
    moe_d_ff=96,
    shared_d_ff=192,
    dtype="float32",
    param_dtype="float32",
)

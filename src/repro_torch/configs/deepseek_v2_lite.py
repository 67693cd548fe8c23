"""deepseek-v2-lite — [moe] 27L d_model=2048 16H, multi-head latent
attention (kv_lora_rank 512, no q compression, qk 128 + rope 64, v 128),
YaRN rope (factor 40 over 4096, beta 32/1, mscale 0.707), one leading
dense layer of 10944, then 26 MoE layers of 64 experts of 1408, top-6
softmax greedy routing without renormalisation, 2 ungated shared experts,
vocab 102400, untied.
[hf:deepseek-ai/DeepSeek-V2-Lite config.json; arXiv:2405.04434]

Notes: the two shared experts form one ungated MLP of 2 x 1408 = 2816.
The gather dispatch's capacity factor is n_experts / top_k, so a group's
capacity is every one of its tokens and no token is dropped. The port's
own arch: the reference has no latent attention.
"""

from repro_torch.models.config import ModelConfig

FULL = ModelConfig(
    name="deepseek-v2-lite",
    family="moe",
    n_layers=27,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    head_dim=192,
    d_ff=10944,
    vocab_size=102400,
    kv_lora_rank=512,
    qk_nope_head_dim=128,
    qk_rope_head_dim=64,
    v_head_dim=128,
    first_k_dense_replace=1,
    rope_theta=10000.0,
    rope_factor=40.0,
    rope_original_max_position=4096,
    rope_beta_fast=32.0,
    rope_beta_slow=1.0,
    rope_mscale=0.707,
    rope_mscale_all_dim=0.707,
    n_experts=64,
    top_k=6,
    n_shared_experts=2,
    moe_d_ff=1408,
    shared_d_ff=2816,
    moe_norm_topk=False,
    moe_shared_gate=False,
    moe_capacity_factor=64 / 6,
    norm_eps=1e-6,
    tie_embeddings=False,
)

SMOKE = FULL.replace(
    n_layers=3,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    head_dim=24,
    d_ff=96,
    vocab_size=512,
    kv_lora_rank=32,
    qk_nope_head_dim=16,
    qk_rope_head_dim=8,
    v_head_dim=16,
    rope_original_max_position=64,
    n_experts=8,
    top_k=3,
    moe_d_ff=32,
    shared_d_ff=64,
    moe_capacity_factor=8 / 3,
    dtype="float32",
    param_dtype="float32",
)

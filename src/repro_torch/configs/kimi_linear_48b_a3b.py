"""kimi-linear-48b-a3b — [hybrid moe] 27L d_model=2304: Kimi Delta
Attention (a gated delta rule with a decay per key channel; 32 heads of
128, short convolutions of width 4, decay and output-gate projections of
rank 128) in layers 1–3, 5–7, …, 25–26, and multi-head latent attention
without rope (NoPE; 32 heads, kv_lora_rank 512, qk 128 + 64, v 128, no q
compression) in layers 4, 8, …, 24 and 27; layer 1 a dense MLP of 9216,
every later layer 256 experts of 1024, top-8 by sigmoid scores
renormalised and scaled by 2.446, one ungated shared expert; vocab 163840,
untied, RMS eps 1e-5.
[hf:moonshotai/Kimi-Linear-48B-A3B-Instruct config.json; arXiv:2510.26692]

The stack is one leading KDA layer with the dense MLP, six units [KDA,
KDA, MLA, KDA] (layers 2–25) and the tail [KDA, MLA] (layers 26–27).
``ONE_CARD`` is what one card holds in the benchmark's deployment: the
lead and two units (layers 1–9, every kind in its published ratio) and
experts 0–31 of each layer's 256, as each layer's experts are divided over
8 cards (EP8); every width, head and the router's 256 outputs are as
published. The gather dispatch's capacity factor is n_experts / top_k, so
a group's capacity is every one of its tokens and no token is dropped. The
router's selection bias (``e_score_correction_bias``) is taken as zero.
The port's own arch: the reference has neither KDA nor latent attention.
"""

from repro_torch.models.config import LayerKind, ModelConfig

KDA, MLA = LayerKind.KDA, LayerKind.ATTN

FULL = ModelConfig(
    name="kimi-linear-48b-a3b",
    family="hybrid",
    n_layers=27,
    d_model=2304,
    n_heads=32,
    n_kv_heads=32,
    head_dim=192,
    d_ff=9216,
    vocab_size=163840,
    kv_lora_rank=512,
    qk_nope_head_dim=128,
    qk_rope_head_dim=64,
    v_head_dim=128,
    mla_rope=False,
    first_k_dense_replace=1,
    lead_kind=KDA,
    unit_kinds=(KDA, KDA, MLA, KDA),
    tail_kinds=(KDA, MLA),
    kda_heads=32,
    kda_head_dim=128,
    kda_conv_kernel=4,
    kda_gate_rank=128,
    kda_chunk=64,
    rope_theta=10000.0,
    n_experts=256,
    top_k=8,
    n_shared_experts=1,
    moe_d_ff=1024,
    shared_d_ff=1024,
    moe_norm_topk=True,
    moe_shared_gate=False,
    moe_router="sigmoid",
    moe_routed_scale=2.446,
    moe_capacity_factor=256 / 8,
    norm_eps=1e-5,
    tie_embeddings=False,
)

#: one card's share of the benchmark's deployment: layers 1–9, experts 0–31
ONE_CARD = FULL.replace(n_layers=9, tail_kinds=(), experts_held=(0, 32))

SMOKE = FULL.replace(
    n_layers=7,
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
    kda_heads=4,
    kda_head_dim=16,
    kda_gate_rank=8,
    kda_chunk=32,
    n_experts=16,
    top_k=4,
    moe_d_ff=32,
    shared_d_ff=32,
    moe_capacity_factor=16 / 4,
    experts_held=(4, 12),
    dtype="float32",
    param_dtype="float32",
)

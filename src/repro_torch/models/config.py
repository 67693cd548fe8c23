"""Unified model configuration covering all assigned architecture families
(a copy of the reference's ``models/config.py``; the latent-attention,
YaRN, leading-dense and ungated-shared-expert fields are the port's own,
and their defaults leave every other configuration as the reference's).

One ``ModelConfig`` drives dense, MoE, hybrid (attention+Mamba interleave),
SSM-only and encoder-decoder stacks. Layer heterogeneity is expressed as a
repeating *pattern unit*: the stack is a loop over identical units whose
parameters are stacked along a leading ``layers`` axis.
"""

from __future__ import annotations

import dataclasses
import enum
from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple


class LayerKind(str, enum.Enum):
    ATTN = "attn"                # attention + (dense | moe) FFN
    ATTN_LOCAL = "attn_local"    # sliding-window attention + FFN
    MAMBA = "mamba"              # Mamba-2 SSD mixer (+ optional MoE FFN)


class FFNKind(str, enum.Enum):
    DENSE = "dense"
    MOE = "moe"


@dataclass(frozen=True)
class SublayerSpec:
    """One sublayer inside the repeating pattern unit."""

    kind: LayerKind
    ffn: FFNKind


@dataclass(frozen=True)
class ModelConfig:
    # -- identity -----------------------------------------------------------
    name: str = "model"
    family: str = "dense"        # dense | moe | hybrid | ssm | vlm | audio

    # -- core dims ----------------------------------------------------------
    n_layers: int = 12
    d_model: int = 1024
    n_heads: int = 8
    n_kv_heads: int = 8
    head_dim: Optional[int] = None       # default d_model // n_heads
    d_ff: int = 4096
    vocab_size: int = 32000

    # -- attention ----------------------------------------------------------
    qk_norm: bool = False                # qwen3-style RMS norm on q/k heads
    attn_logit_softcap: Optional[float] = None   # gemma2: 50.0
    final_logit_softcap: Optional[float] = None  # gemma2: 30.0
    sliding_window: Optional[int] = None  # window for ATTN_LOCAL sublayers
    local_global_alternating: bool = False  # gemma2: unit = [local, global]
    rope_theta: float = 10000.0
    # YaRN rope scaling (DeepSeek-V2); a factor of 1 is plain rope
    rope_factor: float = 1.0
    rope_original_max_position: int = 4096
    rope_beta_fast: float = 32.0
    rope_beta_slow: float = 1.0
    rope_mscale: float = 1.0
    rope_mscale_all_dim: float = 0.0
    attn_bias: bool = False
    parallel_block: bool = False         # command-r: attn and FFN in parallel

    # -- multi-head latent attention (DeepSeek-V2; kv_lora_rank 0: none) -----
    kv_lora_rank: int = 0                # latent width c cached per token
    qk_nope_head_dim: int = 0            # per-head query/key width without rope
    qk_rope_head_dim: int = 0            # rope width; the rope key is shared by all heads
    v_head_dim: int = 0
    first_k_dense_replace: int = 0       # leading dense layers before the units

    # -- FFN / MoE ----------------------------------------------------------
    activation: str = "swiglu"           # swiglu | geglu | gelu
    n_experts: int = 0
    top_k: int = 0
    n_shared_experts: int = 0            # qwen2-moe: shared experts
    moe_d_ff: Optional[int] = None       # per-expert hidden (defaults d_ff)
    shared_d_ff: Optional[int] = None    # shared-expert hidden
    moe_layer_period: int = 1            # MoE every k-th sublayer
    moe_layer_offset: int = 0
    moe_norm_topk: bool = True           # renormalise top-k weights
    moe_shared_gate: bool = True         # sigmoid gate on the shared experts
    moe_capacity_factor: float = 1.25    # gather-dispatch capacity factor
    router_aux_loss_coef: float = 0.001

    # -- Mamba-2 (SSD) -------------------------------------------------------
    attn_layer_period: int = 0           # jamba: attention every k-th layer
    attn_layer_offset: int = 0
    ssm_state: int = 128
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_conv_kernel: int = 4
    ssm_chunk: int = 256                 # SSD chunk length
    ssm_groups: int = 1                  # B/C groups (like GQA for SSM)

    # -- encoder-decoder -----------------------------------------------------
    is_encoder_decoder: bool = False
    n_encoder_layers: int = 0
    encoder_seq: int = 1500              # whisper frame positions (stub)

    # -- norm / embedding ----------------------------------------------------
    norm_type: str = "rmsnorm"           # rmsnorm | layernorm
    norm_eps: float = 1e-6
    post_sublayer_norm: bool = False     # gemma2 sandwich norms
    embed_scale: bool = False            # gemma2: x *= sqrt(d_model)
    tie_embeddings: bool = True
    rms_one_offset: bool = False         # gemma2: weight applied as (1 + w)

    # -- frontend stubs ------------------------------------------------------
    frontend: str = "none"               # none | vision_stub | audio_stub

    # -- numerics ------------------------------------------------------------
    dtype: str = "bfloat16"              # activation/param compute dtype
    param_dtype: str = "bfloat16"

    # -------------------------------------------------------------- derived -
    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim if self.head_dim is not None else self.d_model // self.n_heads

    @property
    def q_per_kv(self) -> int:
        assert self.n_heads % max(self.n_kv_heads, 1) == 0
        return self.n_heads // self.n_kv_heads

    @property
    def is_mla(self) -> bool:
        return self.kv_lora_rank > 0

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        assert self.d_inner % self.ssm_head_dim == 0
        return self.d_inner // self.ssm_head_dim

    @property
    def resolved_moe_d_ff(self) -> int:
        return self.moe_d_ff if self.moe_d_ff is not None else self.d_ff

    @property
    def resolved_shared_d_ff(self) -> int:
        if self.shared_d_ff is not None:
            return self.shared_d_ff
        return self.resolved_moe_d_ff * max(self.n_shared_experts, 1)

    # ------------------------------------------------------- pattern logic -
    def pattern_unit(self) -> List[SublayerSpec]:
        """The repeating sublayer unit; ``len(unit)`` divides the layers
        after the ``first_k_dense_replace`` leading dense ones."""
        unit_len = self._unit_len()
        specs: List[SublayerSpec] = []
        for pos in range(unit_len):
            specs.append(self._sublayer_at(pos))
        return specs

    def _unit_len(self) -> int:
        candidates = [1]
        if self.local_global_alternating:
            candidates.append(2)
        if self.attn_layer_period > 1:
            candidates.append(self.attn_layer_period)
        if self.is_moe and self.moe_layer_period > 1:
            candidates.append(self.moe_layer_period)
        unit = 1
        for c in candidates:
            unit = _lcm(unit, c)
        if (self.n_layers - self.first_k_dense_replace) % unit != 0:
            raise ValueError(
                f"{self.name}: n_layers={self.n_layers} less "
                f"{self.first_k_dense_replace} leading dense not divisible by "
                f"pattern unit {unit}"
            )
        return unit

    def _sublayer_at(self, pos: int) -> SublayerSpec:
        # mixer kind
        if self.attn_layer_period > 1:  # hybrid: attention every k-th layer
            kind = (
                LayerKind.ATTN
                if pos % self.attn_layer_period == self.attn_layer_offset
                else LayerKind.MAMBA
            )
        elif self.family == "ssm":
            kind = LayerKind.MAMBA
        elif self.local_global_alternating:
            kind = LayerKind.ATTN_LOCAL if pos % 2 == 0 else LayerKind.ATTN
        elif self.sliding_window is not None:
            kind = LayerKind.ATTN_LOCAL
        else:
            kind = LayerKind.ATTN
        # ffn kind
        if self.is_moe and pos % max(self.moe_layer_period, 1) == self.moe_layer_offset:
            ffn = FFNKind.MOE
        else:
            ffn = FFNKind.DENSE
        return SublayerSpec(kind=kind, ffn=ffn)

    @property
    def n_units(self) -> int:
        return (self.n_layers - self.first_k_dense_replace) // self._unit_len()

    def replace(self, **kwargs) -> "ModelConfig":
        return dataclasses.replace(self, **kwargs)

    def validate(self) -> None:
        assert self.n_heads % max(self.n_kv_heads, 1) == 0
        if self.family != "ssm":
            assert self.n_heads > 0 and self.d_model > 0
        self.pattern_unit()  # raises if inconsistent


def _lcm(a: int, b: int) -> int:
    import math

    return a * b // math.gcd(a, b)

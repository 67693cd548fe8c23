"""Unified model configuration covering all assigned architecture families
(a copy of the reference's ``models/config.py``; the latent-attention,
YaRN, leading-dense, ungated-shared-expert, Kimi Delta Attention, lead and
tail, sigmoid-router and held-expert fields are the port's own, and their
defaults leave every other configuration as the reference's).

One ``ModelConfig`` drives dense, MoE, hybrid (attention+Mamba interleave),
SSM-only and encoder-decoder stacks. Layer heterogeneity is expressed as a
repeating *pattern unit*: the stack is a loop over identical units whose
parameters are stacked along a leading ``layers`` axis. Around the units a
stack may have ``first_k_dense_replace`` leading layers with a dense FFN
(mixer ``lead_kind``) and a *tail* of layers after the last whole unit
(``tail_kinds``): Kimi-Linear is one KDA layer, six units [KDA, KDA, MLA,
KDA] and the tail [KDA, MLA].
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
    KDA = "kda"                  # Kimi Delta Attention: gated delta rule (+ FFN)


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
    mla_rope: bool = True                # False: the rope channels stay unrotated (NoPE)

    # -- stack around the units (the port's own) ------------------------------
    lead_kind: LayerKind = LayerKind.ATTN  # mixer of the leading dense layers
    unit_kinds: Tuple[LayerKind, ...] = ()  # the unit's mixers; () derives them
    tail_kinds: Tuple[LayerKind, ...] = ()  # mixers of the layers after the units

    # -- Kimi Delta Attention (KDA layers) ------------------------------------
    kda_heads: int = 0
    kda_head_dim: int = 128              # d_k = d_v per head
    kda_conv_kernel: int = 4             # short causal convolutions of q, k, v
    kda_gate_rank: int = 128             # rank of the decay (f) and output-gate (g) projections
    kda_chunk: int = 64                  # chunk length of the chunked core

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
    moe_router: str = "softmax"          # softmax | sigmoid (scores of each expert alone)
    moe_routed_scale: float = 1.0        # the routed experts' weights scaled by this
    # the experts (lo, hi) this device holds (expert parallelism's share):
    # routing is over all n_experts, the layer adds only its own experts'
    # part; None holds every expert
    experts_held: Optional[Tuple[int, int]] = None
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
    def n_experts_held(self) -> int:
        lo, hi = self.experts_held or (0, self.n_experts)
        return hi - lo

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
        between the ``first_k_dense_replace`` leading dense ones and the
        tail."""
        return [self._sublayer_at(pos) for pos in range(self._unit_len())]

    def lead_spec(self) -> SublayerSpec:
        """Each leading layer: its mixer and a dense FFN of width ``d_ff``."""
        return SublayerSpec(kind=self.lead_kind, ffn=FFNKind.DENSE)

    def pattern_tail(self) -> List[SublayerSpec]:
        """The layers after the last whole unit, each with the FFN its
        position would have in a unit."""
        return [SublayerSpec(kind=kind, ffn=self._ffn_at(pos)) for pos, kind in enumerate(self.tail_kinds)]

    def _unit_len(self) -> int:
        candidates = [len(self.unit_kinds) or 1]
        if self.local_global_alternating:
            candidates.append(2)
        if self.attn_layer_period > 1:
            candidates.append(self.attn_layer_period)
        if self.is_moe and self.moe_layer_period > 1:
            candidates.append(self.moe_layer_period)
        unit = 1
        for c in candidates:
            unit = _lcm(unit, c)
        if (self.n_layers - self.first_k_dense_replace - len(self.tail_kinds)) % unit != 0:
            raise ValueError(
                f"{self.name}: n_layers={self.n_layers} less "
                f"{self.first_k_dense_replace} leading dense and {len(self.tail_kinds)} "
                f"tail layers not divisible by pattern unit {unit}"
            )
        return unit

    def _sublayer_at(self, pos: int) -> SublayerSpec:
        # mixer kind
        if self.unit_kinds:
            kind = self.unit_kinds[pos % len(self.unit_kinds)]
        elif self.attn_layer_period > 1:  # hybrid: attention every k-th layer
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
        return SublayerSpec(kind=kind, ffn=self._ffn_at(pos))

    def _ffn_at(self, pos: int) -> FFNKind:
        if self.is_moe and pos % max(self.moe_layer_period, 1) == self.moe_layer_offset:
            return FFNKind.MOE
        return FFNKind.DENSE

    def layer_kinds(self) -> List[LayerKind]:
        """Every layer's mixer, first to last."""
        return ([self.lead_kind] * self.first_k_dense_replace
                + [spec.kind for spec in self.pattern_unit()] * self.n_units
                + list(self.tail_kinds))

    @property
    def n_units(self) -> int:
        return (self.n_layers - self.first_k_dense_replace - len(self.tail_kinds)) // self._unit_len()

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

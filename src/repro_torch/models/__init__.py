"""repro_torch.models — the model stack for all assigned architectures (the
reference's ``repro.models``), in PyTorch.

Parameters are plain nested dicts of tensors laid out as the reference's
(stacked units included), so weights carry across with
:func:`~repro_torch.models.layers.params_from_numpy`. The model path reaches
no hand kernel: attention, the SSD scan and the MoE dispatch are plain
PyTorch, as the reference's model path reaches no Pallas kernel. Latent
attention (``mla``) and Kimi Delta Attention (``kda``) are the port's own.
"""

from .attention import (
    attention,
    attention_chunked,
    attention_local_chunked,
    attention_reference,
    decode_attention,
    init_kv_cache,
    update_kv_cache,
)
from .blocks import apply_sublayer, init_unit, init_unit_state
from .config import FFNKind, LayerKind, ModelConfig, SublayerSpec
from .flops import (ParamCounts, decode_flops, kda_chunk_flops, mla_algorithm_flops, param_counts,
                    prefill_flops, training_flops)
from .frontend import (
    AudioStubSpec,
    VisionStubSpec,
    audio_frame_embeds,
    merge_vision_embeds,
    vision_patch_embeds,
)
from .kda import apply_kda, kda_chunked, kda_recurrent
from .layers import P, Params, params_from_numpy, split_params
from .mamba2 import apply_mamba, ssd_chunked, ssd_reference
from .model import (
    ForwardOptions,
    encdec_decode_step,
    encdec_forward,
    encdec_prefill,
    init_encdec_params,
    init_encdec_state,
    init_lm_params,
    init_lm_state,
    lm_decode_inplace,
    lm_decode_step,
    lm_extend_inplace,
    lm_forward,
    lm_prefill,
    lm_prefill_inplace,
)
from .mla import mla_attention, pick_algorithm
from .moe import apply_moe, moe_dense, moe_gather

__all__ = [
    "AudioStubSpec",
    "FFNKind",
    "ForwardOptions",
    "LayerKind",
    "ModelConfig",
    "P",
    "ParamCounts",
    "Params",
    "SublayerSpec",
    "VisionStubSpec",
    "apply_kda",
    "apply_mamba",
    "apply_moe",
    "apply_sublayer",
    "attention",
    "attention_chunked",
    "attention_local_chunked",
    "attention_reference",
    "audio_frame_embeds",
    "decode_attention",
    "decode_flops",
    "encdec_decode_step",
    "encdec_forward",
    "encdec_prefill",
    "init_encdec_params",
    "init_encdec_state",
    "init_kv_cache",
    "init_lm_params",
    "init_lm_state",
    "init_unit",
    "init_unit_state",
    "kda_chunk_flops",
    "kda_chunked",
    "kda_recurrent",
    "lm_decode_inplace",
    "lm_decode_step",
    "lm_extend_inplace",
    "lm_forward",
    "lm_prefill",
    "lm_prefill_inplace",
    "merge_vision_embeds",
    "mla_algorithm_flops",
    "mla_attention",
    "moe_dense",
    "moe_gather",
    "param_counts",
    "params_from_numpy",
    "pick_algorithm",
    "prefill_flops",
    "split_params",
    "ssd_chunked",
    "ssd_reference",
    "training_flops",
    "update_kv_cache",
    "vision_patch_embeds",
]

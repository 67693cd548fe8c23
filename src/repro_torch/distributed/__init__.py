"""repro_torch.distributed — sharding plans, gradient compression, pipeline
PP (the reference's ``repro.distributed`` on ``torch.distributed``
``DeviceMesh`` and DTensor). ``train/elastic.py`` re-meshes across
processes over these plans."""

from .compression import (
    ErrorFeedback,
    QuantizedLeaf,
    compressed_psum,
    dequantize_int8,
    dequantize_tree,
    quantize_int8,
    quantize_tree,
)
from .pipeline import bubble_fraction, pipeline_apply
from .sharding import (
    AbstractMesh,
    NamedSharding,
    ShardingPlan,
    Spec,
    attention_strategy,
    batch_spec,
    cache_seq_spec,
    dp_axes,
    dp_size,
    expert_strategy,
    make_plan,
    placements,
    shard_tensor,
    shard_tree,
    state_specs,
    tp_size,
    tree_shardings,
)

__all__ = [
    "AbstractMesh",
    "ErrorFeedback",
    "NamedSharding",
    "QuantizedLeaf",
    "ShardingPlan",
    "Spec",
    "attention_strategy",
    "batch_spec",
    "bubble_fraction",
    "cache_seq_spec",
    "compressed_psum",
    "dequantize_int8",
    "dequantize_tree",
    "dp_axes",
    "dp_size",
    "expert_strategy",
    "make_plan",
    "pipeline_apply",
    "placements",
    "quantize_int8",
    "quantize_tree",
    "shard_tensor",
    "shard_tree",
    "state_specs",
    "tp_size",
    "tree_shardings",
]

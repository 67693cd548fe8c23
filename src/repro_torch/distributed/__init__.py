"""repro_torch.distributed — gradient compression (the collective-free half
of the reference's ``repro.distributed``; sharding plans and pipeline
parallelism come with the distributed slice of the port)."""

from .compression import (
    ErrorFeedback,
    QuantizedLeaf,
    compressed_psum,
    dequantize_int8,
    dequantize_tree,
    quantize_int8,
    quantize_tree,
)

__all__ = [
    "ErrorFeedback",
    "QuantizedLeaf",
    "compressed_psum",
    "dequantize_int8",
    "dequantize_tree",
    "quantize_int8",
    "quantize_tree",
]

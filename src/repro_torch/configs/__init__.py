"""repro_torch.configs — the assigned input shapes and the one
shape-bucketing rule (:mod:`.shapes`, a copy of the reference's). The
architecture configs come with the slice that ports the model stack."""

from .shapes import LONG_CONTEXT_ARCHS, SHAPES, SKIPS, ShapeSpec, bucket_bounds, cells, shape_bucket

__all__ = ["LONG_CONTEXT_ARCHS", "SHAPES", "SKIPS", "ShapeSpec", "bucket_bounds", "cells", "shape_bucket"]

"""kda_roofline: % of the KDA core's least time over the device time of the
kernels launched inside each timed call's span, read as ``gemm_roofline``
reads the chain's. Each call's bound is max(its chunk length's frozen FLOPs
/ TF32 peak, the function's bytes / HBM bandwidth), the bytes the same for
every chunk length: q, k, v and g in, β, the state in and out, the output
out (``formulas_kda``). Only calls whose kernels the trace holds count."""

from .gemm_roofline import read  # noqa: F401  (the same reading of the calls' bounds)

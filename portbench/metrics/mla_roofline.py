"""mla_roofline: % of latent attention's least time over the device time of
the kernels launched inside each timed call's span, read as
``gemm_roofline`` reads the chain's. Each call's bound is max(its
variant's frozen FLOPs / TF32 peak, the function's bytes / HBM
bandwidth), the bytes the same for every variant: the latent cache read
once, the layer's attention weights read once, the hidden states in and
out (``formulas_mla``). Only calls whose kernels the trace holds count."""

from .gemm_roofline import read  # noqa: F401  (the same reading of the calls' bounds)

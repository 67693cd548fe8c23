"""repro_torch.explain — the AnomalyExplainer's substrate, as far as the
port has it: the algorithm -> kernel-sequence decomposition the census
families attach to their records (:mod:`.decompose`, metadata only). The
attribution, classification and runner modules come with the slice that
ports explain (ROADMAP Queue 1 item 4)."""

from .decompose import (
    KernelSpec,
    decompose_chain,
    decompose_chain_dims,
    decompose_generalized,
    decompose_instance,
    kernel_name,
    kernels_from_compact,
    kernels_from_record,
    kernels_to_compact,
)

__all__ = [
    "KernelSpec",
    "decompose_chain",
    "decompose_chain_dims",
    "decompose_generalized",
    "decompose_instance",
    "kernel_name",
    "kernels_from_compact",
    "kernels_from_record",
    "kernels_to_compact",
]

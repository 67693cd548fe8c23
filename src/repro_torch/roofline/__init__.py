"""repro_torch.roofline — the :class:`MachineSpec` registry and roofline
terms. Per-device counts of an eager step, the counterpart of the
reference's XLA HLO parser, are :mod:`.counts` (imported on its own: it
needs torch, and this package serves host-only surfaces)."""

from .terms import (
    DEFAULT_MACHINE,
    HBM_BW,
    ICI_BW,
    MACHINES,
    PEAK_FLOPS,
    MachineSpec,
    RooflineTerms,
    get_machine,
    register_machine,
    synthetic_machine,
    terms_from_counts,
)

__all__ = [
    "DEFAULT_MACHINE",
    "HBM_BW",
    "ICI_BW",
    "MACHINES",
    "MachineSpec",
    "PEAK_FLOPS",
    "RooflineTerms",
    "get_machine",
    "register_machine",
    "synthetic_machine",
    "terms_from_counts",
]

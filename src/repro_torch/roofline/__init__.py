"""repro_torch.roofline — the :class:`MachineSpec` registry and roofline
terms (a copy of the reference's ``repro.roofline`` without its XLA HLO
parser)."""

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

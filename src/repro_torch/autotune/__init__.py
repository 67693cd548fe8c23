"""repro_torch.autotune — the paper's ranking methodology as the port's
variant selector (measured or cost-modelled), campaign-capable via the
core ExperimentEngine. ``tuner`` is a copy of the reference's; ``variants``
carries the ``attention_impl``, ``moe_dispatch`` and ``ssd_chunk`` sites,
the ``matmul_blocks`` site on the hand-written Hopper GEMM, and the port's
own ``mla`` site (latent attention's absorbed and decompressed orders) and
``kda_chunk`` site (Kimi Delta Attention's chunk length)."""

from .tuner import (
    CampaignSite,
    TuneReport,
    build_session,
    prepare_site,
    rank_site,
    rank_site_costmodel,
    rank_sites,
    report_from_session,
    reports_from_engine,
)
from .variants import (
    Variant,
    VariantSite,
    attention_site,
    kda_chunk_site,
    matmul_blocks_site,
    mla_site,
    moe_dispatch_site,
    ssd_chunk_site,
)

__all__ = [
    "CampaignSite",
    "TuneReport",
    "Variant",
    "VariantSite",
    "attention_site",
    "build_session",
    "kda_chunk_site",
    "matmul_blocks_site",
    "mla_site",
    "moe_dispatch_site",
    "prepare_site",
    "rank_site",
    "rank_site_costmodel",
    "rank_sites",
    "report_from_session",
    "reports_from_engine",
    "ssd_chunk_site",
]

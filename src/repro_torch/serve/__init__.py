"""Serving: the ranking oracle.

Ranking-as-a-service (:mod:`repro_torch.serve.oracle`,
:mod:`repro_torch.serve.cache`) — the census-backed dispatch oracle, whose
hot path is pure dict lookups over the cache and touches no device. The
reference's model-serving engine (``repro.serve.engine``) has no
counterpart in the port. Everything is exported lazily (PEP 562), as in
the reference, so importing this package costs nothing until a name is
used.
"""

from typing import Any

_EXPORTS = {
    "RankingOracle": "repro_torch.serve.oracle",
    "OracleQueue": "repro_torch.serve.oracle",
    "hit_rate": "repro_torch.serve.oracle",
    "default_machine_name": "repro_torch.serve.oracle",
    "OracleCache": "repro_torch.serve.cache",
    "OracleCacheSpec": "repro_torch.serve.cache",
    "cache_key": "repro_torch.serve.cache",
    "shard_of_key": "repro_torch.serve.cache",
    "CONFIDENCE_MEASURED": "repro_torch.serve.cache",
    "CONFIDENCE_BUCKETED": "repro_torch.serve.cache",
    "CONFIDENCE_MODEL_ONLY": "repro_torch.serve.cache",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name: str) -> Any:
    module = _EXPORTS.get(name)
    if module is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    import importlib

    return getattr(importlib.import_module(module), name)

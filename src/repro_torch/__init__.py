"""repro_torch — the PyTorch / NVIDIA H100 port of ``repro``.

A package of its own beside the JAX reference ``repro``: it imports
``torch`` and numpy, never ``jax`` and nothing of ``repro``, and keeps its
own copy of every module it needs. Module names mirror the reference's, so
``repro_torch.core.ranking`` is the counterpart of ``repro.core.ranking``.

Entry points take an explicit ``device=`` (default ``"cuda"``) and raise
when no CUDA device is present; they never carry on on the CPU. Only the
tests pass ``device="cpu"``, where every kernel wrapper takes its plain
PyTorch version.

The package root stays import-light, as the reference's: the stable facade
(:mod:`repro_torch.api`) is re-exported lazily (PEP 562), so ``import
repro_torch`` (and ``from repro_torch import run_census``) imports no torch
and initialises no CUDA.
"""

from typing import TYPE_CHECKING

#: the facade names ``from repro_torch import X`` resolves through repro_torch.api
_API_NAMES = (
    "run_census",
    "explain_census",
    "warm_oracle",
    "query",
    "train_predictor",
    "predict_ranks",
)

__all__ = ["api"] + list(_API_NAMES)

if TYPE_CHECKING:  # pragma: no cover - typing only
    from repro_torch.api import (  # noqa: F401
        explain_census,
        predict_ranks,
        query,
        run_census,
        train_predictor,
        warm_oracle,
    )


def __getattr__(name):
    if name in _API_NAMES:
        from repro_torch import api

        return getattr(api, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def __dir__():
    return sorted(set(globals()) | set(_API_NAMES))

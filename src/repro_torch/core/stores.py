"""Store-kind registry — one seam for "what campaign lives in this dir?".

The work queue (:mod:`repro_torch.launch.queue`) and fsck
(:mod:`repro_torch.launch.fsck`) both need to answer the same question about a
store root: which campaign kind planned it, where is its spec, how many
shards does it have, and how is it drained. Both used to hard-code the
two known kinds (``spec.json`` = sweep, ``espec.json`` = explain) in an
if/elif each — which meant a third campaign kind would silently fall into
the wrong drain path (or, worse, a root holding *both* spec files would
silently drain as a sweep). This registry makes the kinds first-class:

* :func:`detect_store_kind` resolves a root to its registered
  :class:`StoreKind` (None when no spec file is present) and refuses —
  :class:`AmbiguousStore` — when more than one kind's spec file exists,
  instead of picking by registration order.
* each kind carries ``load_n_shards`` (fsck's shard-count probe) and
  ``make_queue`` (the queue's drainable adapter factory), so neither
  consumer enumerates kinds itself.

The built-in kinds (sweep, explain, and the serving oracle's ranking
cache — ``ocache.json``) are registered at import time; a future kind
(e.g. a replay campaign) registers itself here and both the queue and
fsck pick it up with zero changes. A copy of the reference's
``repro.core.stores``; a queue adapter also takes the device its
wall-clock workloads run on.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Optional, Tuple


class AmbiguousStore(ValueError):
    """A store root holds spec files for MORE than one registered kind —
    auto-detection refuses to guess which campaign owns the shards."""


@dataclass(frozen=True)
class StoreKind:
    """One campaign kind a store directory can hold."""

    name: str                                   #: e.g. "sweep" / "explain"
    spec_file: str                              #: detection marker, e.g. "spec.json"
    #: spec-declared shard count for a root (may raise OSError/ValueError/
    #: KeyError/TypeError when the spec itself is damaged — fsck falls back
    #: to scanning shard files)
    load_n_shards: Callable[[str], int] = field(repr=False, compare=False,
                                                default=lambda out: 0)
    #: drainable queue adapter for a root and the device its workloads
    #: run on (duck-typed: n_shards/out/shard_totals/run_shard/merge/
    #: progress — see repro_torch.launch.queue)
    make_queue: Callable[..., Any] = field(repr=False, compare=False,
                                           default=lambda out, device="cuda": None)

    def spec_path(self, out: str) -> str:
        return os.path.join(out, self.spec_file)


_REGISTRY: Dict[str, StoreKind] = {}


def register_store_kind(kind: StoreKind) -> StoreKind:
    """Register (or replace) a kind under its ``name``. Spec filenames
    must be unique across kinds — they are the detection markers."""
    for other in _REGISTRY.values():
        if other.name != kind.name and other.spec_file == kind.spec_file:
            raise ValueError(
                f"store kind {kind.name!r} reuses spec file "
                f"{kind.spec_file!r} already claimed by {other.name!r}"
            )
    _REGISTRY[kind.name] = kind
    return kind


def store_kinds() -> Tuple[StoreKind, ...]:
    """Registered kinds, in registration order."""
    return tuple(_REGISTRY.values())


def detect_store_kind(out: str) -> Optional[StoreKind]:
    """The kind whose spec file the root holds; None when no kind matches.
    A root matching MORE than one kind raises :class:`AmbiguousStore` —
    draining someone else's shards under the wrong spec is unrecoverable,
    so detection never guesses."""
    present = [k for k in _REGISTRY.values()
               if os.path.exists(k.spec_path(out))]
    if len(present) > 1:
        names = ", ".join(f"{k.name} ({k.spec_file})" for k in present)
        raise AmbiguousStore(
            f"{out} holds spec files for multiple campaign kinds: {names} "
            "— remove the stale one before draining"
        )
    return present[0] if present else None


# ---------------------------------------------------------- built-in kinds ---
# Lazy imports inside the callables: stores.py must stay importable from
# both repro_torch.core.sweep consumers and repro_torch.launch without
# cycles, and a shard-count probe must not pay the explain subsystem's
# import.


def _sweep_n_shards(out: str) -> int:
    from repro_torch.core.sweep import SweepSpec

    return SweepSpec.load(os.path.join(out, "spec.json")).n_shards


def _sweep_queue(out: str, device: str = "cuda") -> Any:
    from repro_torch.launch.queue import SweepQueue

    return SweepQueue(out, device=device)


def _explain_n_shards(out: str) -> int:
    from repro_torch.explain.runner import ExplainSpec

    return ExplainSpec.load(os.path.join(out, "espec.json")).n_shards


def _explain_queue(out: str, device: str = "cuda") -> Any:
    from repro_torch.launch.queue import ExplainQueue

    return ExplainQueue(out, device=device)


def _oracle_n_shards(out: str) -> int:
    from repro_torch.serve.cache import SPEC_FILE, OracleCacheSpec

    return OracleCacheSpec.load(os.path.join(out, SPEC_FILE)).n_shards


def _oracle_queue(out: str, device: str = "cuda") -> Any:
    from repro_torch.serve.oracle import OracleQueue

    return OracleQueue(out, device=device)


register_store_kind(StoreKind(
    name="sweep", spec_file="spec.json",
    load_n_shards=_sweep_n_shards, make_queue=_sweep_queue,
))
register_store_kind(StoreKind(
    name="explain", spec_file="espec.json",
    load_n_shards=_explain_n_shards, make_queue=_explain_queue,
))
register_store_kind(StoreKind(
    name="oracle", spec_file="ocache.json",
    load_n_shards=_oracle_n_shards, make_queue=_oracle_queue,
))

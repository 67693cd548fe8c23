"""The stable Python facade over the port's subsystems.

One import surface for scripts and notebooks — the same operations the
umbrella CLI (``python -m repro_torch``) exposes, over the same Spec
classes, without reaching into the launch modules:

    from repro_torch.api import run_census, train_predictor, warm_oracle, query

    spec = run_census(out="/tmp/census", families={...}, backend="cost_model")
    model_path = train_predictor("/tmp/census", "/tmp/model.json")
    spec = run_census(out="/tmp/active", families={...},
                      predictor_model="/tmp/model.json")   # active census
    warm_oracle("/tmp/cache", census="/tmp/census")
    verdict = query("/tmp/cache", "gram", {"size": 96, "seed": 0})

Heavy imports stay inside the functions, and
``repro_torch/__init__.py`` re-exports these names lazily (PEP 562), so
``import repro_torch`` initialises no CUDA. The two calls that can build
workloads (``run_census`` and ``explain_census``: a wall-clock census)
take ``device=`` (default ``"cuda"``) and pass it on; the others touch no
device. A copy of the reference's ``repro.api``.
"""

from __future__ import annotations

import os
from typing import Any, Dict, List, Mapping, Optional, Sequence

__all__ = [
    "run_census",
    "explain_census",
    "warm_oracle",
    "query",
    "train_predictor",
    "predict_ranks",
]


def run_census(
    out: str,
    spec: Optional[Any] = None,
    *,
    progress: Optional[Any] = None,
    max_steps: Optional[int] = None,
    device: str = "cuda",
    **spec_kwargs: Any,
) -> Any:
    """Run (or resume) a census to completion in-process and merge it.

    Pass a ready :class:`~repro_torch.core.sweep.SweepSpec` via ``spec``, or
    its constructor fields as keyword arguments (``families=...``,
    ``backend=...``, ``predictor_model=...`` for an active census, ...).
    An existing ``out/spec.json`` always wins — resume semantics match
    the CLI, and a conflicting ``spec``/``spec_kwargs`` for an existing
    store raises ``ValueError`` rather than reinterpreting old shards.
    ``max_steps`` bounds each shard's engine steps this call (the census
    is left resumable; ``merged.jsonl`` is only written once complete).
    A wall-clock census builds and times its workloads on ``device``.
    Returns the loaded/created spec; records land in ``out``."""
    from repro_torch.core.sweep import SweepSpec, run_shard, write_merged

    path = os.path.join(out, "spec.json")
    if os.path.exists(path):
        existing = SweepSpec.load(path)
        wanted = spec if spec is not None else (
            SweepSpec(**spec_kwargs) if spec_kwargs else None
        )
        if wanted is not None and wanted.to_dict() != existing.to_dict():
            raise ValueError(
                f"{path} already holds a different plan; pass no spec to "
                "resume it, or choose a fresh out directory"
            )
        spec = existing
    else:
        if spec is None:
            spec = SweepSpec(**spec_kwargs)
        os.makedirs(out, exist_ok=True)
        spec.save(path)
    for shard in range(spec.n_shards):
        run_shard(spec, out, shard, max_steps=max_steps, progress=progress,
                  device=device)
    from repro_torch.core.sweep import sweep_progress

    if sweep_progress(spec, out)["completed"] == len(spec.expand()):
        write_merged(spec, out)
    return spec


def explain_census(
    census: str,
    out: str,
    *,
    progress: Optional[Any] = None,
    device: str = "cuda",
    **spec_kwargs: Any,
) -> List[Dict[str, Any]]:
    """Explain every anomaly of a finished census in-process: plan (or
    resume) an :class:`~repro_torch.explain.runner.ExplainSpec` campaign under
    ``out``, drive all shards, and return the merged explanation
    records. A wall-clock census's anomalies are explained on ``device``."""
    from repro_torch.explain.runner import (
        SPEC_FILE,
        ExplainSpec,
        explain_targets,
        merge_explained,
        run_explain_shard,
        write_merged_explained,
    )

    path = os.path.join(out, SPEC_FILE)
    if os.path.exists(path):
        espec = ExplainSpec.load(path)
    else:
        espec = ExplainSpec(census=os.path.abspath(census), **spec_kwargs)
        os.makedirs(out, exist_ok=True)
        espec.save(path)
    census_data = explain_targets(espec)  # parse the census once
    for shard in range(espec.n_shards):
        run_explain_shard(espec, out, shard, census=census_data,
                          progress=progress, device=device)
    write_merged_explained(espec, out)
    return merge_explained(espec, out)


def warm_oracle(
    out: str,
    census: str,
    *,
    explain: str = "",
    machine: str = "",
    model: str = "",
    **spec_kwargs: Any,
) -> int:
    """Build (or refresh) a ranking-oracle cache from a finished census
    (+ optional explain store, + optional trained cost model for the
    learned-model miss tier). Returns the number of entries written."""
    from repro_torch.core.sweep import SweepSpec, merge_shards
    from repro_torch.serve.cache import SPEC_FILE, OracleCache, OracleCacheSpec
    from repro_torch.serve.oracle import default_machine_name

    spec_path = os.path.join(out, SPEC_FILE)
    if os.path.exists(spec_path):
        ospec = OracleCacheSpec.load(spec_path)
    else:
        ospec = OracleCacheSpec(
            census=os.path.abspath(census),
            explain=os.path.abspath(explain) if explain else "",
            machine=machine,
            model=os.path.abspath(model) if model else "",
            **spec_kwargs,
        )
    sweep = SweepSpec.load(os.path.join(ospec.census, "spec.json"))
    census_records = merge_shards(sweep, ospec.census)
    explain_records: List[Dict[str, Any]] = []
    if ospec.explain:
        from repro_torch.explain.runner import ExplainSpec, merge_explained

        espec = ExplainSpec.load(os.path.join(ospec.explain, "espec.json"))
        explain_records = merge_explained(espec, ospec.explain)
    cache = OracleCache.create(out, ospec)
    return cache.warm(
        census_records, explain_records,
        machine=default_machine_name(ospec, sweep),
    )


def query(
    out: str,
    family: str,
    params: Mapping[str, Any],
    *,
    machine: Optional[str] = None,
    enqueue: bool = True,
) -> Dict[str, Any]:
    """One ranking-oracle verdict from a warmed cache — the CLI's
    ``repro_torch oracle query`` as a function call."""
    from repro_torch.serve.oracle import RankingOracle

    oracle = RankingOracle.open(out)
    return oracle.query(family, dict(params), machine=machine,
                        enqueue=enqueue)


def train_predictor(
    census: str,
    out: str,
    *,
    machine: str = "",
    alpha: float = 1e-3,
) -> str:
    """Fit the learned cost model from a finished deterministic census
    and save it as JSON. Returns the model path — hand it to
    ``run_census(..., predictor_model=path)`` for an active census, or
    to ``warm_oracle(..., model=path)`` for learned-model misses."""
    from repro_torch.core.sweep import SweepSpec, merge_shards
    from repro_torch.predict.model import train_model

    spec = SweepSpec.load(os.path.join(census, "spec.json"))
    records = merge_shards(spec, census)
    model = train_model(spec, records, machine=machine, alpha=alpha)
    return model.save(out)


def predict_ranks(
    model: str,
    census: str,
    *,
    threshold: Optional[float] = None,
    machine: str = "",
    uids: Optional[Sequence[str]] = None,
) -> List[Any]:
    """Per-instance :class:`~repro_torch.predict.active.PredictedRanking` for a
    census grid (no measurement): predicted times/ranks, the anomaly
    verdict, and the flip-probability confidence the active gate
    thresholds on. ``uids`` restricts to a subset of the grid."""
    from repro_torch.core.sweep import SweepSpec
    from repro_torch.predict.active import ActivePredictor

    spec = SweepSpec.load(os.path.join(census, "spec.json"))
    predictor = ActivePredictor.open(model, spec, threshold=threshold,
                                     machine=machine)
    instances = spec.expand()
    if uids is not None:
        wanted = set(uids)
        instances = [i for i in instances if i.uid in wanted]
    return [predictor.predict(inst) for inst in instances]

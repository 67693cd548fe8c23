"""Re-derive roofline rows from the dry run's cached per-cell counts (no
step is run again) — the reference's ``launch/reanalyze.py``.

    python -m repro_torch.launch.reanalyze [--mesh single|multi]

Reads ``reports/torch/counts/<arch>_<shape>_<mesh>.json.gz`` written by
:mod:`.dryrun` (the per-device op records of each cell's step, the
counterpart of the reference's gzipped HLO) and rewrites the matching rows
of ``reports/torch/dryrun_<mesh>.json`` with the CURRENT analyzer and
machine — analyzer iterations never pay for a step twice.

Campaign reanalysis — the same never-remeasure principle for the ranking
methodology:

    python -m repro_torch.launch.reanalyze --campaign reports/torch/perf_campaign_X.json

Loads a persisted ExperimentEngine state (sessions restore with a detached
timer — no measurement backend needed), re-runs Procedure 3 (mean ranks
over the quantile ladder) on every session's STORED measurements with the
current code, and prints stored-vs-recomputed rankings per session. This
half touches no device; its output is the reference's for the same state.
"""

import argparse
import gzip
import json
import os

from ..configs import SHAPES, get_config
from .dryrun import MESHES, REPORT_DIR, model_flops_for


def reanalyze_campaign(path: str) -> None:
    """Re-rank a persisted campaign's measurement stores (no re-measuring),
    through the batched QuantileTable."""
    from ..core import ExperimentEngine, QuantileTable, mean_ranks

    engine = ExperimentEngine.load(path)
    print(f"campaign {path}: {len(engine)} sessions, "
          f"{engine.steps_taken} iterations taken, policy={engine.policy}")
    for session in engine:
        if session.measurements_per_alg == 0:
            print(f"  {session.name}: no measurements yet; skipped")
            continue
        table = QuantileTable.from_ranges(
            session.store, (*session.quantile_ranges, session.report_range)
        )
        mr = mean_ranks(
            session.order,
            None,
            quantile_ranges=session.quantile_ranges,
            report_range=session.report_range,
            tie_break=session.tie_break,
            table=table,
        )
        stored = session.history[-1] if session.history else None
        stored_seq = (
            "|".join(f"{n}:r{r}" for n, r in zip(stored.order, stored.ranks))
            if stored else "<none>"
        )
        fresh_seq = "|".join(f"{n}:r{r}" for n, r in zip(mr.order, mr.ranks))
        flag = "" if stored_seq == fresh_seq else "  <-- CHANGED"
        print(f"  {session.name}: N={session.measurements_per_alg} "
              f"converged={session.converged}")
        print(f"    stored:     {stored_seq}")
        print(f"    reanalyzed: {fresh_seq}{flag}")


def reanalyze_report(label: str, n_dev: int) -> list:
    """Rewrite ``dryrun_<label>.json``'s ok rows from their cached counts;
    returns the rows."""
    from ..roofline.counts import analyze
    from ..roofline.terms import H100_SXM_BF16, terms_from_counts

    report = os.path.join(REPORT_DIR, f"dryrun_{label}.json")
    with open(report) as f:
        rows = json.load(f)
    for row in rows:
        if not row.get("status", "").startswith("ok"):
            continue
        path = os.path.join(REPORT_DIR, "counts", f"{row['arch']}_{row['shape']}_{label}.json.gz")
        if not os.path.exists(path):
            print(f"missing counts for {row['arch']}/{row['shape']}; skipped")
            continue
        with gzip.open(path, "rt") as f:
            counts = analyze(json.load(f))
        cfg = get_config(row["arch"], smoke=False)
        shape = SHAPES[row["shape"]]
        terms = terms_from_counts(
            arch=row["arch"], shape=row["shape"], mesh_desc=label,
            kind=shape.kind, n_devices=n_dev, counts=counts,
            model_flops_total=model_flops_for(cfg, shape),
            memory_per_dev_bytes=row["mem_per_dev_gb"] * 2**30,
            machine=H100_SXM_BF16,
        )
        keep = {k: row[k] for k in (
            "status", "attention_strategy", "num_microbatches", "notes",
            "fit_attempts", "args_gb", "temp_gb", "hbm_budget_gb", "machine",
            "device", "step_s", "params_total", "params_active",
        ) if k in row}
        row.clear()
        row.update(terms.row())
        row.update(keep)
        print(f"reanalyzed {row['arch']:26s} {row['shape']:12s} "
              f"dom={row['dominant']} frac={row['roofline_fraction']}")
    with open(report, "w") as f:
        json.dump(rows, f, indent=1)
    return rows


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--mesh", choices=sorted(MESHES), default="single")
    p.add_argument("--campaign", default=None,
                   help="re-rank a persisted ExperimentEngine state file "
                        "instead of the roofline reports")
    args = p.parse_args(argv)
    if args.campaign:
        if not os.path.exists(args.campaign):
            p.error(f"no campaign state at {args.campaign}")
        reanalyze_campaign(args.campaign)
        return
    sizes, _, label = MESHES[args.mesh]
    n_dev = 1
    for s in sizes:
        n_dev *= s
    reanalyze_report(label, n_dev)


if __name__ == "__main__":
    main()

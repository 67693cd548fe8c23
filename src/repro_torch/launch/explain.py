"""AnomalyExplainer launcher — plan / run / report for explanation campaigns.

Consume a DiscriminantSweep census, fan its anomalies out across worker
processes (each driving resumable ExperimentEngine campaigns over the
winner/loser kernel segments, :mod:`repro_torch.explain.runner`), then merge the
sharded explanation records and report ranked, evidence-backed cause tables.

    # explain every anomaly of a finished census, 4 workers, resumable
    PYTHONPATH=src python -m repro_torch explain run \\
        --census /tmp/census --out /tmp/census_explain --workers 4

    # inspect / continue / report
    PYTHONPATH=src python -m repro_torch explain status --out DIR
    PYTHONPATH=src python -m repro_torch explain run    --out DIR --workers 4
    PYTHONPATH=src python -m repro_torch explain merge  --out DIR
    PYTHONPATH=src python -m repro_torch explain report --out DIR

    # a wall-clock census on the card: calibrate the card, then explain
    PYTHONPATH=src python -m repro_torch explain calibrate --out-file h100.json \\
        --machine h100-sxm --peak-flops 6.7e13 --hbm-bw 3.35e12
    PYTHONPATH=src python -m repro_torch explain run \\
        --census DIR --out E --workers 1 --machine-file h100.json

A wall-clock census is explained on ``--device`` (default ``cuda``; ``cpu``
runs the workloads on the host): its winner/loser algorithms and their
kernel segments are rebuilt and timed there. As for the census, each
worker gets a GPU of its own and a run with more workers than visible GPUs
is refused. ``calibrate --backend wall_clock`` times its GEMM ladder on
``--device`` as well. The deterministic backends touch no device.

Layout under ``--out`` mirrors the sweep: ``espec.json`` (campaign spec; the
work list is a pure function of it plus the census records),
``shard-NNNN.jsonl`` (append-only explanation records),
``shard-NNNN.manifest.json``, ``shard-NNNN.engine.json`` (in-flight chunk,
present only mid-chunk), ``merged.jsonl`` (after ``merge``).

Resume semantics match the sweep: ``run`` is idempotent, and for the
deterministic census backends (``cost_model``, ``simulated``) a SIGKILLed
explain run resumes byte-identical to an uninterrupted one.

Explanation campaigns are also drainable by many machines at once via the
pull-based work queue (``python -m repro_torch queue work --out DIR``) —
see :mod:`repro_torch.launch.queue`.

A copy of the reference's ``repro.launch.explain``: the plans it writes,
the records its workers append and the reports it prints are the
reference's byte for byte.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from typing import List, Optional

from repro_torch.core.sweep import StoreDamaged
from repro_torch.explain.runner import (
    SPEC_FILE,
    ExplainSpec,
    explain_progress,
    explain_summary,
    merge_explained,
    run_explain_shard,
    write_merged_explained,
)
from repro_torch.launch.cliutil import add_device_arg, add_fsck_args, fsck_command
from repro_torch.launch.sweep import _int_list, worker_envs


def spec_path(out: str) -> str:
    return os.path.join(out, SPEC_FILE)


def add_campaign_args(p: argparse.ArgumentParser) -> None:
    g = p.add_argument_group("campaign (used when OUT has no espec.json yet)")
    g.add_argument("--census", default=None,
                   help="DiscriminantSweep --out directory to explain")
    g.add_argument("--name", default="explain")
    g.add_argument("--shards", type=int, default=4)
    g.add_argument("--m-per-iteration", type=int, default=3)
    g.add_argument("--eps", type=float, default=0.03)
    g.add_argument("--max-measurements", type=int, default=12)
    g.add_argument("--chunk-size", type=int, default=8)
    g.add_argument("--save-every", type=int, default=25)
    g.add_argument("--machine", default="",
                   help="MachineSpec registry name for the roofline floor "
                   "(default: derived from the census backend)")
    g.add_argument("--machine-file", default="",
                   help="calibration JSON from the `calibrate` subcommand; "
                   "overrides --machine with the fitted "
                   "dispatch/efficiency-curve spec")
    g.add_argument("--min-evidence", type=float, default=0.5,
                   help="fraction of the time gap a cause must explain")
    g.add_argument("--flip-probes", type=int, default=16,
                   help="re-ranking probe batches behind not_reproducible")
    g.add_argument("--flip-z", type=float, default=3.0,
                   help="median-gap z below which the probe runs")
    g.add_argument("--flip-min-prob", type=float, default=0.25,
                   help="minimum probed flip probability before an "
                   "insignificant gap counts as not_reproducible")
    g.add_argument("--ladder", default="report",
                   choices=["report", "paper"],
                   help="session quantile ladder: 'report' (default) runs "
                   "one sort per step — all the explainer needs (medians + "
                   "convergence, same samples in the same order); 'paper' "
                   "keeps the census's full 7-range ladder")
    g.add_argument("--seed", type=int, default=0)
    g.add_argument("--fsync", action="store_true")


def load_or_plan_spec(args: argparse.Namespace, *, announce: bool = True) -> ExplainSpec:
    path = spec_path(args.out)
    if os.path.exists(path):
        espec = ExplainSpec.load(path)
        if announce:
            print(f"# using existing plan {path} (census {espec.census})")
        return espec
    if not args.census:
        raise SystemExit(f"{path} missing and no --census given")
    census = os.path.abspath(args.census)
    if not os.path.exists(os.path.join(census, "spec.json")):
        raise SystemExit(f"{census} is not a sweep directory (no spec.json)")
    if os.path.abspath(args.out) == census:
        raise SystemExit(
            "--out must differ from --census (both store shard-NNNN files)"
        )
    os.makedirs(args.out, exist_ok=True)
    espec = ExplainSpec(
        name=args.name,
        census=census,
        n_shards=args.shards,
        m_per_iteration=args.m_per_iteration,
        eps=args.eps,
        max_measurements=args.max_measurements,
        chunk_size=args.chunk_size,
        save_every=args.save_every,
        machine=args.machine,
        machine_file=(
            os.path.abspath(args.machine_file) if args.machine_file else ""
        ),
        min_evidence=args.min_evidence,
        flip_probes=args.flip_probes,
        flip_z=args.flip_z,
        flip_min_prob=args.flip_min_prob,
        ladder=args.ladder,
        base_seed=args.seed,
        fsync=args.fsync,
    )
    espec.save(path)
    if announce:
        prog = explain_progress(espec, args.out)
        print(f"# planned {prog['anomalies']} anomaly explanations over "
              f"{espec.n_shards} shards (census {census})")
    return espec


# ------------------------------------------------------------- subcommands ---


def cmd_plan(args: argparse.Namespace) -> int:
    path = spec_path(args.out)
    if os.path.exists(path) and not args.force:
        raise SystemExit(f"{path} exists; pass --force to re-plan")
    if os.path.exists(path):
        os.remove(path)
        removed = 0
        for fn in sorted(os.listdir(args.out)):
            if (fn.startswith("shard-") and
                    fn.split(".", 1)[-1] in ("jsonl", "manifest.json",
                                             "engine.json", "timings.json",
                                             "lease.json")) \
                    or fn == "merged.jsonl":
                os.remove(os.path.join(args.out, fn))
                removed += 1
        qdir = os.path.join(args.out, "quarantine")
        if os.path.isdir(qdir):
            # quarantined damage belongs to the old plan's records
            import shutil

            shutil.rmtree(qdir)
            removed += 1
        if removed:
            print(f"# --force: removed {removed} stale shard/merge artifacts")
    espec = load_or_plan_spec(args)
    prog = explain_progress(espec, args.out)
    for row in prog["shards"]:
        print(f"#   shard {row['shard']:4d}: {row['total']} anomalies")
    print(f"# spec: {path}")
    return 0


def cmd_run(args: argparse.Namespace) -> int:
    from repro_torch.explain.runner import explain_targets

    espec = load_or_plan_spec(args, announce=False)
    sweep_spec, targets = explain_targets(espec)  # parse the census once
    prog = explain_progress(espec, args.out, targets=targets)
    print(f"# explaining {prog['anomalies']} anomalies from {espec.census} "
          f"({espec.n_shards} shards)")
    if prog["anomalies"] == 0:
        print("# census has no anomalies — nothing to explain")
        write_merged_explained(espec, args.out)
        return 0
    workers = max(1, min(args.workers, espec.n_shards))
    envs = worker_envs(workers, sweep_spec.backend, args.device)
    assignment = {
        w: [s for s in range(espec.n_shards) if s % workers == w]
        for w in range(workers)
    }
    procs: List[subprocess.Popen] = []
    for w, shards in assignment.items():
        cmd = [
            sys.executable, "-m", "repro_torch", "explain", "work",
            "--out", args.out, "--shards", ",".join(map(str, shards)),
            "--device", args.device,
        ]
        if args.max_steps_per_shard is not None:
            cmd += ["--max-steps-per-shard", str(args.max_steps_per_shard)]
        procs.append(subprocess.Popen(cmd, env=envs[w]))
    failed = []
    for w, proc in enumerate(procs):
        rc = proc.wait()
        if rc != 0:
            failed.append((w, rc))
    prog = explain_progress(espec, args.out, targets=targets)
    print(f"# {prog['completed']}/{prog['anomalies']} anomalies explained")
    if failed:
        for w, rc in failed:
            print(f"# worker {w} exited {rc} (shards {assignment[w]})",
                  file=sys.stderr)
        print("# re-run the same command to resume", file=sys.stderr)
        return 1
    if prog["completed"] == prog["anomalies"]:
        try:
            path = write_merged_explained(espec, args.out)
        except StoreDamaged as err:
            print(f"# merge refused: {err}", file=sys.stderr)
            return 1
        print(f"# merged explanations: {path}")
    return 0


def cmd_work(args: argparse.Namespace) -> int:
    """Internal: run an assigned shard list sequentially (one worker)."""
    from repro_torch.explain.runner import explain_targets

    espec = ExplainSpec.load(spec_path(args.out))
    census = explain_targets(espec)  # parse the census once per worker
    for shard in _int_list(args.shards):
        run_explain_shard(
            espec, args.out, shard,
            max_steps=args.max_steps_per_shard,
            progress=lambda msg: print(f"# {msg}", flush=True),
            census=census,
            device=args.device,
        )
    return 0


def cmd_status(args: argparse.Namespace) -> int:
    espec = ExplainSpec.load(spec_path(args.out))
    prog = explain_progress(espec, args.out)
    print(f"# explain {prog['name']}: {prog['completed']}/{prog['anomalies']} "
          f"anomalies explained")
    for row in prog["shards"]:
        flag = " (chunk in flight)" if row["in_flight_chunk"] else ""
        damage = f" DAMAGED x{row['damaged']}" if row.get("damaged") else ""
        print(f"#   shard {row['shard']:4d}: {row['done']}/{row['total']}"
              f"{flag}{damage}")
    if prog.get("damaged"):
        print(f"# {prog['damaged']} damaged record line(s) — merge will "
              f"refuse; run: python -m repro_torch fsck --out {args.out}")
    return 0


def cmd_merge(args: argparse.Namespace) -> int:
    espec = ExplainSpec.load(spec_path(args.out))
    try:
        path = write_merged_explained(espec, args.out)
    except StoreDamaged as err:
        print(f"# merge refused: {err}", file=sys.stderr)
        return 1
    n = sum(1 for _ in open(path))
    print(f"# merged {n} explanations -> {path}")
    return 0


def cmd_calibrate(args: argparse.Namespace) -> int:
    """Fit a machine's dispatch/GEMM-efficiency curve from
    micro-measurements and save it for ``run --machine-file``."""
    import dataclasses

    from repro_torch.explain.calibrate import (
        DEFAULT_SIZES,
        calibration_table,
        fit_calibration,
        micro_points_synthetic,
        micro_points_wall_clock,
        synthetic_truth,
    )
    from repro_torch.roofline.terms import MachineSpec, get_machine

    if args.peak_flops:
        # a custom-peak spec is NOT the registry machine: only carry the
        # --machine name over when the caller explicitly chose one
        base = MachineSpec(
            name=args.machine if args.machine is not None else "custom",
            peak_flops=args.peak_flops,
            hbm_bw=args.hbm_bw,
        )
    else:
        base = get_machine(args.machine if args.machine is not None
                           else "cpu-1core")
    sizes = _int_list(args.sizes) if args.sizes else list(DEFAULT_SIZES)
    if args.backend == "wall_clock":
        points = micro_points_wall_clock(sizes, reps=args.reps, seed=args.seed,
                                         device=args.device)
    else:
        truth = synthetic_truth(
            base,
            dispatch_s=args.truth_dispatch_us * 1e-6,
            eff_knee=args.truth_eff_knee,
            sizes=sizes,
        )
        points = micro_points_synthetic(
            truth, sizes, reps=args.reps, seed=args.seed,
            rel_sigma=args.truth_noise,
        )
    # fit against the dispatch-free nominal spec: dispatch is an OUTPUT
    result = fit_calibration(
        dataclasses.replace(base, dispatch_overhead_s=0.0, eff_curve=()),
        points,
    )
    print(calibration_table(result))
    path = result.save(args.out_file)
    print(f"# calibration -> {path} (pass --machine-file {path} to "
          "plan/run/report)")
    return 0


def cmd_report(args: argparse.Namespace) -> int:
    from repro_torch.launch.report_md import explain_tables

    espec = ExplainSpec.load(spec_path(args.out))
    records = merge_explained(espec, args.out)
    if args.json:
        json.dump(explain_summary(records), sys.stdout, indent=1, sort_keys=True)
        print()
        return 0
    if not records:
        print("(no explained anomalies yet — run the campaign first)")
        return 1
    print(explain_tables(records, name=espec.name))
    return 0


def main(argv: Optional[List[str]] = None, prog: Optional[str] = None) -> int:
    ap = argparse.ArgumentParser(
        prog=prog or "repro_torch explain",
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("plan", help="snapshot the campaign spec (espec.json)")
    p.add_argument("--out", required=True)
    p.add_argument("--force", action="store_true")
    add_campaign_args(p)
    p.set_defaults(fn=cmd_plan)

    p = sub.add_parser("run", help="run/resume the campaign with N workers")
    p.add_argument("--out", required=True)
    p.add_argument("--workers", type=int, default=1)
    p.add_argument("--max-steps-per-shard", type=int, default=None,
                   help="pause each shard after N engine steps (resumable)")
    add_campaign_args(p)
    add_device_arg(p)
    p.set_defaults(fn=cmd_run)

    p = sub.add_parser("work", help="internal: run an assigned shard list")
    p.add_argument("--out", required=True)
    p.add_argument("--shards", required=True, help="comma list of shard ids")
    p.add_argument("--max-steps-per-shard", type=int, default=None)
    add_device_arg(p)
    p.set_defaults(fn=cmd_work)

    p = sub.add_parser("status", help="explained/total anomalies per shard")
    p.add_argument("--out", required=True)
    p.set_defaults(fn=cmd_status)

    p = sub.add_parser("merge", help="merge shard JSONLs into merged.jsonl")
    p.add_argument("--out", required=True)
    p.set_defaults(fn=cmd_merge)

    p = sub.add_parser("fsck", help="classify/repair/quarantine store damage")
    add_fsck_args(p)
    p.set_defaults(fn=fsck_command)

    p = sub.add_parser(
        "calibrate",
        help="fit a machine's dispatch/GEMM-efficiency curve from "
        "micro-measurements (for run --machine-file)",
    )
    p.add_argument("--out-file", required=True,
                   help="where to save the calibration JSON")
    p.add_argument("--machine", default=None,
                   help="base MachineSpec registry name (default cpu-1core; "
                   "with --peak-flops: the custom spec's name, default "
                   "'custom')")
    p.add_argument("--peak-flops", type=float, default=None,
                   help="build a custom base spec at this peak instead of "
                   "--machine (e.g. a census's synthetic flop_rate)")
    p.add_argument("--hbm-bw", type=float, default=0.0,
                   help="bytes/s of the custom base spec (with --peak-flops)")
    p.add_argument("--backend", default="wall_clock",
                   choices=["wall_clock", "synthetic"],
                   help="synthetic = deterministic draws from a known "
                   "ground-truth machine (tests/CI)")
    p.add_argument("--sizes", default="",
                   help="comma list of GEMM ladder sizes (default 8..256)")
    p.add_argument("--reps", type=int, default=25)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--truth-dispatch-us", type=float, default=2.0,
                   help="synthetic backend: ground-truth dispatch (us)")
    p.add_argument("--truth-eff-knee", type=float, default=64.0,
                   help="synthetic backend: eff(n)=n/(n+knee); 0 = flat")
    p.add_argument("--truth-noise", type=float, default=0.02,
                   help="synthetic backend: lognormal measurement noise")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="device the wall_clock backend times its GEMM ladder "
                   "on (default cuda); the synthetic backend touches none")
    p.set_defaults(fn=cmd_calibrate)

    p = sub.add_parser("report", help="cause tables (markdown)")
    p.add_argument("--out", required=True)
    p.add_argument("--json", action="store_true",
                   help="raw explain_summary JSON instead of markdown")
    p.set_defaults(fn=cmd_report)

    args = ap.parse_args(argv)
    return args.fn(args)

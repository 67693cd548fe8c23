"""DiscriminantSweep launcher — plan / run / merge / report for the census.

Fan a grid of expression instances out across worker processes, each worker
driving its shards through resumable ExperimentEngine campaigns
(:mod:`repro_torch.core.sweep`), then merge the sharded JSONL results and report
anomaly rates by family and instance size (paper Figs. 5-7).

    # 220-instance default census, 4 workers, resumable under DIR
    PYTHONPATH=src python -m repro_torch census run --out DIR --workers 4

    # inspect / continue
    PYTHONPATH=src python -m repro_torch census status --out DIR
    PYTHONPATH=src python -m repro_torch census run --out DIR --workers 4
    PYTHONPATH=src python -m repro_torch census merge --out DIR
    PYTHONPATH=src python -m repro_torch census report --out DIR

    # the same grid timed on the card (one worker per visible GPU)
    PYTHONPATH=src python -m repro_torch census run --out DIR --backend wall_clock

A wall-clock census builds and times its workloads on ``--device``
(default ``cuda``; ``cpu`` runs the plain versions on the host). Each
worker gets a GPU of its own through ``CUDA_VISIBLE_DEVICES``, and a run
asking for more wall-clock workers than there are visible GPUs is refused:
workers sharing a card would time each other. The deterministic backends
touch no device and take any worker count.

Shard layout under ``--out``: ``spec.json`` (the full grid + campaign
parameters; everything downstream is a pure function of it),
``shard-NNNN.jsonl`` (append-only census records), ``shard-NNNN.manifest.json``
(completed set summary), ``shard-NNNN.engine.json`` (in-flight chunk
campaign, present only mid-chunk), ``merged.jsonl`` (after ``merge``).

Resume semantics: ``run`` is idempotent — re-running after ANY interruption
(including SIGKILL of the whole process group) continues from the last
persisted chunk state and, for the deterministic backends (``cost_model``,
``simulated``), produces a census byte-identical to an uninterrupted run.

To drain one census with MANY machines instead of many local workers,
point any number of ``python -m repro_torch queue work --out DIR`` processes at
the same (shared-filesystem) store — shards are leased dynamically rather
than assigned (:mod:`repro_torch.launch.queue`).

An ACTIVE census (``--predictor MODEL.json``) consults a trained cost
model (:mod:`repro_torch.predict`) before measuring: instances whose
predicted ranking confidence clears ``--predict-threshold`` are committed
as ``predicted``-provenance records without measurement; the skip
fraction is surfaced in ``status`` and the report, never silent.

A copy of the reference's ``repro.launch.sweep``: the plans it writes and
the records its workers append are the reference's byte for byte.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from typing import Dict, List, Optional

import repro_torch
from repro_torch.core.family import family_names, get_family
from repro_torch.launch.cliutil import add_device_arg, add_fsck_args, fsck_command
from repro_torch.core.sweep import (
    ShardStore,
    StoreDamaged,
    SweepSpec,
    census_summary,
    merge_shards,
    run_shard,
    sweep_progress,
    write_merged,
)

SPEC_FILE = "spec.json"


def spec_path(out: str) -> str:
    return os.path.join(out, SPEC_FILE)


def _int_list(s: str) -> List[int]:
    return [int(x) for x in s.split(",") if x]


def add_grid_args(p: argparse.ArgumentParser) -> None:
    g = p.add_argument_group("grid (used when OUT has no spec.json yet)")
    g.add_argument("--name", default="census")
    g.add_argument("--chains", type=int, default=120,
                   help="random chain instances (0 disables the family)")
    g.add_argument("--chain-sizes", type=_int_list, default=[3, 4],
                   metavar="N,N", help="matrices per chain, cycled")
    g.add_argument("--lo", type=int, default=32, help="min chain dim")
    g.add_argument("--hi", type=int, default=512, help="max chain dim")
    g.add_argument("--families", default="gram,distributive,solve,bilinear",
                   help="beyond-chain families (comma list, empty disables; "
                   "add kernel_variants to census the repo's own kernels)")
    g.add_argument("--sizes", type=_int_list, default=[64, 96, 128, 192, 256],
                   metavar="N,N", help="sizes per beyond-chain family")
    g.add_argument("--per-size", type=int, default=5,
                   help="seeded instances per (family, size)")
    g.add_argument("--kernel-sites", default="matmul,attention,ssd",
                   help="kernel_variants sites (comma list); only read when "
                   "--families includes kernel_variants")
    g.add_argument("--kernel-native", action="store_true",
                   help="time the hand kernels of kernel_variants on the card "
                   "(the GPU kernel lane); without it the instances are "
                   "planned in the reference's interpret mode, which builds "
                   "only with --device cpu (the plain versions)")
    g.add_argument("--shards", type=int, default=8)
    g.add_argument("--backend", default="cost_model",
                   choices=["cost_model", "simulated", "wall_clock"])
    g.add_argument("--flop-rate", type=float, default=5e10)
    g.add_argument("--eff-sigma", type=float, default=0.05)
    g.add_argument("--noise-sigma", type=float, default=0.02)
    g.add_argument("--bimodal-shift", type=float, default=0.0)
    g.add_argument("--bimodal-prob", type=float, default=0.0)
    g.add_argument("--bimodal-frac", type=float, default=1.0,
                   help="fraction of instances whose simulated timer goes "
                   "bimodal (turbo-regime ground truth; 1.0 = all)")
    g.add_argument("--cache-reuse-frac", type=float, default=0.0,
                   help="per-algorithm probability of an injected "
                   "inter-kernel cache-reuse saving")
    g.add_argument("--cache-reuse-saving", type=float, default=0.0,
                   help="whole-run fraction saved by an injected "
                   "cache-reuse effect")
    g.add_argument("--dispatch-s", type=float, default=0.0,
                   help="synthetic per-kernel dispatch overhead (seconds); "
                   "dominates tiny instances")
    g.add_argument("--m-per-iteration", type=int, default=3)
    g.add_argument("--eps", type=float, default=0.03)
    g.add_argument("--max-measurements", type=int, default=24)
    g.add_argument("--rt-threshold", type=float, default=1.5)
    g.add_argument("--policy", default="least_converged_first",
                   choices=["round_robin", "least_converged_first"])
    g.add_argument("--chunk-size", type=int, default=8)
    g.add_argument("--save-every", type=int, default=25)
    g.add_argument("--seed", type=int, default=0)
    g.add_argument("--fsync", action="store_true",
                   help="fsync record batches (survive power loss, not just "
                   "SIGKILL; serializes workers on many filesystems)")
    g.add_argument("--predictor", default="",
                   help="trained cost model JSON (python -m repro_torch predict "
                   "train); makes the census ACTIVE — instances whose "
                   "predicted ranking confidence clears --predict-threshold "
                   "are emitted as predicted records instead of measured")
    g.add_argument("--predict-threshold", type=float, default=0.95,
                   help="confidence needed to skip measuring an instance")


def spec_from_args(args: argparse.Namespace) -> SweepSpec:
    families: Dict[str, Dict] = {}
    chain_grid = get_family("chain").grid_from_args(args)
    if chain_grid is not None:
        families["chain"] = chain_grid
    known = tuple(n for n in family_names() if n != "chain")
    for fam in [f for f in args.families.split(",") if f]:
        if fam not in known:
            raise SystemExit(f"unknown family {fam!r}; one of {known}")
        grid = get_family(fam).grid_from_args(args)
        if grid is not None:
            families[fam] = grid
    return SweepSpec(
        name=args.name,
        families=families,
        n_shards=args.shards,
        backend=args.backend,
        flop_rate=args.flop_rate,
        eff_sigma=args.eff_sigma,
        noise_sigma=args.noise_sigma,
        bimodal_shift=args.bimodal_shift,
        bimodal_prob=args.bimodal_prob,
        bimodal_frac=args.bimodal_frac,
        cache_reuse_frac=args.cache_reuse_frac,
        cache_reuse_saving=args.cache_reuse_saving,
        dispatch_s=args.dispatch_s,
        m_per_iteration=args.m_per_iteration,
        eps=args.eps,
        max_measurements=args.max_measurements,
        rt_threshold=args.rt_threshold,
        policy=args.policy,
        chunk_size=args.chunk_size,
        save_every=args.save_every,
        base_seed=args.seed,
        fsync=args.fsync,
        predictor_model=args.predictor,
        predict_threshold=args.predict_threshold,
    )


def load_or_plan_spec(args: argparse.Namespace, *, announce: bool = True) -> SweepSpec:
    path = spec_path(args.out)
    if os.path.exists(path):
        spec = SweepSpec.load(path)
        if announce:
            print(f"# using existing plan {path} "
                  f"({len(spec.expand())} instances, {spec.n_shards} shards)")
        return spec
    os.makedirs(args.out, exist_ok=True)
    spec = spec_from_args(args)
    spec.save(path)
    if announce:
        n = len(spec.expand())
        fams = {f: sum(1 for i in spec.expand() if i.family == f)
                for f in sorted(spec.families)}
        print(f"# planned {n} instances over {spec.n_shards} shards "
              f"[{spec.backend}]: "
              + ", ".join(f"{f}={c}" for f, c in fams.items()))
    return spec


# ------------------------------------------------------------- subcommands ---


def cmd_plan(args: argparse.Namespace) -> int:
    path = spec_path(args.out)
    if os.path.exists(path) and not args.force:
        raise SystemExit(f"{path} exists; pass --force to re-plan "
                         "(existing shard results would be reinterpreted)")
    if os.path.exists(path):
        # a new plan invalidates every artifact derived from the old one:
        # record uids encode (family, n, index) but not the grid bounds or
        # campaign knobs, so stale shard files would silently satisfy the
        # new grid with results measured under the old parameters
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
    spec = load_or_plan_spec(args)
    for shard in range(spec.n_shards):
        n = len(spec.shard_instances(shard))
        print(f"#   shard {shard:4d}: {n} instances")
    print(f"# spec: {path}")
    return 0


def _worker_env() -> Dict[str, str]:
    """Child interpreters must import ``repro_torch`` the same way we did —
    and must not each spin up an nproc-wide BLAS pool: N workers x N
    spinning BLAS threads on N cores turns the census into a futex
    benchmark. The analysis layer is single-threaded numpy; parallelism
    comes from the worker processes."""
    env = dict(os.environ)
    src_dir = os.path.dirname(os.path.abspath(list(repro_torch.__path__)[0]))
    parts = [src_dir] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p]
    env["PYTHONPATH"] = os.pathsep.join(dict.fromkeys(parts))
    for var in ("OPENBLAS_NUM_THREADS", "OMP_NUM_THREADS", "MKL_NUM_THREADS"):
        env.setdefault(var, "1")
    return env


def visible_gpus() -> List[str]:
    """The CUDA devices a child process may be given, as
    ``CUDA_VISIBLE_DEVICES`` entries: this process's own list when it has
    one, else the indices of every device torch sees."""
    listed = os.environ.get("CUDA_VISIBLE_DEVICES")
    if listed is not None:
        return [d.strip() for d in listed.split(",") if d.strip()]
    import torch

    return [str(i) for i in range(torch.cuda.device_count())]


def worker_envs(n: int, backend: str, device: str) -> List[Dict[str, str]]:
    """One environment per worker process. A wall-clock census on the card
    gives each worker a GPU of its own (``CUDA_VISIBLE_DEVICES``) and is
    refused with more workers than visible GPUs — workers sharing a card
    would time each other. Any other census takes any worker count."""
    env = _worker_env()
    if backend != "wall_clock" or device != "cuda":
        return [dict(env) for _ in range(n)]
    gpus = visible_gpus()
    if not gpus:
        raise SystemExit("a wall_clock census on cuda needs a visible GPU and "
                         "none is; pass --device cpu to time on the host")
    if n > len(gpus):
        raise SystemExit(
            f"a wall_clock census on cuda takes one worker per GPU: {n} "
            f"worker(s) asked, {len(gpus)} GPU(s) visible — run with at most "
            f"{len(gpus)}, or drain one store from several machines with "
            "`python -m repro_torch queue work`"
        )
    return [dict(env, CUDA_VISIBLE_DEVICES=gpus[w]) for w in range(n)]


def cmd_run(args: argparse.Namespace) -> int:
    path = spec_path(args.out)
    planned = SweepSpec.load(path) if os.path.exists(path) else spec_from_args(args)
    workers = max(1, min(args.workers, planned.n_shards))
    envs = worker_envs(workers, planned.backend, args.device)
    spec = load_or_plan_spec(args)
    assignment = {
        w: [s for s in range(spec.n_shards) if s % workers == w]
        for w in range(workers)
    }
    procs: List[subprocess.Popen] = []
    for w, shards in assignment.items():
        cmd = [
            sys.executable, "-m", "repro_torch", "census", "work",
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
    prog = sweep_progress(spec, args.out)
    print(f"# {prog['completed']}/{prog['instances']} instances complete")
    if failed:
        for w, rc in failed:
            print(f"# worker {w} exited {rc} (shards {assignment[w]})",
                  file=sys.stderr)
        print("# re-run the same command to resume", file=sys.stderr)
        return 1
    if prog["completed"] == prog["instances"]:
        try:
            path = write_merged(spec, args.out)
        except StoreDamaged as err:
            print(f"# merge refused: {err}", file=sys.stderr)
            return 1
        print(f"# merged census: {path}")
    return 0


def cmd_work(args: argparse.Namespace) -> int:
    """Internal: run an assigned shard list sequentially (one worker)."""
    spec = SweepSpec.load(spec_path(args.out))
    for shard in _int_list(args.shards):
        run_shard(
            spec, args.out, shard,
            max_steps=args.max_steps_per_shard,
            progress=lambda msg: print(f"# {msg}", flush=True),
            device=args.device,
        )
    return 0


def cmd_status(args: argparse.Namespace) -> int:
    spec = SweepSpec.load(spec_path(args.out))
    prog = sweep_progress(spec, args.out)
    print(f"# sweep {prog['name']}: {prog['completed']}/{prog['instances']} "
          f"instances complete")
    if prog["completed"]:
        fams = ", ".join(
            f"{fam}={a['anomalies']}/{a['done']}"
            for fam, a in sorted(prog["by_family"].items())
        )
        print(f"# anomalies so far: {prog['anomalies']}/{prog['completed']} "
              f"({fams})")
    if prog.get("predicted"):
        frac = prog["predicted"] / max(prog["completed"], 1)
        print(f"# predicted without measurement: {prog['predicted']}"
              f"/{prog['completed']} (skip fraction {100.0 * frac:.1f}%)")
    for row in prog["shards"]:
        flag = " (chunk in flight)" if row["in_flight_chunk"] else ""
        anom = f", {row['anomalies']} anomalies" if row["done"] else ""
        damage = f" DAMAGED x{row['damaged']}" if row.get("damaged") else ""
        print(f"#   shard {row['shard']:4d}: {row['done']}/{row['total']}"
              f"{anom}{flag}{damage}")
    if prog.get("damaged"):
        print(f"# {prog['damaged']} damaged record line(s) — merge will "
              f"refuse; run: python -m repro_torch fsck --out {args.out}")
    return 0


def cmd_merge(args: argparse.Namespace) -> int:
    spec = SweepSpec.load(spec_path(args.out))
    try:
        path = write_merged(spec, args.out)
    except StoreDamaged as err:
        print(f"# merge refused: {err}", file=sys.stderr)
        return 1
    n = sum(1 for _ in open(path))
    print(f"# merged {n} records -> {path}")
    return 0


def cmd_report(args: argparse.Namespace) -> int:
    from repro_torch.launch.report_md import census_tables

    spec = SweepSpec.load(spec_path(args.out))
    records = merge_shards(spec, args.out)
    if not records:
        print("(no completed instances yet — run the sweep first)")
        return 1
    if args.json:
        json.dump(census_summary(records), sys.stdout, indent=1, sort_keys=True)
        print()
    else:
        print(census_tables(records, name=spec.name))
    return 0


def main(argv: Optional[List[str]] = None, prog: Optional[str] = None) -> int:
    ap = argparse.ArgumentParser(
        prog=prog or "repro_torch census",
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("plan", help="expand the grid and write spec.json")
    p.add_argument("--out", required=True)
    p.add_argument("--force", action="store_true")
    add_grid_args(p)
    p.set_defaults(fn=cmd_plan)

    p = sub.add_parser("run", help="run/resume the census with N workers")
    p.add_argument("--out", required=True)
    p.add_argument("--workers", type=int, default=1)
    p.add_argument("--max-steps-per-shard", type=int, default=None,
                   help="pause each shard after N engine steps (resumable)")
    add_device_arg(p)
    add_grid_args(p)
    p.set_defaults(fn=cmd_run)

    p = sub.add_parser("work", help="internal: run an assigned shard list")
    p.add_argument("--out", required=True)
    p.add_argument("--shards", required=True, help="comma list of shard ids")
    p.add_argument("--max-steps-per-shard", type=int, default=None)
    add_device_arg(p)
    p.set_defaults(fn=cmd_work)

    p = sub.add_parser("status", help="completed/total per shard")
    p.add_argument("--out", required=True)
    p.set_defaults(fn=cmd_status)

    p = sub.add_parser("merge", help="merge shard JSONLs into merged.jsonl")
    p.add_argument("--out", required=True)
    p.set_defaults(fn=cmd_merge)

    p = sub.add_parser("fsck", help="classify/repair/quarantine store damage")
    add_fsck_args(p)
    p.set_defaults(fn=fsck_command)

    p = sub.add_parser("report", help="anomaly-rate tables (markdown)")
    p.add_argument("--out", required=True)
    p.add_argument("--json", action="store_true",
                   help="raw census_summary JSON instead of markdown")
    p.set_defaults(fn=cmd_report)

    args = ap.parse_args(argv)
    return args.fn(args)


"""Ranking-as-a-service launcher: warm, query, serve, inspect the oracle.

The cache root is an ordinary campaign store (kind ``oracle``, marker
``ocache.json``) — ``queue``/``fsck`` already understand it — and this
CLI adds the serving-side verbs:

    # build the cache from a finished census (+ optional explain store)
    PYTHONPATH=src python -m repro_torch oracle warm \\
        --out CACHE --census CENSUS [--explain EXPLAIN]

    # one query, or a JSONL batch
    PYTHONPATH=src python -m repro_torch oracle query --out CACHE \\
        --family gram --params '{"size": 96, "seed": 0}'
    PYTHONPATH=src python -m repro_torch oracle query --out CACHE \\
        --batch queries.jsonl --json verdicts.jsonl

    # JSONL queries in, JSON verdicts out, background cache refresh
    PYTHONPATH=src python -m repro_torch oracle serve --out CACHE --refresh

    # shards / pending misses / leases
    PYTHONPATH=src python -m repro_torch oracle status --out CACHE

    # background measurement of enqueued misses = the ordinary pull queue
    PYTHONPATH=src python -m repro_torch queue work --out CACHE

Every query line is ``{"family": ..., "params": {...}}`` (optional
``machine``); every verdict line carries ``confidence`` (``measured`` /
``bucketed`` / ``learned_model`` / ``model_only``), the ranked
algorithms, and the anomaly
verdict with the explainer's cause when available. Misses answer
immediately from the analytic cost model and are enqueued for background
measurement — the hot path never blocks.

``warm``, ``query`` and ``status`` build no workload and touch no device.
The misses of a wall-clock census are measured on ``--device`` (default
``cuda``): by ``queue work --device`` and by ``serve --refresh
--device``, whose refresher thread is the only one of the serve process
that touches the card (it may capture CUDA graphs; the serve loop makes
no CUDA call while it answers). A copy of the reference's
``repro.launch.oracle``: what it prints and writes is the reference's.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import threading
from typing import Any, Dict, List, Optional

from repro_torch.launch.cliutil import add_device_arg, add_fsck_args, fsck_command
from repro_torch.serve.cache import (
    CONFIDENCE_MODEL_ONLY,
    SPEC_FILE,
    OracleCache,
    OracleCacheSpec,
)
from repro_torch.serve.oracle import (
    OracleQueue,
    RankingOracle,
    default_machine_name,
    hit_rate,
)


# ------------------------------------------------------------------- warm ---


def cmd_warm(args: argparse.Namespace) -> int:
    from repro_torch.core.sweep import SweepSpec, merge_shards

    spec_path = os.path.join(args.out, SPEC_FILE)
    if os.path.exists(spec_path):
        spec = OracleCacheSpec.load(spec_path)
        if args.census and os.path.abspath(args.census) != os.path.abspath(spec.census):
            print(f"# {args.out} is already a cache for census {spec.census}",
                  file=sys.stderr)
            return 1
    else:
        if not args.census:
            print("# --census is required the first time a cache is warmed",
                  file=sys.stderr)
            return 1
        spec = OracleCacheSpec(
            census=os.path.abspath(args.census),
            explain=os.path.abspath(args.explain) if args.explain else "",
            machine=args.machine,
            model=os.path.abspath(args.model) if args.model else "",
            n_shards=args.shards,
            lru_capacity=args.lru_capacity,
            per_octave=args.per_octave,
        )
    sweep = SweepSpec.load(os.path.join(spec.census, "spec.json"))
    census_records = merge_shards(sweep, spec.census)
    explain_records: List[Dict[str, Any]] = []
    if spec.explain:
        from repro_torch.explain.runner import ExplainSpec, merge_explained

        espec = ExplainSpec.load(os.path.join(spec.explain, "espec.json"))
        explain_records = merge_explained(espec, spec.explain)
    cache = OracleCache.create(args.out, spec)
    machine = default_machine_name(spec, sweep)
    written = cache.warm(census_records, explain_records, machine=machine)
    print(f"# warmed {args.out}: {written} entr{'y' if written == 1 else 'ies'} "
          f"written, {len(cache)} total, machine {machine}, "
          f"{len(census_records)} census + {len(explain_records)} explain "
          f"records")
    return 0


# ------------------------------------------------------------------ query ---


def _emit(verdicts: List[Dict[str, Any]], json_path: str) -> None:
    lines = "".join(
        json.dumps(v, sort_keys=True, separators=(",", ":")) + "\n"
        for v in verdicts
    )
    if json_path:
        tmp = json_path + ".tmp"
        with open(tmp, "w") as fh:
            fh.write(lines)
        os.replace(tmp, json_path)
    else:
        sys.stdout.write(lines)


def _load_batch(path: str) -> List[Dict[str, Any]]:
    with open(path) as fh:
        return [json.loads(line) for line in fh if line.strip()]


def cmd_query(args: argparse.Namespace) -> int:
    oracle = RankingOracle.open(args.out)
    if args.batch:
        queries = _load_batch(args.batch)
    elif args.family:
        queries = [{"family": args.family, "params": json.loads(args.params)}]
    else:
        print("# need --family/--params or --batch", file=sys.stderr)
        return 1
    verdicts = oracle.query_batch(
        queries, machine=args.machine or None, enqueue=not args.no_enqueue,
    )
    _emit(verdicts, args.json)
    anomalies = sum(1 for v in verdicts if v["is_anomaly"])
    enqueued = sum(1 for v in verdicts if v["enqueued"])
    print(f"# {len(verdicts)} quer{'y' if len(verdicts) == 1 else 'ies'}: "
          f"hit rate {hit_rate(verdicts):.2f}, {anomalies} anomalies, "
          f"{enqueued} enqueued for measurement", file=sys.stderr)
    return 0


# ------------------------------------------------------------------ serve ---


def _refresh_loop(root: str, stop: threading.Event, poll: float,
                  device: str = "cuda") -> None:
    """Background refresher: repeatedly drain the cache's pending misses
    through the ordinary lease-guarded pull queue until told to stop,
    measuring wall-clock misses on ``device``. Runs as a daemon thread next
    to the serve loop — the serve loop never waits on it."""
    from repro_torch.core.lease import default_owner
    from repro_torch.launch.queue import drain

    owner = f"oracle-serve:{default_owner()}"
    while not stop.is_set():
        try:
            drain(OracleQueue(root, device=device), owner, say=None)
        except Exception as err:  # keep serving even if a refresh pass dies
            print(f"# refresh pass failed: {err}", file=sys.stderr)
        stop.wait(poll)


def cmd_serve(args: argparse.Namespace) -> int:
    oracle = RankingOracle.open(args.out)
    stop = threading.Event()
    refresher: Optional[threading.Thread] = None
    if args.refresh:
        refresher = threading.Thread(
            target=_refresh_loop, args=(args.out, stop, args.poll, args.device),
            daemon=True,
        )
        refresher.start()
    stream = open(args.queries) if args.queries else sys.stdin
    served = 0
    verdicts: List[Dict[str, Any]] = []
    try:
        for line in stream:
            line = line.strip()
            if not line:
                continue
            q = json.loads(line)
            v = oracle.query(
                str(q["family"]), q["params"],
                machine=q.get("machine") or (args.machine or None),
            )
            verdicts.append(v)
            sys.stdout.write(
                json.dumps(v, sort_keys=True, separators=(",", ":")) + "\n"
            )
            sys.stdout.flush()
            served += 1
            if args.reload_every and served % args.reload_every == 0:
                oracle.reload()
    finally:
        if stream is not sys.stdin:
            stream.close()
        stop.set()
        if refresher is not None:
            refresher.join(timeout=max(60.0, args.poll * 4))
    print(f"# served {served} verdicts: hit rate {hit_rate(verdicts):.2f}",
          file=sys.stderr)
    return 0


# ----------------------------------------------------------------- status ---


def cmd_status(args: argparse.Namespace) -> int:
    import time

    from repro_torch.core.lease import LEASE_CORRUPT, read_lease_ex
    from repro_torch.core.sweep import ShardStore

    cache = OracleCache.open(args.out)
    totals, pendings = cache.miss_totals()
    print(f"# oracle cache {args.out}: {len(cache)} entries, "
          f"{sum(totals)} misses enqueued, {sum(pendings)} pending")
    now = time.time()
    for shard in range(cache.spec.n_shards):
        store = ShardStore(args.out, shard)
        manifest = store.read_manifest() or {}
        lease, lease_state = read_lease_ex(store.lease_path)
        state = "done" if manifest.get("done") else "open"
        holder = ""
        if lease_state == LEASE_CORRUPT:
            holder = " lease CORRUPT (fsck will clear it)"
        elif lease is not None:
            age = lease.age(now)
            holder = (f" leased by {lease.owner} (heartbeat {age:.0f}s ago"
                      f"{', EXPIRED' if lease.expired(now) else ''})")
        n_entries = sum(
            1 for pos in cache._index.values() if pos[0] == shard
        )
        print(f"#   shard {shard:4d}: {n_entries} entries, "
              f"{pendings[shard]}/{totals[shard]} misses pending "
              f"[{state}]{holder}")
    if cache.damaged:
        print(f"# {len(cache.damaged)} damaged line(s) — run: "
              f"python -m repro_torch fsck --out {args.out}")
    return 0


# ------------------------------------------------------------------- main ---


def main(argv: Optional[List[str]] = None, prog: Optional[str] = None) -> int:
    ap = argparse.ArgumentParser(
        prog=prog or "repro_torch oracle",
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("warm", help="build/refresh the cache from merged "
                       "census (+ explain) stores")
    p.add_argument("--out", required=True, help="cache root")
    p.add_argument("--census", default="", help="census store root")
    p.add_argument("--explain", default="",
                   help="explain store root (attaches anomaly causes)")
    p.add_argument("--machine", default="",
                   help="MachineSpec registry name for the cache keys "
                   "(default: derived from the census backend)")
    p.add_argument("--model", default="",
                   help="trained cost model JSON (python -m repro_torch predict "
                   "train): cache misses consult it before the analytic "
                   "roofline and answer with confidence learned_model")
    p.add_argument("--shards", type=int, default=4)
    p.add_argument("--lru-capacity", type=int, default=4096)
    p.add_argument("--per-octave", type=int, default=1,
                   help="shape-bucket granularity (sub-buckets per "
                   "power-of-two octave)")
    p.set_defaults(fn=cmd_warm)

    p = sub.add_parser("query", help="one query or a JSONL batch")
    p.add_argument("--out", required=True)
    p.add_argument("--family", default="")
    p.add_argument("--params", default="{}",
                   help='instance params as JSON, e.g. \'{"size": 96, "seed": 0}\'')
    p.add_argument("--batch", default="",
                   help="JSONL file of {family, params[, machine]} queries")
    p.add_argument("--machine", default="")
    p.add_argument("--json", default="",
                   help="write verdicts to this file instead of stdout")
    p.add_argument("--no-enqueue", action="store_true",
                   help="answer misses from the model without enqueueing "
                   "them for measurement")
    p.set_defaults(fn=cmd_query)

    p = sub.add_parser("serve", help="JSONL queries in (stdin or --queries), "
                       "JSON verdicts out")
    p.add_argument("--out", required=True)
    p.add_argument("--queries", default="",
                   help="read queries from this file instead of stdin")
    p.add_argument("--machine", default="")
    p.add_argument("--refresh", action="store_true",
                   help="drain enqueued misses in a background thread "
                   "while serving")
    p.add_argument("--poll", type=float, default=1.0,
                   help="seconds between background refresh passes")
    p.add_argument("--reload-every", type=int, default=100,
                   help="re-open the cache every N queries to pick up "
                   "background refreshes (0: never)")
    add_device_arg(p)
    p.set_defaults(fn=cmd_serve)

    p = sub.add_parser("status", help="entries, pending misses, leases")
    p.add_argument("--out", required=True)
    p.set_defaults(fn=cmd_status)

    p = sub.add_parser("fsck", help="classify/repair/quarantine cache damage")
    add_fsck_args(p)
    p.set_defaults(fn=fsck_command)

    args = ap.parse_args(argv)
    return args.fn(args)

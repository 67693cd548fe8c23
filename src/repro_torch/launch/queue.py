"""Pull-based work queue — drain one campaign with any number of hosts.

``launch/sweep.py run`` forks workers on ONE box and assigns shards
statically. This launcher inverts that: the shared store directory IS the
queue, and every participating host runs ``queue work`` against it,
repeatedly leasing whichever shard is unfinished and unclaimed
(:mod:`repro_torch.core.lease`), driving it with the ordinary resumable shard
runner, and releasing it. Nothing is assigned; hosts that join late, leave
early, or die mid-chunk just shift which host resumes each shard — and for
the deterministic backends the merged result is byte-identical to a 1-host
run, because a lease takeover is literally the kill/resume path.

    # host A (and B, C, ... — any count, any time, same shared dir)
    PYTHONPATH=src python -m repro_torch queue work --out /shared/census

    # simulate N hosts locally (the CI byte-identity smoke)
    PYTHONPATH=src python -m repro_torch queue run --out DIR --hosts 2

    # who holds what
    PYTHONPATH=src python -m repro_torch queue status --out DIR

The queue resolves the store root's campaign kind through the store-kind
registry (:mod:`repro_torch.core.stores`): ``spec.json`` = a
DiscriminantSweep census, ``espec.json`` = an AnomalyExplainer campaign,
``ocache.json`` = a ranking-oracle cache whose enqueued misses are
measured. A wall-clock census, the explanation of one, or the misses of
an oracle cache over one, runs its workloads on ``--device`` (default
``cuda``);
``queue run`` gives each simulated host a GPU of its own, as ``census run``
does its workers. On-disk
layout per shard (all under ``--out``):

    shard-NNNN.jsonl           append-only records (source of truth)
    shard-NNNN.manifest.json   slim counts + done flag
    shard-NNNN.engine.json     in-flight chunk state (present mid-chunk)
    shard-NNNN.lease.json      held by at most one live host
    shard-NNNN.timings.json    advisory per-stage wall-clock totals

Requirements on the shared filesystem: atomic ``O_EXCL`` create, atomic
rename, and clocks agreeing to well within the lease TTL — POSIX-y NFS
and every local filesystem qualify.

A copy of the reference's ``repro.launch.queue``.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time
import zlib
from typing import Any, Callable, Dict, List, Optional

from repro_torch.core.lease import (
    DEFAULT_HEARTBEAT_INTERVAL,
    DEFAULT_TTL,
    LEASE_CORRUPT,
    LeaseLost,
    acquire_lease_with_backoff,
    read_lease_ex,
)
from repro_torch.core.sweep import ShardStore, StoreDamaged, SweepSpec, shard_counts
from repro_torch.launch.cliutil import add_device_arg, add_fsck_args, fsck_command

SWEEP_SPEC = "spec.json"
EXPLAIN_SPEC = "espec.json"


# ----------------------------------------------------------- the adapters ---


class SweepQueue:
    """A census store as a drainable queue; a wall-clock census runs its
    workloads on ``device``."""

    kind = "sweep"

    def __init__(self, out: str, device: str = "cuda") -> None:
        self.out = out
        self.device = device
        self.spec = SweepSpec.load(os.path.join(out, SWEEP_SPEC))
        self.n_shards = self.spec.n_shards
        self.backend = self.spec.backend

    def shard_totals(self) -> List[int]:
        totals = [0] * self.n_shards
        for inst in self.spec.expand():
            totals[self.spec.shard_of(inst)] += 1
        return totals

    def run_shard(self, shard: int, *, heartbeat, max_steps, progress) -> None:
        from repro_torch.core.sweep import run_shard

        run_shard(
            self.spec, self.out, shard,
            max_steps=max_steps, progress=progress, heartbeat=heartbeat,
            device=self.device,
        )

    def merge(self) -> str:
        from repro_torch.core.sweep import write_merged

        return write_merged(self.spec, self.out)

    def progress(self) -> Dict[str, int]:
        from repro_torch.core.sweep import sweep_progress

        prog = sweep_progress(self.spec, self.out)
        return {"completed": prog["completed"], "total": prog["instances"]}


class ExplainQueue:
    """An explanation-campaign store as a drainable queue; a wall-clock
    census's anomalies are explained on ``device``."""

    kind = "explain"

    def __init__(self, out: str, device: str = "cuda") -> None:
        from repro_torch.explain.runner import ExplainSpec, explain_targets

        self.out = out
        self.device = device
        self.espec = ExplainSpec.load(os.path.join(out, EXPLAIN_SPEC))
        self.n_shards = self.espec.n_shards
        #: (sweep spec, anomaly work list) — parsed once per host process
        self.census = explain_targets(self.espec)
        self.backend = self.census[0].backend

    def shard_totals(self) -> List[int]:
        from repro_torch.explain.runner import shard_targets

        _, targets = self.census
        return [
            len(shard_targets(self.espec, targets, s))
            for s in range(self.n_shards)
        ]

    def run_shard(self, shard: int, *, heartbeat, max_steps, progress) -> None:
        from repro_torch.explain.runner import run_explain_shard

        run_explain_shard(
            self.espec, self.out, shard,
            max_steps=max_steps, progress=progress,
            census=self.census, heartbeat=heartbeat,
            device=self.device,
        )

    def merge(self) -> str:
        from repro_torch.explain.runner import write_merged_explained

        return write_merged_explained(self.espec, self.out)

    def progress(self) -> Dict[str, int]:
        from repro_torch.explain.runner import explain_progress

        _, targets = self.census
        prog = explain_progress(self.espec, self.out, targets=targets)
        return {"completed": prog["completed"], "total": prog["anomalies"]}


def open_queue(out: str, device: str = "cuda"):
    """The store's adapter, auto-detected through the store-kind registry
    (:mod:`repro_torch.core.stores`): which registered spec file the root
    holds decides the drain path, and a root holding more than one refuses
    rather than guessing."""
    from repro_torch.core.stores import AmbiguousStore, detect_store_kind, store_kinds

    try:
        kind = detect_store_kind(out)
    except AmbiguousStore as err:
        raise SystemExit(str(err)) from None
    if kind is None:
        known = ", ".join(f"{k.name} ({k.spec_file})" for k in store_kinds())
        raise SystemExit(
            f"{out} holds no campaign spec — known store kinds: {known}; "
            "plan a campaign there first"
        )
    return kind.make_queue(out, device=device)


# ------------------------------------------------------------- the worker ---


def _shard_done(out: str, shard: int) -> bool:
    manifest = ShardStore(out, shard).read_manifest()
    return bool(manifest and manifest.get("done"))


def drain(
    queue: Any,
    owner: str,
    *,
    ttl: float = DEFAULT_TTL,
    interval: float = DEFAULT_HEARTBEAT_INTERVAL,
    poll: float = 1.0,
    max_steps: Optional[int] = None,
    say: Optional[Callable[[str], None]] = None,
) -> bool:
    """One host's pull loop: lease-an-unfinished-shard, run it, release,
    repeat, until every shard's manifest says done. Dead hosts' shards are
    adopted once their lease TTL expires (the acquire path breaks expired
    leases); losing our own lease mid-shard (:class:`LeaseLost`) abandons
    that shard without committing and moves on.

    Returns True when the whole campaign is drained. With ``max_steps``
    set, each shard is driven at most once and the loop exits after one
    sweep over the shards (possibly leaving paused, resumable shards) —
    the deadline/test entry point.

    Degradation: a shard whose store turns out to be damaged
    (:class:`StoreDamaged` — mid-file corruption that only fsck may
    repair) is released and remembered, never retried by this host; when
    every unfinished shard is damaged the drain returns False instead of
    spinning, and the operator runs fsck. Lease acquisition uses bounded
    jittered backoff, so transient IO errors and thundering-herd
    contention degrade to a later pass rather than a crash.
    """
    tell = say or (lambda msg: None)
    n = queue.n_shards
    # spread hosts across the ring so they don't all fight for shard 0
    start = zlib.adler32(owner.encode("utf-8")) % max(1, n)
    order = list(range(start, n)) + list(range(start))
    single_pass = max_steps is not None
    damaged: set = set()
    while True:
        worked = False
        all_done = True
        for shard in order:
            if _shard_done(queue.out, shard):
                continue
            all_done = False
            if shard in damaged:
                continue
            lease = acquire_lease_with_backoff(
                ShardStore(queue.out, shard).lease_path, owner,
                ttl=ttl, interval=interval,
            )
            if lease is None:
                continue  # a live host has it (or IO kept failing)
            tell(f"{owner}: leased shard {shard}")
            try:
                queue.run_shard(
                    shard,
                    heartbeat=lease.heartbeat,
                    max_steps=max_steps,
                    progress=tell,
                )
            except LeaseLost:
                tell(f"{owner}: lost shard {shard} lease (taken over); "
                     "moving on")
                continue
            except StoreDamaged as err:
                damaged.add(shard)
                lease.release()
                tell(f"{owner}: shard {shard} store is damaged ({err}); "
                     "re-enqueued for after fsck, moving on")
                continue
            lease.release()
            worked = True
        if all_done:
            return True
        pending = [s for s in order
                   if s not in damaged and not _shard_done(queue.out, s)]
        if damaged and not pending:
            tell(f"{owner}: every unfinished shard is damaged "
                 f"({sorted(damaged)}) — run fsck, then drain again")
            return False
        if single_pass:
            return False
        if not worked:
            # everything unfinished is leased elsewhere: wait for either a
            # release (done) or a TTL expiry (dead host) to free a shard
            time.sleep(poll)


# ------------------------------------------------------------- subcommands ---


def _owner(args: argparse.Namespace) -> str:
    from repro_torch.core.lease import default_owner

    if args.host:
        import uuid

        return f"{args.host}:{os.getpid()}:{uuid.uuid4().hex[:8]}"
    return default_owner()


def cmd_work(args: argparse.Namespace) -> int:
    queue = open_queue(args.out, device=args.device)
    owner = _owner(args)
    done = drain(
        queue, owner,
        ttl=args.ttl, interval=args.heartbeat, poll=args.poll,
        max_steps=args.max_steps_per_shard,
        say=lambda msg: print(f"# {msg}", flush=True),
    )
    prog = queue.progress()
    print(f"# {owner}: {prog['completed']}/{prog['total']} complete "
          f"({'drained' if done else 'paused'})")
    return 0


def cmd_run(args: argparse.Namespace) -> int:
    """Simulate N hosts locally: N ``work`` subprocesses over one store."""
    from repro_torch.launch.sweep import worker_envs

    queue = open_queue(args.out, device=args.device)
    hosts = max(1, args.hosts)
    envs = worker_envs(hosts, queue.backend, args.device)
    procs: List[subprocess.Popen] = []
    for h in range(hosts):
        cmd = [
            sys.executable, "-m", "repro_torch", "queue", "work",
            "--out", args.out, "--host", f"simhost-{h}",
            "--ttl", str(args.ttl), "--heartbeat", str(args.heartbeat),
            "--poll", str(args.poll), "--device", args.device,
        ]
        if args.max_steps_per_shard is not None:
            cmd += ["--max-steps-per-shard", str(args.max_steps_per_shard)]
        procs.append(subprocess.Popen(cmd, env=envs[h]))
    rcs = [p.wait() for p in procs]
    failed = [(h, rc) for h, rc in enumerate(rcs) if rc != 0]
    prog = queue.progress()
    print(f"# {prog['completed']}/{prog['total']} complete "
          f"({queue.kind}, {hosts} hosts)")
    if failed:
        for h, rc in failed:
            print(f"# host {h} exited {rc}", file=sys.stderr)
        print("# re-run the same command to resume", file=sys.stderr)
        return 1
    if prog["completed"] == prog["total"]:
        try:
            print(f"# merged: {queue.merge()}")
        except StoreDamaged as err:
            print(f"# merge refused: {err}", file=sys.stderr)
            return 1
    return 0


def cmd_status(args: argparse.Namespace) -> int:
    queue = open_queue(args.out)
    totals = queue.shard_totals()
    prog = queue.progress()
    print(f"# {queue.kind} queue {args.out}: "
          f"{prog['completed']}/{prog['total']} complete")
    now = time.time()
    total_damaged = 0
    for shard in range(queue.n_shards):
        store = ShardStore(queue.out, shard)
        counts = shard_counts(store)
        lease, lease_state = read_lease_ex(store.lease_path)
        state = "done" if counts["done_flag"] else "open"
        holder = ""
        if lease_state == LEASE_CORRUPT:
            holder = " lease CORRUPT (fsck will clear it)"
        elif lease is not None:
            age = lease.age(now)
            holder = (f" leased by {lease.owner} "
                      f"(heartbeat {age:.0f}s ago"
                      f"{', EXPIRED' if lease.expired(now) else ''})")
        damage = ""
        if counts.get("damaged"):
            total_damaged += counts["damaged"]
            damage = f" DAMAGED x{counts['damaged']}"
        print(f"#   shard {shard:4d}: {counts['done']}/{totals[shard]} "
              f"[{state}]{holder}{damage}")
    if total_damaged:
        print(f"# {total_damaged} damaged record line(s) — merge will "
              f"refuse; run: python -m repro_torch fsck --out {args.out}")
    return 0


def main(argv: Optional[List[str]] = None, prog: Optional[str] = None) -> int:
    ap = argparse.ArgumentParser(
        prog=prog or "repro_torch queue",
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    sub = ap.add_subparsers(dest="cmd", required=True)

    def add_worker_args(p: argparse.ArgumentParser) -> None:
        p.add_argument("--out", required=True,
                       help="shared store root (sweep or explain)")
        p.add_argument("--ttl", type=float, default=DEFAULT_TTL,
                       help="seconds without a heartbeat before a lease "
                       "counts as dead and may be adopted")
        p.add_argument("--heartbeat", type=float,
                       default=DEFAULT_HEARTBEAT_INTERVAL,
                       help="seconds between lease heartbeats (<< ttl)")
        p.add_argument("--poll", type=float, default=1.0,
                       help="seconds between queue polls when all "
                       "unfinished shards are leased elsewhere")
        p.add_argument("--max-steps-per-shard", type=int, default=None,
                       help="pause each shard after N engine steps and make "
                       "one pass only (resumable)")
        add_device_arg(p)

    p = sub.add_parser("work", help="pull worker: lease+run shards until "
                       "the campaign is drained")
    add_worker_args(p)
    p.add_argument("--host", default="",
                   help="host label for the lease owner token "
                   "(default: the real hostname)")
    p.set_defaults(fn=cmd_work)

    p = sub.add_parser("run", help="simulate N hosts locally (N work "
                       "subprocesses over one store)")
    add_worker_args(p)
    p.add_argument("--hosts", type=int, default=2)
    p.set_defaults(fn=cmd_run)

    p = sub.add_parser("status", help="per-shard progress + lease holders")
    p.add_argument("--out", required=True)
    p.set_defaults(fn=cmd_status)

    p = sub.add_parser("fsck", help="classify/repair/quarantine store damage")
    add_fsck_args(p)
    p.set_defaults(fn=fsck_command)

    args = ap.parse_args(argv)
    return args.fn(args)


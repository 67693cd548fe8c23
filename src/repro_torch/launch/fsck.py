"""fsck for campaign stores — classify, repair, quarantine.

A store that survived chaos (host kills, torn appends, bitrot, foreign
writes) holds a mix of perfectly good records and damage. ``merge``
refuses to run over damage (:class:`repro_torch.core.sweep.StoreDamaged`)
because silently skipping unreadable lines publishes a census missing
rows it claims to have. This tool is the repair path:

    PYTHONPATH=src python -m repro_torch fsck --out DIR [--dry-run]

(also reachable as ``repro_torch census fsck`` / ``repro_torch explain
fsck`` / ``repro_torch queue fsck`` / ``repro_torch oracle fsck`` — all
five routes share one flag set,
:func:`repro_torch.launch.cliutil.add_fsck_args`).

For every shard it classifies damage and acts:

``torn_tail``
    the final line is unterminated or unreadable — a SIGKILL mid-append.
    The batch never committed; the bytes are quarantined and the file
    truncated back to the last whole record. Nothing is lost.
``mid_file_corruption`` / ``checksum_mismatch``
    an interior line that does not decode / decodes but fails its own
    ``_crc``. The damaged line is **excised** (quarantined byte-for-byte
    into ``quarantine/``) and the shard's ``done`` flag cleared, so the
    next drain re-runs exactly the missing instances — records are pure
    functions of (spec, seed, index), so the re-measured rows are
    byte-identical to the lost ones and the post-repair merge matches a
    never-damaged run.
``manifest_drift``
    the slim manifest disagrees with the JSONL (stale counts, wrong
    rolling CRC, legacy format). Rebuilt from the records — the JSONL is
    the source of truth.
``corrupt_lease`` / ``stale_lease``
    half-written lease JSON (carries no heartbeat, would block the shard
    forever) or an expired one — quarantined / removed. A **live** lease
    skips that shard's repairs entirely: fsck never races an active
    worker.
``corrupt_engine_state``
    unreadable in-flight chunk state — quarantined; the chunk re-runs
    deterministically from its records.
``leftover_tmp``
    orphaned ``*.tmp`` / lease graves from interrupted atomic renames —
    quarantined.
``damaged_merged``
    a torn/corrupt ``merged.jsonl`` — quarantined; ``merge`` regenerates
    it from the shards.

Every action lands in ``quarantine/damage-report.json`` (machine-readable:
one finding per damage site with its classification, action, and the
quarantined byte count). Exit status: 0 when the store is clean or fully
repaired, 1 when damage remains (``--dry-run``, or shards skipped under a
live lease).

A copy of the reference's ``repro.launch.fsck``: it reports and repairs a
store exactly as the reference does.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import sys
import time
import zlib
from dataclasses import asdict, dataclass, field
from typing import Any, Dict, List, Optional

from repro_torch.core.lease import LEASE_CORRUPT, LEASE_OK, read_lease_ex
from repro_torch.core.sweep import (
    LINE_CRC_MISMATCH,
    LINE_LEGACY,
    LINE_OK,
    LINE_UNDECODABLE,
    ShardStore,
    parse_record_line,
)

QUARANTINE_DIR = "quarantine"
REPORT_FILE = "damage-report.json"

#: artifacts whose *absence* of a pattern match means "foreign file, leave it"
_SHARD_RE = re.compile(r"^shard-(\d{4})\.jsonl$")
_TMP_RE = re.compile(r"(\.tmp(\.[0-9a-f]+)?|\.stale\.[0-9a-f]+)$")


@dataclass
class Finding:
    """One damage site: what it is, where, and what fsck did about it."""

    kind: str                 #: classification (torn_tail, manifest_drift, ...)
    path: str                 #: damaged file (relative to the store root)
    action: str               #: repaired | quarantined | skipped | would_repair...
    shard: Optional[int] = None
    line: Optional[int] = None        #: 1-based, for record-line damage
    bytes_quarantined: int = 0
    detail: str = ""

    def to_dict(self) -> Dict[str, Any]:
        d = asdict(self)
        if d["bytes_quarantined"] == 0:
            del d["bytes_quarantined"]
        return {k: v for k, v in d.items() if v is not None and v != ""}


@dataclass
class FsckReport:
    out: str
    kind: str                 #: sweep | explain | oracle | ambiguous | unknown
    n_shards: int
    dry_run: bool
    findings: List[Finding] = field(default_factory=list)

    @property
    def clean(self) -> bool:
        return not self.findings

    @property
    def remaining(self) -> int:
        """Damage NOT resolved: dry-run findings and live-lease skips."""
        return sum(1 for f in self.findings
                   if not f.action.startswith(("repaired", "quarantined")))

    def to_dict(self) -> Dict[str, Any]:
        counts: Dict[str, int] = {}
        for f in self.findings:
            counts[f.kind] = counts.get(f.kind, 0) + 1
        return {
            "out": self.out,
            "store_kind": self.kind,
            "n_shards": self.n_shards,
            "dry_run": self.dry_run,
            "clean": self.clean,
            "remaining": self.remaining,
            "by_kind": counts,
            "findings": [f.to_dict() for f in self.findings],
        }


def _store_kind(out: str) -> str:
    """The root's campaign kind, via the store-kind registry. fsck never
    refuses to run: an ambiguous root (two kinds' spec files) reports
    ``"ambiguous"`` and falls back to shard-file scanning."""
    from repro_torch.core.stores import AmbiguousStore, detect_store_kind

    try:
        kind = detect_store_kind(out)
    except AmbiguousStore:
        return "ambiguous"
    return kind.name if kind is not None else "unknown"


def _detect_n_shards(out: str) -> int:
    """Shard count from the spec when possible, else from the files on
    disk — fsck must work even when the spec itself is the casualty."""
    from repro_torch.core.stores import AmbiguousStore, detect_store_kind

    try:
        kind = detect_store_kind(out)
        if kind is not None:
            return kind.load_n_shards(out)
    except (AmbiguousStore, OSError, ValueError, KeyError, TypeError):
        pass
    highest = -1
    for fn in os.listdir(out):
        m = _SHARD_RE.match(fn)
        if m:
            highest = max(highest, int(m.group(1)))
    return highest + 1


def _quarantine(out: str, name: str, data: bytes, *, dry_run: bool) -> str:
    """Write damaged bytes into ``quarantine/`` (unique name), return the
    relative path."""
    rel = os.path.join(QUARANTINE_DIR, name)
    if not dry_run:
        qdir = os.path.join(out, QUARANTINE_DIR)
        os.makedirs(qdir, exist_ok=True)
        path = os.path.join(out, rel)
        n = 1
        while os.path.exists(path):
            rel = os.path.join(QUARANTINE_DIR, f"{name}.{n}")
            path = os.path.join(out, rel)
            n += 1
        with open(path, "wb") as fh:
            fh.write(data)
    return rel


def _act(action: str, dry_run: bool) -> str:
    return f"would_{action}" if dry_run else action


def _fsck_records(out: str, shard: int, report: FsckReport) -> bool:
    """Scan + repair one shard's JSONL and manifest. Returns True when
    records were LOST (excised/truncated) — the caller clears ``done``."""
    dry = report.dry_run
    store = ShardStore(out, shard)
    rel_records = os.path.basename(store.records_path)
    if not os.path.exists(store.records_path):
        return False
    with open(store.records_path, "rb") as fh:
        data = fh.read()
    lines = data.splitlines(keepends=True)
    # the old manifest's byte watermark is the commit record: a damaged
    # FINAL line past it is an uncommitted torn tail (truncating loses
    # nothing), but one at-or-under it was a committed record (last-line
    # bitrot) — that is data loss, and `done` must be cleared or the
    # queue would never re-run the excised instance
    old = store.read_manifest()
    watermark = int(old.get("records_bytes", 0)) if old else 0
    good: List[bytes] = []
    lost = False
    offset = 0
    for i, line in enumerate(lines):
        offset += len(line)
        last = i == len(lines) - 1
        terminated = line.endswith(b"\n")
        rec, status = parse_record_line(line) if terminated else (None, "torn")
        if terminated and status in (LINE_OK, LINE_LEGACY):
            good.append(line)
            continue
        if last and offset > watermark:
            # unterminated or unreadable final line the manifest never
            # committed: the batch never landed — truncating loses nothing
            q = _quarantine(out, f"shard-{shard:04d}.tail.torn", line,
                            dry_run=dry)
            report.findings.append(Finding(
                kind="torn_tail", path=rel_records, shard=shard,
                line=i + 1, action=_act("repaired", dry),
                bytes_quarantined=len(line),
                detail=f"unterminated/{status} tail truncated -> {q}",
            ))
        else:
            kind = ("checksum_mismatch" if status == LINE_CRC_MISMATCH
                    else "mid_file_corruption")
            q = _quarantine(
                out, f"shard-{shard:04d}.line-{i + 1:05d}.{status}", line,
                dry_run=dry)
            report.findings.append(Finding(
                kind=kind, path=rel_records, shard=shard, line=i + 1,
                action=_act("quarantined", dry), bytes_quarantined=len(line),
                detail=f"record excised -> {q}; instance will be re-run",
            ))
            lost = True
    repaired_data = b"".join(good)
    file_changed = repaired_data != data
    if file_changed and not dry:
        tmp = store.records_path + ".fsck.tmp"
        with open(tmp, "wb") as fh:
            fh.write(repaired_data)
            fh.flush()
            os.fsync(fh.fileno())
        os.replace(tmp, store.records_path)

    # ------------------------------------------------------ the manifest ---
    # recompute the slim manifest from the (repaired) records — the JSONL
    # is the source of truth; drop `done` whenever records were lost so
    # the queue re-drains exactly the missing instances
    n_completed = 0
    by_family: Dict[str, Dict[str, int]] = {}
    crc = 0
    for line in good:
        rec, _ = parse_record_line(line)
        n_completed += 1
        fam = by_family.setdefault(
            str(rec.get("family", "?")), {"done": 0, "anomalies": 0})
        fam["done"] += 1
        if rec.get("is_anomaly"):
            fam["anomalies"] += 1
        if rec.get("provenance") == "predicted":
            fam["predicted"] = fam.get("predicted", 0) + 1
        crc = zlib.crc32(line, crc)
    truth = {
        "shard": shard,
        "n_completed": n_completed,
        "records_bytes": len(repaired_data),
        "records_crc32": format(crc & 0xFFFFFFFF, "08x"),
        "by_family": by_family,
    }
    old = store.read_manifest()
    keep_done = bool(old and old.get("done")) and not lost
    if keep_done:
        truth["done"] = True
    stale = old is None or any(old.get(k) != v for k, v in truth.items()) \
        or (bool(old.get("done")) and not keep_done)
    if stale and (old is not None or good):
        rel_manifest = os.path.basename(store.manifest_path)
        if old is None:
            why = "manifest missing"
        else:
            diff = [k for k, v in truth.items() if old.get(k) != v]
            if bool(old.get("done")) and not keep_done:
                diff.append("done")
            why = f"stale fields: {', '.join(diff)}"
        report.findings.append(Finding(
            kind="manifest_drift", path=rel_manifest, shard=shard,
            action=_act("repaired", dry), detail=f"rebuilt from records ({why})",
        ))
        if not dry:
            tmp = store.manifest_path + ".fsck.tmp"
            with open(tmp, "w") as fh:
                json.dump(truth, fh, indent=1, sort_keys=True)
                fh.flush()
                os.fsync(fh.fileno())
            os.replace(tmp, store.manifest_path)
    return lost


def _fsck_sidecars(out: str, shard: int, report: FsckReport) -> None:
    """Lease + engine-state health for one shard (records already done)."""
    dry = report.dry_run
    store = ShardStore(out, shard)
    if os.path.exists(store.engine_path):
        try:
            with open(store.engine_path) as fh:
                json.load(fh)
        except (OSError, ValueError):
            with open(store.engine_path, "rb") as fh:
                blob = fh.read()
            q = _quarantine(out, f"shard-{shard:04d}.engine.corrupt.json",
                            blob, dry_run=dry)
            report.findings.append(Finding(
                kind="corrupt_engine_state",
                path=os.path.basename(store.engine_path), shard=shard,
                action=_act("quarantined", dry), bytes_quarantined=len(blob),
                detail=f"-> {q}; chunk re-runs deterministically",
            ))
            if not dry:
                os.remove(store.engine_path)


def _fsck_lease(out: str, shard: int, report: FsckReport) -> bool:
    """Classify the shard's lease. Returns True when a LIVE owner holds it
    — the shard must be skipped (fsck never races an active worker)."""
    dry = report.dry_run
    store = ShardStore(out, shard)
    rel = os.path.basename(store.lease_path)
    info, state = read_lease_ex(store.lease_path)
    if state == LEASE_CORRUPT:
        try:
            with open(store.lease_path, "rb") as fh:
                blob = fh.read()
        except OSError:
            blob = b""
        q = _quarantine(out, f"shard-{shard:04d}.lease.corrupt.json", blob,
                        dry_run=dry)
        report.findings.append(Finding(
            kind="corrupt_lease", path=rel, shard=shard,
            action=_act("quarantined", dry), bytes_quarantined=len(blob),
            detail=f"half-written lease -> {q}; shard is stealable again",
        ))
        if not dry:
            try:
                os.remove(store.lease_path)
            except OSError:
                pass
        return False
    if state == LEASE_OK:
        if info.expired():
            report.findings.append(Finding(
                kind="stale_lease", path=rel, shard=shard,
                action=_act("repaired", dry),
                detail=f"owner {info.owner} silent {info.age():.0f}s "
                       f"(ttl {info.ttl:.0f}s); removed",
            ))
            if not dry:
                try:
                    os.remove(store.lease_path)
                except OSError:
                    pass
            return False
        report.findings.append(Finding(
            kind="live_lease", path=rel, shard=shard, action="skipped",
            detail=f"held by {info.owner} (heartbeat {info.age():.0f}s ago) "
                   "— shard left untouched",
        ))
        return True
    return False


def _fsck_merged(out: str, report: FsckReport) -> None:
    """A merged.jsonl with any unreadable line is quarantined whole — it is
    derived data; ``merge`` regenerates it from the shards."""
    dry = report.dry_run
    path = os.path.join(out, "merged.jsonl")
    if not os.path.exists(path):
        return
    with open(path, "rb") as fh:
        data = fh.read()
    ok = True
    bad_line = 0
    for i, line in enumerate(data.splitlines(keepends=True)):
        if not line.endswith(b"\n"):
            ok, bad_line = False, i + 1
            break
        _, status = parse_record_line(line)
        if status in (LINE_UNDECODABLE, LINE_CRC_MISMATCH):
            ok, bad_line = False, i + 1
            break
    if ok:
        return
    q = _quarantine(out, "merged.damaged.jsonl", data, dry_run=dry)
    report.findings.append(Finding(
        kind="damaged_merged", path="merged.jsonl", line=bad_line,
        action=_act("quarantined", dry), bytes_quarantined=len(data),
        detail=f"-> {q}; re-run merge to regenerate",
    ))
    if not dry:
        os.remove(path)


def _fsck_leftovers(out: str, report: FsckReport) -> None:
    dry = report.dry_run
    for fn in sorted(os.listdir(out)):
        if not _TMP_RE.search(fn):
            continue
        path = os.path.join(out, fn)
        if not os.path.isfile(path):
            continue
        try:
            with open(path, "rb") as fh:
                blob = fh.read()
        except OSError:
            continue
        q = _quarantine(out, fn, blob, dry_run=dry)
        report.findings.append(Finding(
            kind="leftover_tmp", path=fn, action=_act("quarantined", dry),
            bytes_quarantined=len(blob),
            detail=f"orphaned atomic-rename temp -> {q}",
        ))
        if not dry:
            os.remove(path)


def fsck_store(out: str, *, dry_run: bool = False) -> FsckReport:
    """Scan ``out``, repair/quarantine what can be, report everything.

    Safe to run on a live store: shards under an unexpired lease are
    reported but left untouched. Idempotent — a second run on a repaired
    store finds nothing."""
    if not os.path.isdir(out):
        raise SystemExit(f"{out} is not a directory")
    report = FsckReport(out=out, kind=_store_kind(out),
                        n_shards=_detect_n_shards(out), dry_run=dry_run)
    for shard in range(report.n_shards):
        if _fsck_lease(out, shard, report):
            continue  # live owner: their shard, their problem
        _fsck_records(out, shard, report)
        _fsck_sidecars(out, shard, report)
    _fsck_merged(out, report)
    _fsck_leftovers(out, report)
    if not dry_run:
        qdir = os.path.join(out, QUARANTINE_DIR)
        os.makedirs(qdir, exist_ok=True)
        tmp = os.path.join(qdir, REPORT_FILE + ".tmp")
        doc = dict(report.to_dict(), generated_at=time.time())
        with open(tmp, "w") as fh:
            json.dump(doc, fh, indent=1, sort_keys=True)
        os.replace(tmp, os.path.join(qdir, REPORT_FILE))
    return report


def print_report(report: FsckReport, say=print) -> None:
    mode = " (dry run)" if report.dry_run else ""
    if report.clean:
        say(f"# fsck {report.out}: clean ({report.kind}, "
            f"{report.n_shards} shards){mode}")
        return
    say(f"# fsck {report.out}: {len(report.findings)} finding(s) "
        f"({report.kind}, {report.n_shards} shards){mode}")
    for f in report.findings:
        where = f.path + (f":{f.line}" if f.line else "")
        say(f"#   [{f.kind}] {where} — {f.action}"
            + (f" ({f.detail})" if f.detail else ""))
    if not report.dry_run:
        say(f"# report: {os.path.join(report.out, QUARANTINE_DIR, REPORT_FILE)}")
    if report.remaining:
        say(f"# {report.remaining} finding(s) unresolved")


def run_fsck(out: str, *, dry_run: bool = False, say=print) -> int:
    """The shared entry point behind ``fsck`` and the launcher
    subcommands. Returns a process exit code."""
    report = fsck_store(out, dry_run=dry_run)
    print_report(report, say)
    return 1 if report.remaining else 0


def main(argv: Optional[List[str]] = None, prog: Optional[str] = None) -> int:
    from repro_torch.launch.cliutil import add_fsck_args

    ap = argparse.ArgumentParser(
        prog=prog or "repro_torch fsck",
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    add_fsck_args(ap)
    args = ap.parse_args(argv)
    return run_fsck(args.out, dry_run=args.dry_run)


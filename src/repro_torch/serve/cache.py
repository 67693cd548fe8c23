"""Two-tier ranking cache behind the serving oracle.

The census and the explainer answer "which algorithm wins, and why does
FLOPs lie here?" offline; :mod:`repro_torch.serve.oracle` serves those answers
online. This module is the storage layer between the two worlds:

* **Tier 1** — an in-memory LRU of decoded cache entries (the hot path:
  a warmed key costs two dict lookups, no IO, no json).
* **Tier 2** — a persistent on-disk store of the same entries, one
  CRC-checksummed JSONL shard file per hash bucket, written through the
  census's own :class:`repro_torch.core.sweep.ShardStore` so every durability
  idiom carries over unchanged: torn-tail truncation, mid-file damage
  refusal, slim manifests, leases, and fsck repair (the store registers
  its own :class:`repro_torch.core.stores.StoreKind` — spec file
  ``ocache.json`` — so ``queue``/``fsck`` auto-detect cache roots).

Entries are keyed ``family|shape-bucket|machine`` — the shape bucket is
the repo's ONE bucketing rule (:func:`repro_torch.configs.shapes.shape_bucket`,
shared with the census report tables), so an oracle answer and a report
row always agree about which bucket an instance belongs to. An entry
aggregates every census record that fell into its bucket (per-algorithm
modal rank + vote-share confidence) and keeps the per-record digests in
``sources``, so a query for an instance the census actually measured can
answer byte-identically to the census record instead of the aggregate.

Updates are append-only: a refreshed entry is appended with a bumped
``seq`` and the scan index keeps the latest — exactly the census's
"the JSONL is the source of truth" contract, which is what lets fsck
repair a damaged cache shard like any other shard.

Cache *misses* are durable too: :meth:`OracleCache.enqueue_miss` appends
the missed instance to a per-shard ``miss-NNNN.jsonl`` (same CRC'd line
format) and clears the shard's manifest ``done`` flag, which re-opens the
shard to the ordinary pull queue — any ``queue work`` host then measures
the miss under the census's own spec and refreshes the entry. The hot
path never waits on any of that.

The serving path imports nothing heavier than the census's store code
and touches no device. A copy of the reference's ``repro.serve.cache``:
``ocache.json``, every cache shard and every miss line are the
reference's byte for byte.
"""

from __future__ import annotations

import dataclasses
import json
import os
import zlib
from collections import OrderedDict
from typing import Any, Dict, Iterable, List, Mapping, Optional, Sequence, Tuple

from repro_torch.configs.shapes import shape_bucket
from repro_torch.core.sweep import (
    LINE_CRC_MISMATCH,
    LINE_UNDECODABLE,
    ShardStore,
    _record_line,
    parse_record_line,
)

#: the cache root's detection marker (see repro_torch.core.stores)
SPEC_FILE = "ocache.json"

#: verdict confidence levels, strongest first
CONFIDENCE_MEASURED = "measured"      #: this exact instance is in the cache
CONFIDENCE_BUCKETED = "bucketed"      #: its (family, bucket, machine) is
CONFIDENCE_LEARNED = "learned_model"  #: trained cost model answered the miss
CONFIDENCE_MODEL_ONLY = "model_only"  #: analytic cost-model fallback


# ----------------------------------------------------------------- the key ---


def cache_key(family: str, bucket: str, machine: str) -> str:
    """``family|bucket|machine``. Family names and machine names never
    contain ``|`` (enforced here), and bucket labels are ``[lo, hi)``."""
    for part in (family, machine):
        if "|" in part:
            raise ValueError(f"cache key part {part!r} contains '|'")
    return f"{family}|{bucket}|{machine}"


def split_key(key: str) -> Tuple[str, str, str]:
    family, bucket, machine = key.split("|", 2)
    return family, bucket, machine


def shard_of_key(key: str, n_shards: int) -> int:
    """Stable hash sharding — every host agrees where a key lives."""
    return zlib.crc32(key.encode("utf-8")) % max(1, n_shards)


# ---------------------------------------------------------------- the spec ---


@dataclasses.dataclass
class OracleCacheSpec:
    """One serving cache, declaratively: where its knowledge comes from
    (a census store, optionally an explain store) and how it is laid out.
    Saved as ``ocache.json`` in the cache root — the store-kind marker."""

    name: str = "oracle"
    #: the census store root this cache is warmed from (and whose
    #: ``spec.json`` defines how misses are measured)
    census: str = ""
    #: optional explain store root (attaches causes to anomaly verdicts)
    explain: str = ""
    #: MachineSpec registry name; empty = derive from the census backend
    #: (the explainer's rule: synthetic machine for cost_model/simulated,
    #: cpu-1core for wall_clock)
    machine: str = ""
    #: optional trained cost model JSON (``repro_torch predict train``): cache
    #: misses consult it before the analytic roofline and answer with
    #: confidence ``learned_model``
    model: str = ""
    n_shards: int = 4
    #: tier-1 capacity (decoded entries held in memory per oracle process)
    lru_capacity: int = 4096
    #: sub-buckets per power-of-two octave in the shape-bucketing rule;
    #: 1 = the census report tables' historical power-of-two buckets
    per_octave: int = 1
    fsync: bool = False

    def __post_init__(self) -> None:
        if self.n_shards < 1:
            raise ValueError("n_shards must be >= 1")
        if self.lru_capacity < 1:
            raise ValueError("lru_capacity must be >= 1")
        if self.per_octave < 1:
            raise ValueError("per_octave must be >= 1")

    def to_dict(self) -> Dict[str, Any]:
        d = dataclasses.asdict(self)
        d["version"] = 1
        return d

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "OracleCacheSpec":
        kwargs = {
            f.name: d[f.name] for f in dataclasses.fields(cls) if f.name in d
        }
        return cls(**kwargs)

    def save(self, path: str) -> str:
        tmp = path + ".tmp"
        with open(tmp, "w") as fh:
            json.dump(self.to_dict(), fh, indent=1, sort_keys=True)
        os.replace(tmp, path)
        return path

    @classmethod
    def load(cls, path: str) -> "OracleCacheSpec":
        with open(path) as fh:
            return cls.from_dict(json.load(fh))


# ------------------------------------------------------------- the entries ---


def source_digest(record: Mapping[str, Any],
                  explained: Optional[Mapping[str, Any]] = None) -> Dict[str, Any]:
    """The per-census-record slice an entry retains: enough to answer a
    ``measured`` query byte-identically to the census record's ranking,
    plus the explainer's cause when that record was explained."""
    digest: Dict[str, Any] = {
        "index": int(record["index"]),
        "size": int(record["size"]),
        "ranks": dict(record["ranks"]),
        "mean_ranks": {k: float(v) for k, v in record["mean_ranks"].items()},
        "is_anomaly": bool(record["is_anomaly"]),
        "reason": record.get("reason", ""),
        "min_flops_algs": list(record.get("min_flops_algs", ())),
        "cause": None,
        "cause_evidence": None,
        "offending_kernel": None,
    }
    if explained is not None:
        digest["cause"] = explained.get("cause")
        digest["cause_evidence"] = explained.get("evidence")
        digest["offending_kernel"] = explained.get("offending_kernel")
    return digest


def _modal(values: Sequence[Any]) -> Tuple[Any, float]:
    """(most common value, vote share); ties break to the smaller value
    so the aggregation is deterministic regardless of source order."""
    counts: Dict[Any, int] = {}
    for v in values:
        counts[v] = counts.get(v, 0) + 1
    winner = min(counts, key=lambda v: (-counts[v], v))
    return winner, counts[winner] / len(values)


def aggregate_entry(key: str, sources: Mapping[str, Mapping[str, Any]],
                    seq: int) -> Dict[str, Any]:
    """One cache entry from its per-record sources: per-algorithm modal
    rank with vote-share confidence, a ranking ordered by mean of
    mean-ranks, and the bucket-level anomaly verdict — the census's rule
    (min-FLOPs algorithm outside the best rank class ⇒ anomaly) applied
    to the modal ranks. Pure function of (key, sources, seq): warming
    twice from the same stores produces byte-identical entries."""
    family, bucket, machine = split_key(key)
    uids = sorted(sources)
    algs = sorted({alg for u in uids for alg in sources[u]["ranks"]})
    ranks: Dict[str, int] = {}
    confidence: Dict[str, float] = {}
    mean_ranks: Dict[str, float] = {}
    for alg in algs:
        votes = [int(sources[u]["ranks"][alg]) for u in uids
                 if alg in sources[u]["ranks"]]
        means = [float(sources[u]["mean_ranks"][alg]) for u in uids
                 if alg in sources[u]["mean_ranks"]]
        ranks[alg], confidence[alg] = _modal(votes)
        mean_ranks[alg] = sum(means) / len(means) if means else float(ranks[alg])
    ranking = [
        {"alg": alg, "rank": ranks[alg],
         "mean_rank": mean_ranks[alg], "confidence": confidence[alg]}
        for alg in sorted(algs, key=lambda a: (mean_ranks[a], a))
    ]
    min_flops_algs = sorted({
        alg for u in uids for alg in sources[u]["min_flops_algs"]
    })
    best_overall = min(ranks.values()) if ranks else 0
    best_in_sf = min(
        (ranks[a] for a in min_flops_algs if a in ranks), default=best_overall
    )
    anomalies = [u for u in uids if sources[u]["is_anomaly"]]
    causes = [sources[u]["cause"] for u in anomalies
              if sources[u].get("cause")]
    cause: Optional[str] = None
    cause_evidence: Optional[float] = None
    if causes:
        cause, _ = _modal(causes)
        evidences = [float(sources[u]["cause_evidence"] or 0.0)
                     for u in anomalies if sources[u].get("cause") == cause]
        cause_evidence = sum(evidences) / len(evidences)
    return {
        "uid": f"{key}#{seq:06d}",
        "key": key,
        "family": family,
        "bucket": bucket,
        "machine": machine,
        "seq": int(seq),
        "n_records": len(uids),
        "anomaly_rate": len(anomalies) / len(uids) if uids else 0.0,
        "is_anomaly": bool(min_flops_algs) and best_in_sf > best_overall,
        "ranking": ranking,
        "ranks": ranks,
        "min_flops_algs": min_flops_algs,
        "cause": cause,
        "cause_evidence": cause_evidence,
        "sources": {u: dict(sources[u]) for u in uids},
    }


# --------------------------------------------------------------- the cache ---


class OracleCache:
    """The two-tier store. :meth:`open` scans the shard JSONLs once and
    keeps only an offset index (key → latest entry's file position) plus
    per-key sequence counters — payloads stay on disk until a query
    promotes them into the LRU, so a million-entry cache opens in one
    pass and serves from O(lru_capacity) memory."""

    def __init__(self, root: str, spec: OracleCacheSpec) -> None:
        self.root = root
        self.spec = spec
        #: key -> (shard, byte offset, byte length) of the latest entry
        self._index: Dict[str, Tuple[int, int, int]] = {}
        self._seq: Dict[str, int] = {}
        self._lru: "OrderedDict[str, Dict[str, Any]]" = OrderedDict()
        self.hits = 0
        self.misses = 0
        #: (shard, line_no, status) of damaged lines seen by the scan
        self.damaged: List[Tuple[int, int, str]] = []

    # ------------------------------------------------------------ lifecycle ---

    @classmethod
    def create(cls, root: str, spec: OracleCacheSpec) -> "OracleCache":
        os.makedirs(root, exist_ok=True)
        spec.save(os.path.join(root, SPEC_FILE))
        return cls.open(root)

    @classmethod
    def open(cls, root: str) -> "OracleCache":
        spec = OracleCacheSpec.load(os.path.join(root, SPEC_FILE))
        cache = cls(root, spec)
        cache._scan()
        return cache

    def _scan(self) -> None:
        self._index.clear()
        self._seq.clear()
        self._lru.clear()
        self.damaged = []
        for shard in range(self.spec.n_shards):
            path = ShardStore(self.root, shard).records_path
            try:
                with open(path, "rb") as fh:
                    data = fh.read()
            except OSError:
                continue
            offset = 0
            lines = data.splitlines(keepends=True)
            for i, line in enumerate(lines):
                if not line.endswith(b"\n"):
                    break  # torn tail: an append in flight or a kill
                rec, status = parse_record_line(line)
                if status in (LINE_UNDECODABLE, LINE_CRC_MISMATCH):
                    if i < len(lines) - 1:
                        self.damaged.append((shard, i + 1, status))
                    offset += len(line)
                    continue
                key = rec.get("key")
                seq = int(rec.get("seq", 0))
                if key and seq >= self._seq.get(key, -1):
                    self._seq[key] = seq
                    self._index[key] = (shard, offset, len(line))
                offset += len(line)

    # -------------------------------------------------------------- reading ---

    def __contains__(self, key: str) -> bool:
        return key in self._index

    def __len__(self) -> int:
        return len(self._index)

    def keys(self) -> List[str]:
        return sorted(self._index)

    def get(self, key: str) -> Optional[Dict[str, Any]]:
        """Tier-1 lookup, falling through to a tier-2 seek+read. Returns
        None on a true miss (the caller's model-only fallback)."""
        entry = self._lru.get(key)
        if entry is not None:
            self._lru.move_to_end(key)
            self.hits += 1
            return entry
        pos = self._index.get(key)
        if pos is None:
            self.misses += 1
            return None
        shard, offset, length = pos
        path = ShardStore(self.root, shard).records_path
        with open(path, "rb") as fh:
            fh.seek(offset)
            line = fh.read(length)
        rec, status = parse_record_line(line)
        if rec is None or status in (LINE_UNDECODABLE, LINE_CRC_MISMATCH):
            # the indexed position rotted under us — treat as a miss and
            # drop the index entry; fsck repairs the shard
            self.damaged.append((shard, -1, status))
            del self._index[key]
            self.misses += 1
            return None
        self._promote(key, rec)
        self.hits += 1
        return rec

    def _promote(self, key: str, entry: Dict[str, Any]) -> None:
        self._lru[key] = entry
        self._lru.move_to_end(key)
        while len(self._lru) > self.spec.lru_capacity:
            self._lru.popitem(last=False)

    def stats(self) -> Dict[str, Any]:
        total = self.hits + self.misses
        return {
            "entries": len(self._index),
            "lru": len(self._lru),
            "hits": self.hits,
            "misses": self.misses,
            "hit_rate": self.hits / total if total else 0.0,
        }

    # -------------------------------------------------------------- writing ---

    def put_many(self, entries: Sequence[Mapping[str, Any]]) -> int:
        """Append entries to their shards (grouped: one writer open and
        one batch per shard), update the index/LRU. Returns the count."""
        by_shard: Dict[int, List[Dict[str, Any]]] = {}
        for entry in entries:
            by_shard.setdefault(
                shard_of_key(entry["key"], self.spec.n_shards), []
            ).append(dict(entry))
        written = 0
        for shard in sorted(by_shard):
            batch = by_shard[shard]
            store = ShardStore(self.root, shard, fsync=self.spec.fsync).open()
            store.append_records(batch)
            manifest = store.read_manifest() or {}
            end = int(manifest.get("records_bytes", 0))
            # walk the batch backwards from the committed end to recover
            # each appended line's file position (lines are canonical, so
            # re-serializing reproduces the committed byte lengths)
            for entry in reversed(batch):
                length = len(_record_line(entry).encode("utf-8"))
                end -= length
                key = entry["key"]
                self._index[key] = (shard, end, length)
                self._seq[key] = max(self._seq.get(key, -1), int(entry["seq"]))
                self._promote(key, entry)
            written += len(batch)
        return written

    def next_seq(self, key: str) -> int:
        return self._seq.get(key, -1) + 1

    # -------------------------------------------------------------- warming ---

    def warm(
        self,
        census_records: Sequence[Mapping[str, Any]],
        explain_records: Iterable[Mapping[str, Any]] = (),
        machine: str = "",
    ) -> int:
        """Build/refresh entries from merged census (+ explain) records.
        Idempotent: a key whose rebuilt sources match the stored entry is
        skipped, so re-warming from unchanged stores writes nothing."""
        explained = {str(r["uid"]): r for r in explain_records}
        grouped: Dict[str, Dict[str, Dict[str, Any]]] = {}
        for record in census_records:
            bucket = shape_bucket(int(record["size"]), self.spec.per_octave)
            key = cache_key(str(record["family"]), bucket, machine)
            uid = str(record["uid"])
            grouped.setdefault(key, {})[uid] = source_digest(
                record, explained.get(uid)
            )
        fresh: List[Dict[str, Any]] = []
        for key in sorted(grouped):
            sources = grouped[key]
            current = self.get(key)
            if current is not None:
                sources = {**current["sources"], **sources}
                if sources == current["sources"]:
                    rebuilt = aggregate_entry(key, sources, current["seq"])
                    if rebuilt == current:
                        continue
            fresh.append(aggregate_entry(key, sources, self.next_seq(key)))
        self.put_many(fresh)
        self.mark_clean_shards_done()
        return len(fresh)

    def refresh_from_record(self, record: Mapping[str, Any], machine: str,
                            explained: Optional[Mapping[str, Any]] = None) -> Dict[str, Any]:
        """Fold one freshly measured census record into its entry (the
        background queue's commit path) and return the new entry."""
        bucket = shape_bucket(int(record["size"]), self.spec.per_octave)
        key = cache_key(str(record["family"]), bucket, machine)
        current = self.get(key)
        sources = dict(current["sources"]) if current else {}
        sources[str(record["uid"])] = source_digest(record, explained)
        entry = aggregate_entry(key, sources, self.next_seq(key))
        self.put_many([entry])
        return entry

    # --------------------------------------------------------------- misses ---

    def miss_path(self, shard: int) -> str:
        return os.path.join(self.root, f"miss-{shard:04d}.jsonl")

    def enqueue_miss(self, *, uid: str, index: int, family: str,
                     params: Mapping[str, Any], machine: str, key: str) -> int:
        """Durably enqueue a missed instance for background measurement
        and re-open its shard to the pull queue. Small append + manifest
        touch — never a measurement; the hot path stays hot. Returns the
        shard the miss landed on."""
        shard = shard_of_key(key, self.spec.n_shards)
        line = _record_line({
            "uid": uid, "index": int(index), "family": family,
            "params": dict(params), "machine": machine, "key": key,
        })
        os.makedirs(self.root, exist_ok=True)
        with open(self.miss_path(shard), "a", encoding="utf-8") as fh:
            fh.write(line)
            fh.flush()
        self._clear_done(shard)
        return shard

    def _clear_done(self, shard: int) -> None:
        store = ShardStore(self.root, shard)
        manifest = store.read_manifest()
        if not manifest or not manifest.get("done"):
            return
        manifest["done"] = False
        tmp = store.manifest_path + ".tmp"
        with open(tmp, "w") as fh:
            json.dump(manifest, fh, indent=1, sort_keys=True)
        os.replace(tmp, store.manifest_path)

    def _miss_lines(self, shard: int) -> List[Dict[str, Any]]:
        try:
            with open(self.miss_path(shard), "rb") as fh:
                data = fh.read()
        except OSError:
            return []
        out: List[Dict[str, Any]] = []
        seen: set = set()
        for line in data.splitlines(keepends=True):
            if not line.endswith(b"\n"):
                break  # torn tail: an enqueue in flight
            rec, status = parse_record_line(line)
            if rec is None or status in (LINE_UNDECODABLE, LINE_CRC_MISMATCH):
                continue  # a damaged miss line only re-misses later
            if rec["uid"] in seen:
                continue
            seen.add(rec["uid"])
            out.append(rec)
        return out

    def pending(self, shard: int) -> List[Dict[str, Any]]:
        """Enqueued misses on ``shard`` not yet folded into their entry,
        deduped, in enqueue order — the background worker's work list."""
        out = []
        for miss in self._miss_lines(shard):
            entry = self.get(miss["key"])
            if entry is not None and miss["uid"] in entry.get("sources", {}):
                continue
            out.append(miss)
        return out

    def miss_totals(self) -> Tuple[List[int], List[int]]:
        """(distinct enqueued misses, still-pending misses) per shard."""
        totals, pendings = [], []
        for shard in range(self.spec.n_shards):
            totals.append(len(self._miss_lines(shard)))
            pendings.append(len(self.pending(shard)))
        return totals, pendings

    def mark_done(self, shard: int) -> None:
        ShardStore(self.root, shard, fsync=self.spec.fsync).open() \
            .write_manifest(done=True)

    def mark_clean_shards_done(self) -> None:
        """Flag every shard with no pending misses done, so a freshly
        warmed cache reads as a drained queue until something misses."""
        for shard in range(self.spec.n_shards):
            if not self.pending(shard):
                self.mark_done(shard)

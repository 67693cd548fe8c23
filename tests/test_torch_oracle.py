"""The port's ranking oracle and its two-tier cache (``repro_torch.serve``)
against the JAX package's (``repro.serve``), in process. Mirrors the 14
tests of ``tests/test_oracle.py`` on the port, and adds what the port must
keep byte for byte: ``ocache.json`` and every cache shard when both
packages warm from the same census and explain directories, the verdicts
of every tier (measured, bucketed, learned, model-only), and a miss
drained by the queue. The wall-clock drain runs here on the plain
versions (``OracleQueue(..., device="cpu")``), and answering queries must
not initialise CUDA."""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import repro.launch.queue as ref_queue  # noqa: E402
import repro.predict.model as ref_model  # noqa: E402
import repro.serve.cache as ref_cache  # noqa: E402
import repro.serve.oracle as ref_oracle  # noqa: E402
import repro_torch.explain.runner as port_runner  # noqa: E402
import repro_torch.predict.model as port_model  # noqa: E402
import repro_torch.serve.cache as port_cache  # noqa: E402
import repro_torch.serve.oracle as port_oracle  # noqa: E402
from repro_torch.core.lease import default_owner  # noqa: E402
from repro_torch.core.stores import detect_store_kind  # noqa: E402
from repro_torch.core.sweep import (  # noqa: E402
    ShardStore,
    StoreDamaged,
    SweepSpec,
    merge_shards,
    run_shard,
    write_merged,
)
from repro_torch.launch.fsck import fsck_store  # noqa: E402
from repro_torch.launch.queue import drain, open_queue  # noqa: E402
from repro_torch.predict.model import train_model  # noqa: E402
from repro_torch.serve.cache import (  # noqa: E402
    CONFIDENCE_BUCKETED,
    CONFIDENCE_LEARNED,
    CONFIDENCE_MEASURED,
    CONFIDENCE_MODEL_ONLY,
    OracleCache,
    OracleCacheSpec,
    aggregate_entry,
    cache_key,
    shard_of_key,
    split_key,
)
from repro_torch.serve.oracle import (  # noqa: E402
    OracleQueue,
    RankingOracle,
    default_machine_name,
    hit_rate,
)

REPO = Path(__file__).resolve().parents[1]

#: tests/test_oracle.py's census
CENSUS = dict(name="oracle-census", n_shards=2, backend="cost_model", dispatch_s=1e-6,
              max_measurements=12,
              families={"gram": {"sizes": [48, 64], "per_size": 3}, "solve": {"sizes": [48], "per_size": 2}})

#: one query per tier on the census above (gram 48/64 and solve 48 warm)
TIER_QUERIES = {
    "measured": ("gram", {"size": 48, "seed": 0}),
    "bucketed": ("gram", {"size": 50, "seed": 777}),
    "miss": ("gram", {"size": 500, "seed": 0}),
    "miss_solve": ("solve", {"size": 200, "seed": 3}),
}


@pytest.fixture(scope="module")
def census(tmp_path_factory):
    """One small deterministic cost-model census, drained and merged."""
    root = str(tmp_path_factory.mktemp("census"))
    spec = SweepSpec(**CENSUS)
    spec.save(os.path.join(root, "spec.json"))
    for shard in range(spec.n_shards):
        run_shard(spec, root, shard, device="cpu")
    write_merged(spec, root)
    return spec, root, merge_shards(spec, root)


def _warmed(tmp_path, census, **spec_overrides):
    spec, root, records = census
    kwargs = dict(census=root, n_shards=2)
    kwargs.update(spec_overrides)
    cspec = OracleCacheSpec(**kwargs)
    cache = OracleCache.create(str(tmp_path / "cache"), cspec)
    cache.warm(records, (), machine=default_machine_name(cspec, spec))
    return RankingOracle.open(cache.root)


def _empty(tmp_path, census, **spec_overrides):
    _, root, _ = census
    kwargs = dict(census=root, n_shards=2)
    kwargs.update(spec_overrides)
    out = str(tmp_path / "cache")
    OracleCache.create(out, OracleCacheSpec(**kwargs))
    return RankingOracle.open(out)


def _store_bytes(root):
    return {p.name: p.read_bytes() for p in sorted(Path(root).iterdir()) if p.is_file()}


# ------------------------------------------------- tests/test_oracle.py ---

def test_cache_key_roundtrip_and_stable_sharding():
    key = cache_key("gram", "[32, 64)", "sweep:census")
    assert split_key(key) == ("gram", "[32, 64)", "sweep:census")
    assert shard_of_key(key, 4) == shard_of_key(key, 4) == ref_cache.shard_of_key(key, 4)
    assert 0 <= shard_of_key(key, 4) < 4
    with pytest.raises(ValueError):
        cache_key("gr|am", "[32, 64)", "m")


def test_warm_cache_answers_measured_byte_identical(tmp_path, census):
    _, _, records = census
    oracle = _warmed(tmp_path, census)
    verdicts = oracle.query_batch([{"family": r["family"], "params": r["params"]} for r in records],
                                  enqueue=False)
    assert hit_rate(verdicts) == 1.0
    for verdict, record in zip(verdicts, records):
        assert verdict["confidence"] == CONFIDENCE_MEASURED
        assert verdict["uid"] == record["uid"]
        assert json.dumps(verdict["ranks"], sort_keys=True) == json.dumps(record["ranks"], sort_keys=True)
        assert verdict["is_anomaly"] == record["is_anomaly"]
        assert verdict["min_flops_algs"] == record["min_flops_algs"]
        assert all(r["confidence"] == 1.0 for r in verdict["ranking"])


def test_unmeasured_instance_in_warm_bucket_answers_bucketed(tmp_path, census):
    oracle = _warmed(tmp_path, census)
    verdict = oracle.query("gram", {"size": 50, "seed": 777}, enqueue=False)
    assert verdict["confidence"] == CONFIDENCE_BUCKETED
    assert verdict["bucket"] == "[32, 64)"
    assert verdict["n_records"] >= 3
    assert all(0.0 < r["confidence"] <= 1.0 for r in verdict["ranking"])


def test_empty_cache_miss_answers_model_only_and_enqueues(tmp_path, census):
    _, _, records = census
    oracle = _empty(tmp_path, census)
    record = records[0]
    verdict = oracle.query(record["family"], record["params"])
    assert verdict["confidence"] == CONFIDENCE_MODEL_ONLY
    assert verdict["enqueued"] is True and verdict["n_records"] == 0
    assert verdict["ranks"] and verdict["ranking"]
    assert set(verdict["ranks"]) == set(record["ranks"])
    shard = shard_of_key(verdict["key"], oracle.spec.n_shards)
    assert oracle.cache.pending(shard)
    before = oracle.cache.miss_totals()[0]
    v2 = oracle.query("gram", {"size": 500, "seed": 0}, enqueue=False)
    assert v2["confidence"] == CONFIDENCE_MODEL_ONLY and not v2["enqueued"]
    assert oracle.cache.miss_totals()[0] == before


def test_miss_enqueue_drain_then_measured_byte_identical(tmp_path, census):
    """Empty cache -> model_only, the queue drains the miss, the same query
    answers measured, equal to the census record; the drained cache is the
    reference's after the same round trip, byte for byte."""
    _, root, records = census
    record = records[3]
    roots = {}
    for name, oracle_mod, cache_mod, queue_mod in (("port", port_oracle, port_cache, None),
                                                   ("ref", ref_oracle, ref_cache, ref_queue)):
        out = str(tmp_path / name)
        cache_mod.OracleCache.create(out, cache_mod.OracleCacheSpec(census=root, n_shards=2))
        oracle = oracle_mod.RankingOracle.open(out)
        first = oracle.query(record["family"], record["params"])
        assert first["confidence"] == CONFIDENCE_MODEL_ONLY and first["uid"] == record["uid"]
        if queue_mod is None:
            queue = open_queue(out, device="cpu")
            assert isinstance(queue, OracleQueue) and queue.device == "cpu"
            assert drain(queue, default_owner()) is True
        else:
            queue = queue_mod.open_queue(out)
            assert queue_mod.drain(queue, "host") is True
        assert queue.progress() == {"completed": 1, "total": 1}
        oracle.reload()
        second = oracle.query(record["family"], record["params"])
        assert second["confidence"] == CONFIDENCE_MEASURED
        assert json.dumps(second["ranks"], sort_keys=True) == json.dumps(record["ranks"], sort_keys=True)
        assert second["is_anomaly"] == record["is_anomaly"]
        roots[name] = out
    want = {k: v for k, v in _store_bytes(roots["ref"]).items() if "lease" not in k}
    assert {k: v for k, v in _store_bytes(roots["port"]).items() if "lease" not in k} == want


def test_ad_hoc_params_get_stable_out_of_grid_uids(tmp_path, census):
    oracle = _warmed(tmp_path, census)
    a = oracle.query("gram", {"size": 50, "seed": 123}, enqueue=False)
    b = oracle.query("gram", {"size": 50, "seed": 123}, enqueue=False)
    assert a["uid"] == b["uid"] and a["uid"].startswith("gram-adhoc-")
    assert a["index"] >= (1 << 32)


def test_machine_override_is_a_distinct_key(tmp_path, census):
    oracle = _warmed(tmp_path, census)
    default = oracle.query("gram", {"size": 48, "seed": 0}, enqueue=False)
    other = oracle.query("gram", {"size": 48, "seed": 0}, machine="cpu-1core", enqueue=False)
    assert default["confidence"] == CONFIDENCE_MEASURED
    assert other["confidence"] == CONFIDENCE_MODEL_ONLY
    assert default["key"] != other["key"]


def test_warm_is_idempotent_and_lru_serves_without_io(tmp_path, census):
    spec, root, records = census
    cspec = OracleCacheSpec(census=root, n_shards=2)
    cache = OracleCache.create(str(tmp_path / "cache"), cspec)
    machine = default_machine_name(cspec, spec)
    first = cache.warm(records, (), machine=machine)
    assert first == len(cache) > 0
    assert cache.warm(records, (), machine=machine) == 0
    key = cache.keys()[0]
    entry = cache.get(key)
    hits_before = cache.hits
    assert cache.get(key) is entry
    assert cache.hits == hits_before + 1


def test_lru_capacity_bounds_memory_but_not_correctness(tmp_path, census):
    spec, root, records = census
    cspec = OracleCacheSpec(census=root, n_shards=2, lru_capacity=1)
    cache = OracleCache.create(str(tmp_path / "cache"), cspec)
    cache.warm(records, (), machine=default_machine_name(cspec, spec))
    keys = cache.keys()
    assert len(keys) > 1
    for key in keys + keys:
        entry = cache.get(key)
        assert entry is not None and entry["key"] == key
        assert len(cache._lru) == 1


def test_aggregate_entry_modal_ranks_and_anomaly_rule():
    def src(index, size, ranks, means, anomaly, cause, evidence):
        return {"index": index, "size": size, "ranks": ranks, "mean_ranks": means,
                "is_anomaly": anomaly, "reason": "sf_not_best" if anomaly else "",
                "min_flops_algs": ["b"], "cause": cause, "cause_evidence": evidence,
                "offending_kernel": None}

    sources = {
        "u1": src(0, 48, {"a": 1, "b": 2}, {"a": 1.0, "b": 2.0}, False, None, None),
        "u2": src(1, 50, {"a": 1, "b": 2}, {"a": 1.1, "b": 1.9}, True, "dispatch_overhead", 0.8),
        "u3": src(2, 52, {"a": 2, "b": 1}, {"a": 1.8, "b": 1.2}, True, "dispatch_overhead", 0.6),
    }
    entry = aggregate_entry("f|[32, 64)|m", sources, seq=0)
    assert entry["ranks"] == {"a": 1, "b": 2}
    assert entry["n_records"] == 3
    assert entry["anomaly_rate"] == pytest.approx(2 / 3)
    assert entry["is_anomaly"] is True
    assert entry["cause"] == "dispatch_overhead"
    assert entry["cause_evidence"] == pytest.approx(0.7)
    assert {r["alg"]: r for r in entry["ranking"]}["a"]["confidence"] == pytest.approx(2 / 3)
    assert aggregate_entry("f|[32, 64)|m", sources, seq=0) == entry
    assert ref_cache.aggregate_entry("f|[32, 64)|m", sources, seq=0) == entry


def test_explain_causes_ride_into_measured_verdicts(tmp_path, census):
    spec, root, records = census
    target = ([r for r in records if r["is_anomaly"]] or records[:1])[0]
    explained = [{"uid": target["uid"], "cause": "dispatch_overhead", "evidence": 0.9,
                  "offending_kernel": "gemm::0"}]
    cspec = OracleCacheSpec(census=root, n_shards=2)
    cache = OracleCache.create(str(tmp_path / "cache"), cspec)
    cache.warm(records, explained, machine=default_machine_name(cspec, spec))
    verdict = RankingOracle.open(cache.root).query(target["family"], target["params"], enqueue=False)
    assert verdict["confidence"] == CONFIDENCE_MEASURED
    assert verdict["cause"] == "dispatch_overhead"
    assert verdict["cause_evidence"] == pytest.approx(0.9)


def test_cache_root_is_a_registered_store_kind(tmp_path, census):
    oracle = _warmed(tmp_path, census)
    kind = detect_store_kind(oracle.root)
    assert kind is not None and kind.name == "oracle"
    assert kind.load_n_shards(oracle.root) == oracle.spec.n_shards
    queue = open_queue(oracle.root, device="cpu")
    assert queue.kind == "oracle" and queue.n_shards == oracle.spec.n_shards
    assert queue.backend == "cost_model"


def test_fsck_repairs_damaged_cache_shard_and_rewarm_restores(tmp_path, census):
    """Mid-file bitrot in a cache shard is loud (writers refuse), fsck
    excises + quarantines + rebuilds the manifest, and a re-warm restores
    the lost entries."""
    spec, root, records = census
    oracle = _warmed(tmp_path, census)
    out = oracle.root
    machine = default_machine_name(oracle.spec, spec)
    shard = next(s for s in range(oracle.spec.n_shards)
                 if len(ShardStore(out, s).open(readonly=True).records) >= 2)
    path = ShardStore(out, shard).records_path
    data = open(path, "rb").read()
    first_nl = data.index(b"\n")
    open(path, "wb").write(b"\x00" + data[1:first_nl + 1] + data[first_nl + 1:])
    with pytest.raises(StoreDamaged):
        ShardStore(out, shard).open()
    assert any(s == shard for s, _, _ in OracleCache.open(out).damaged)
    report = fsck_store(out)
    assert [f for f in report.findings if f.shard == shard and f.kind == "mid_file_corruption"]
    assert report.remaining == 0
    assert any(".line-" in f for f in os.listdir(os.path.join(out, "quarantine")))
    assert fsck_store(out).clean
    repaired = OracleCache.open(out)
    assert set(oracle.cache.keys()) - set(repaired.keys())
    repaired.warm(records, (), machine=machine)
    assert set(repaired.keys()) == set(oracle.cache.keys())
    verdicts = RankingOracle.open(out).query_batch(
        [{"family": r["family"], "params": r["params"]} for r in records], enqueue=False)
    assert hit_rate(verdicts) == 1.0
    assert all(v["confidence"] == CONFIDENCE_MEASURED for v in verdicts)


def test_queue_pause_and_resume_is_lossless(tmp_path, census):
    _, _, records = census
    oracle = _empty(tmp_path, census)
    record = records[1]
    verdict = oracle.query(record["family"], record["params"])
    queue = OracleQueue(oracle.root, device="cpu")
    shard = shard_of_key(verdict["key"], oracle.spec.n_shards)
    queue.run_shard(shard, max_steps=2)
    assert queue.progress()["completed"] == 0
    queue.run_shard(shard)
    assert queue.progress() == {"completed": 1, "total": 1}
    oracle.reload()
    verdict = oracle.query(record["family"], record["params"], enqueue=False)
    assert verdict["confidence"] == CONFIDENCE_MEASURED
    assert json.dumps(verdict["ranks"], sort_keys=True) == json.dumps(record["ranks"], sort_keys=True)


# ------------------------------------------------ byte for byte with repro ---

def _explain_store(runner, census_root, out):
    espec = runner.ExplainSpec(census=os.path.abspath(census_root), n_shards=2)
    os.makedirs(out, exist_ok=True)
    espec.save(os.path.join(out, runner.SPEC_FILE))
    for shard in range(espec.n_shards):
        runner.run_explain_shard(espec, out, shard, **({"device": "cpu"} if runner is port_runner else {}))
    return runner.merge_explained(espec, out)


@pytest.fixture(scope="module")
def warmed_pair(tmp_path_factory):
    """(port cache root, reference cache root, model path, explanations):
    both packages
    warm from the same census (the one above plus bilinear instances, whose
    anomalies get explained) and explain directories, with a trained model
    attached for the learned tier."""
    base = tmp_path_factory.mktemp("pair")
    root = str(base / "census")
    os.makedirs(root)
    spec = SweepSpec(**dict(CENSUS, name="oracle-rich",
                            families=dict(CENSUS["families"], bilinear={"sizes": [48], "per_size": 3})))
    spec.save(os.path.join(root, "spec.json"))
    for shard in range(spec.n_shards):
        run_shard(spec, root, shard, device="cpu")
    records = merge_shards(spec, root)
    explain = str(base / "explain")
    explained = _explain_store(port_runner, root, explain)
    assert explained and all(r["cause"] for r in explained)
    model = train_model(spec, records).save(str(base / "model.json"))
    from repro.api import warm_oracle as ref_warm
    from repro_torch.api import warm_oracle

    port, ref = str(base / "port"), str(base / "ref")
    assert warm_oracle(port, root, explain=explain, model=model, n_shards=3) \
        == ref_warm(ref, root, explain=explain, model=model, n_shards=3) > 0
    return port, ref, model, explained


def test_warmed_caches_byte_identical(warmed_pair):
    port, ref, _, explained = warmed_pair
    files = _store_bytes(port)
    assert files == _store_bytes(ref)
    assert {"ocache.json", "shard-0000.jsonl", "shard-0002.manifest.json"} <= set(files)
    oracle = RankingOracle.open(port)
    grid = {i.uid: i for i in oracle.census_spec.expand()}
    for row in explained:  # every explained anomaly answers measured, with its cause
        verdict = oracle.query(row["family"], grid[row["uid"]].params, enqueue=False)
        assert verdict["confidence"] == CONFIDENCE_MEASURED and verdict["is_anomaly"]
        assert verdict["cause"] == row["cause"]


@pytest.mark.parametrize("tier", sorted(TIER_QUERIES))
@pytest.mark.parametrize("with_model", [True, False])
def test_verdicts_equal_reference_in_every_tier(warmed_pair, tmp_path, tier, with_model):
    """The same query answers the same verdict JSON from both packages'
    caches: measured, bucketed, and for a miss learned_model (a model
    attached) or model_only (none)."""
    port, ref, _, _ = warmed_pair
    if not with_model:  # the same caches without the learned tier
        for name in ("port", "ref"):
            root = Path(port if name == "port" else ref)
            copy = tmp_path / name
            copy.mkdir()
            for f in root.iterdir():
                if f.is_file():
                    (copy / f.name).write_bytes(f.read_bytes())
            doc = json.loads((copy / "ocache.json").read_text())
            doc["model"] = ""
            (copy / "ocache.json").write_text(json.dumps(doc))
        port, ref = str(tmp_path / "port"), str(tmp_path / "ref")
    family, params = TIER_QUERIES[tier]
    got = RankingOracle.open(port).query(family, params, enqueue=False)
    want = ref_oracle.RankingOracle.open(ref).query(family, params, enqueue=False)
    assert json.dumps(got, sort_keys=True) == json.dumps(want, sort_keys=True)
    expected = {"measured": CONFIDENCE_MEASURED, "bucketed": CONFIDENCE_BUCKETED}.get(
        tier, CONFIDENCE_LEARNED if with_model else CONFIDENCE_MODEL_ONLY)
    assert got["confidence"] == expected
    if expected == CONFIDENCE_LEARNED:
        assert 0.0 <= got["flip_prob"] <= 1.0 and "model_confidence" in got


def test_learned_tier_refuses_a_drifted_model_in_both(warmed_pair, tmp_path):
    port, ref, model, _ = warmed_pair
    doc = json.loads(Path(model).read_text())
    doc["coef"][0] += 1.0
    Path(model + ".bad").write_text(json.dumps(doc))
    for root, oracle_mod, model_mod in ((port, port_oracle, port_model), (ref, ref_oracle, ref_model)):
        copy = tmp_path / Path(root).name
        copy.mkdir()
        for f in Path(root).iterdir():
            if f.is_file():
                (copy / f.name).write_bytes(f.read_bytes())
        spec = json.loads((copy / "ocache.json").read_text())
        spec["model"] = model + ".bad"
        (copy / "ocache.json").write_text(json.dumps(spec))
        with pytest.raises(model_mod.ModelDrift, match="checksum"):
            oracle_mod.RankingOracle.open(str(copy)).query(*TIER_QUERIES["miss"], enqueue=False)


# ------------------------------------------------------------ what the port adds ---

def test_wall_clock_kernel_variants_miss_drained_on_the_plain_versions(tmp_path):
    """A wall-clock kernel-lane cache: a matmul miss outside the warm
    buckets answers model_only, ``OracleQueue(..., device="cpu")`` measures
    it on the plain versions, and it answers measured afterwards."""
    root = str(tmp_path / "lane")
    spec = SweepSpec(name="lane", n_shards=1, backend="wall_clock", max_measurements=6,
                     families={"kernel_variants": {"sites": ["matmul"], "sizes": [32], "per_size": 1,
                                                   "interpret": False}})
    os.makedirs(root)
    spec.save(os.path.join(root, "spec.json"))
    run_shard(spec, root, 0, device="cpu")
    cspec = OracleCacheSpec(census=root, n_shards=2)
    cache = OracleCache.create(str(tmp_path / "cache"), cspec)
    cache.warm(merge_shards(spec, root), (), machine=default_machine_name(cspec, spec))
    oracle = RankingOracle.open(cache.root)
    assert oracle.machine_name == "cpu-1core"
    params = {"site": "matmul", "size": 16, "seed": 0, "interpret": False}
    first = oracle.query("kernel_variants", params)
    assert first["confidence"] == CONFIDENCE_MODEL_ONLY and first["enqueued"]
    assert set(first["ranks"]) == {"blocks_16x16x16", "xla_dot"}
    queue = OracleQueue(cache.root, device="cpu")
    assert queue.backend == "wall_clock"
    assert drain(queue, default_owner()) is True
    oracle.reload()
    again = oracle.query("kernel_variants", params)
    assert again["confidence"] == CONFIDENCE_MEASURED and not again["enqueued"]
    assert set(again["ranks"]) == {"blocks_16x16x16", "xla_dot"}
    totals, pendings = oracle.cache.miss_totals()
    assert (sum(totals), sum(pendings)) == (1, 0)


def test_wall_clock_miss_on_cuda_without_a_card_refuses(tmp_path, census, monkeypatch):
    """The queue's default device is the card: without one the drain
    raises, and the miss stays pending."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    spec, root, _ = census
    wall = str(tmp_path / "wall")
    os.makedirs(wall)
    SweepSpec(**dict(CENSUS, backend="wall_clock")).save(os.path.join(wall, "spec.json"))
    OracleCache.create(str(tmp_path / "cache"), OracleCacheSpec(census=wall, n_shards=1))
    oracle = RankingOracle.open(str(tmp_path / "cache"))
    assert oracle.query("gram", {"size": 48, "seed": 0})["enqueued"]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        OracleQueue(str(tmp_path / "cache")).run_shard(0)
    assert sum(oracle.cache.miss_totals()[1]) == 1


def test_queries_do_not_initialise_cuda(warmed_pair):
    """A fresh interpreter answers a batch of queries in every tier with
    ``torch.cuda.is_initialized()`` still false (jax and the reference
    blocked)."""
    port, _, _, _ = warmed_pair
    code = (
        "import sys, json\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['repro'] = None\n"
        "from repro_torch import query\n"
        f"qs = {json.dumps(list(TIER_QUERIES.values()))}\n"
        f"vs = [query({port!r}, f, p, enqueue=False) for f, p in qs]\n"
        "import torch\n"
        "print(sorted(v['confidence'] for v in vs), torch.cuda.is_initialized())\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "['bucketed', 'learned_model', 'learned_model', 'measured'] False"

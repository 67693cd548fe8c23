"""The port's learned cost model and active census (``repro_torch.predict``)
against the JAX package's (``repro.predict``), in process, on the same
census directory: feature vectors, training rows, model files, drift
refusals, active census stores (also after a pause and a resume),
prediction errors and the report table must be the reference's exactly —
no tolerance, since no float leaves numpy's same arithmetic. Mirrors
``tests/test_predict.py`` on the port (feature exactness, serialization
drift, the confidence gate's acceptance numbers, kill/resume)."""

import json
import math
import os
import zlib
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import repro.core.sweep as ref_sweep  # noqa: E402
import repro.predict.active as ref_active  # noqa: E402
import repro.predict.features as ref_features  # noqa: E402
import repro.predict.model as ref_model  # noqa: E402
import repro_torch.core.sweep as port_sweep  # noqa: E402
import repro_torch.predict.active as port_active  # noqa: E402
import repro_torch.predict.features as port_features  # noqa: E402
import repro_torch.predict.model as port_model  # noqa: E402
from repro.api import run_census as ref_run_census  # noqa: E402
from repro_torch.api import predict_ranks, run_census, train_predictor  # noqa: E402
from repro_torch.core.sweep import (  # noqa: E402
    SweepSpec,
    census_summary,
    merge_shards,
    run_shard,
    sweep_progress,
    synthetic_instance_model,
)
from repro_torch.explain.decompose import kernels_from_record  # noqa: E402
from repro_torch.predict.active import ActivePredictor, prediction_errors  # noqa: E402
from repro_torch.predict.features import (  # noqa: E402
    FEATURE_NAMES,
    census_machine,
    kernel_features,
    training_rows,
)
from repro_torch.predict.model import ModelDrift, RidgeModel, train_model  # noqa: E402

#: tests/test_predict.py's grid: families whose algorithms are separated by
#: real FLOP gaps (solve/distributive skip confidently) with a slice of the
#: equal-FLOPs regime (bilinear/chain) that must STAY measured
ACCEPT_FAMILIES = {
    "solve": {"sizes": [16, 32, 64, 128], "per_size": 5},
    "distributive": {"sizes": [16, 32, 64, 128], "per_size": 5},
    "bilinear": {"sizes": [16, 32], "per_size": 1},
    "chain": {"count": 4, "n_matrices": [3], "lo": 24, "hi": 96},
}

PACKAGES = {"port": (port_sweep, port_model, port_active),
            "ref": (ref_sweep, ref_model, ref_active)}


def _kwargs(**overrides):
    kwargs = dict(name="acc", families=ACCEPT_FAMILIES, n_shards=2, backend="cost_model",
                  max_measurements=9, chunk_size=4, save_every=8)
    kwargs.update(overrides)
    return kwargs


def _spec(**overrides):
    return SweepSpec(**_kwargs(**overrides))


def _store_bytes(root):
    return {p.name: p.read_bytes() for p in sorted(Path(root).iterdir())
            if p.is_file() and not p.name.endswith("timings.json")}


@pytest.fixture(scope="module")
def census(tmp_path_factory):
    """(spec, root, records, model_path): one full measured census by the
    port plus the model the port trains from it, shared by the read-only
    tests (the reference reads the same directory)."""
    root = str(tmp_path_factory.mktemp("census"))
    spec = _spec()
    run_census(root, spec, device="cpu")
    records = merge_shards(spec, root)
    model_path = train_predictor(root, os.path.join(root, "model.json"))
    return spec, root, records, model_path


# ---------------------------------------------------------------- features ---

def test_kernel_features_match_decompose_and_roofline(census):
    """Every vector slot is EXACTLY the decompose/roofline quantity it is
    named for."""
    spec, _, records, _ = census
    _, machine = census_machine(spec)
    rec = next(r for r in records if r["family"] == "solve")
    for alg, kernels in kernels_from_record(rec).items():
        vec = dict(zip(FEATURE_NAMES, kernel_features(kernels, machine, spec.dispatch_s)))
        flops = sum(k.flops for k in kernels)
        nbytes = sum(k.bytes for k in kernels)
        assert vec["log10_flops"] == math.log10(flops)
        assert vec["log10_bytes"] == math.log10(nbytes)
        assert vec["log10_intensity"] == math.log10(flops / nbytes)
        assert vec["kernel_count"] == float(len(kernels))
        assert vec["log10_max_kernel_flops"] == math.log10(max(k.flops for k in kernels))
        assert vec["log10_t_compute"] == math.log10(machine.t_compute(flops))
        t_mem = machine.t_memory(nbytes)
        assert vec["log10_t_memory"] == math.log10(max(t_mem, 1e-30))
        dispatch = (machine.dispatch_overhead_s + spec.dispatch_s) * len(kernels)
        assert vec["log10_t_roofline"] == math.log10(max(machine.t_compute(flops), t_mem) + dispatch)


@pytest.mark.parametrize("machine", ["", "cpu-1core", "h100-sxm"])
def test_feature_vectors_and_training_rows_equal_reference(census, machine):
    spec, root, records, _ = census
    ref_spec = ref_sweep.SweepSpec.load(os.path.join(root, "spec.json"))
    assert port_features.FEATURE_NAMES == ref_features.FEATURE_NAMES
    assert port_features.FEATURE_VERSION == ref_features.FEATURE_VERSION
    label, mspec = census_machine(spec, machine)
    ref_label, ref_mspec = ref_features.census_machine(ref_spec, machine)
    assert label == ref_label
    for rec in records:
        assert port_features.record_features(rec, mspec, spec.dispatch_s) \
            == ref_features.record_features(rec, ref_mspec, ref_spec.dispatch_s)
    assert training_rows(spec, records, machine) == ref_features.training_rows(ref_spec, records, machine)


def test_training_targets_are_reconstructed_truth(census):
    spec, _, records, _ = census
    X, y, keys, n_skipped = training_rows(spec, records)
    assert n_skipped == 0
    assert len(X) == len(y) == len(keys)
    truth = {}
    for rec in records:
        model = synthetic_instance_model(
            spec, int(rec["index"]), {k: float(v) for k, v in rec["flops"].items()},
            {a: len(ks) for a, ks in rec["kernels"].items()}, base_seed=rec.get("base_seed"))
        for alg, cost in model.costs.items():
            truth[(rec["uid"], alg)] = math.log10(cost)
    assert set(keys) == set(truth)
    for key, target in zip(keys, y):
        assert target == truth[key]


@pytest.mark.parametrize("package", sorted(PACKAGES))
def test_wall_clock_census_is_not_trainable(package):
    sweep, model, _ = PACKAGES[package]
    spec = sweep.SweepSpec(**_kwargs(backend="wall_clock"))
    with pytest.raises(ValueError, match="wall-clock"):
        model.train_model(spec, [{"uid": "x"}])


# ----------------------------------------------------------- serialization ---

def test_train_serialize_load_round_trip(census, tmp_path):
    spec, _, records, _ = census
    model = train_model(spec, records)
    path = model.save(str(tmp_path / "m.json"))
    loaded = RidgeModel.load(path)
    assert loaded.to_dict() == model.to_dict()
    vec = [1.0] * len(FEATURE_NAMES)
    assert loaded.predict_one(vec) == model.predict_one(vec)


@pytest.mark.parametrize("machine", ["", "cpu-1core"])
def test_model_files_byte_identical_and_cross_load(census, tmp_path, machine):
    """Either package trains the same file from the same census, and each
    loads the other's and predicts the same times."""
    spec, root, records, _ = census
    ref_spec = ref_sweep.SweepSpec.load(os.path.join(root, "spec.json"))
    port_path = train_model(spec, records, machine=machine).save(str(tmp_path / "port.json"))
    ref_path = ref_model.train_model(ref_spec, records, machine=machine).save(str(tmp_path / "ref.json"))
    assert Path(port_path).read_bytes() == Path(ref_path).read_bytes()
    port_loaded, ref_loaded = RidgeModel.load(ref_path), ref_model.RidgeModel.load(port_path)
    assert port_loaded.to_dict() == ref_loaded.to_dict()
    _, mspec = census_machine(spec, machine)
    for rec in records[:12]:
        vecs = port_features.record_features(rec, mspec, spec.dispatch_s)
        assert port_loaded.predict_times(vecs) == ref_loaded.predict_times(vecs)


def _tampered(model_path, tmp_path):
    d = json.load(open(model_path))
    d["coef"][0] += 0.25
    path = str(tmp_path / "tampered.json")
    json.dump(d, open(path, "w"))
    return path


def _drifted(model_path, tmp_path):
    d = json.load(open(model_path))
    d["feature_names"][0] = "log10_flops_v2"
    body = {k: v for k, v in d.items() if k != "_crc"}
    d["_crc"] = format(zlib.crc32(
        json.dumps(body, sort_keys=True, separators=(",", ":")).encode("utf-8")) & 0xFFFFFFFF, "08x")
    path = str(tmp_path / "drifted.json")
    json.dump(d, open(path, "w"))
    return path


@pytest.mark.parametrize("package", sorted(PACKAGES))
@pytest.mark.parametrize("damage,message", [(_tampered, "checksum"), (_drifted, "feature schema")])
def test_load_rejects_tampered_and_drifted_files(census, tmp_path, package, damage, message):
    """A byte-level edit fails the payload's own checksum; a consistent
    payload under another feature layout fails the schema check — in both
    packages, on the port's model file."""
    _, _, _, model_path = census
    _, model, _ = PACKAGES[package]
    with pytest.raises(model.ModelDrift, match=message):
        model.RidgeModel.load(damage(model_path, tmp_path))


def test_predictor_rejects_machine_mismatch(census):
    spec, _, _, model_path = census
    with pytest.raises(ModelDrift, match="machine"):
        ActivePredictor.open(model_path, _spec(name="other"))
    ActivePredictor.open(model_path, spec)  # matching label loads fine


# ------------------------------------------------------------ active census ---

def test_active_census_throughput_and_anomaly_recall(census, tmp_path):
    """tests/test_predict.py's acceptance on the port: the active census
    covers the same grid with >= 5x fewer measured instances and finds the
    full census's exact anomaly set; its store is the reference's."""
    spec, _, full_records, model_path = census
    aspec = _spec(predictor_model=model_path, predict_threshold=0.95)
    root, ref_root = str(tmp_path / "active"), str(tmp_path / "ref")
    run_census(root, aspec, device="cpu")
    ref_run_census(ref_root, ref_sweep.SweepSpec(**_kwargs(predictor_model=model_path,
                                                           predict_threshold=0.95)))
    assert _store_bytes(root) == _store_bytes(ref_root)
    records = merge_shards(aspec, root)
    assert [r["uid"] for r in records] == [r["uid"] for r in full_records]
    predicted = [r for r in records if r.get("provenance") == "predicted"]
    measured = [r for r in records if r.get("provenance") != "predicted"]
    assert len(records) / len(measured) >= 5.0
    full_anomalies = sorted(r["uid"] for r in full_records if r["is_anomaly"])
    assert full_anomalies and sorted(r["uid"] for r in records if r["is_anomaly"]) == full_anomalies
    assert all(r.get("provenance") != "predicted" for r in records if r["family"] == "bilinear")
    for rec in predicted:
        assert rec["measurements_per_alg"] == 0 and rec["iterations"] == 0
        assert 0.95 <= rec["predicted"]["confidence"] <= 1.0
    assert sweep_progress(aspec, root)["predicted"] == len(predicted) > 0
    assert census_summary(records)["total"]["predicted"] == len(predicted)

    from repro.launch.report_md import census_tables as ref_tables
    from repro_torch.launch.report_md import census_tables

    md = census_tables(records, name="acc")
    assert f"{len(predicted)}/{len(records)}" in md and "predicted without measurement" in md
    assert md == ref_tables(records, name="acc")


def test_active_census_resume_is_byte_identical(census, tmp_path):
    """An active shard paused every 3 engine steps resumes to the bytes
    (records and manifest) of the port's straight run and of the
    reference's."""
    _, _, _, model_path = census
    aspec = _spec(predictor_model=model_path, predict_threshold=0.95)
    straight, chopped, ref = (str(tmp_path / n) for n in ("a", "b", "ref"))
    run_shard(aspec, straight, 0, device="cpu")
    ref_sweep.run_shard(ref_sweep.SweepSpec(**_kwargs(predictor_model=model_path,
                                                      predict_threshold=0.95)), ref, 0)
    for _ in range(100):
        run_shard(aspec, chopped, 0, max_steps=3, device="cpu")
        manifest = os.path.join(chopped, "shard-0000.manifest.json")
        if os.path.exists(manifest) and json.load(open(manifest)).get("done"):
            break
    else:
        pytest.fail("shard did not finish in 100 slices")
    for name in ("shard-0000.jsonl", "shard-0000.manifest.json"):
        got = Path(chopped, name).read_bytes()
        assert got == Path(straight, name).read_bytes() == Path(ref, name).read_bytes()


# ------------------------------------------------------------- evaluation ---

def test_prediction_errors_and_tables_equal_reference(census):
    spec, root, records, model_path = census
    rows = prediction_errors(spec, records, RidgeModel.load(model_path))
    ref_spec = ref_sweep.SweepSpec.load(os.path.join(root, "spec.json"))
    assert rows == ref_active.prediction_errors(ref_spec, records, ref_model.RidgeModel.load(model_path))
    assert len(rows) == len(records)
    assert all(r["abs_dlog10_t"] is not None and 0.0 <= r["flip_prob"] <= 1.0 for r in rows)
    assert sum(r["anomaly_match"] for r in rows) / len(rows) >= 0.9

    from repro.launch.report_md import predict_tables as ref_tables
    from repro_torch.launch.report_md import predict_tables

    md = predict_tables(rows, name="acc")
    assert "| family |" in md and "would skip" in md
    assert md == ref_tables(rows, name="acc")


def test_predict_ranks_facade_subset(census):
    _, root, _, model_path = census
    from repro.api import predict_ranks as ref_predict_ranks

    uids = [i.uid for i in _spec().expand()][:3]
    preds = predict_ranks(model_path, root, uids=uids)
    assert [p.uid for p in preds] == uids
    for p in preds:
        assert p.confidence == 1.0 - p.flip_prob
        assert set(p.ranks) == set(p.times)
        assert min(p.ranks.values()) == 1
    assert [vars(p) for p in preds] == [vars(p) for p in ref_predict_ranks(model_path, root, uids=uids)]


def test_active_gate_predicts_records_the_reference_predicts(census):
    """``ActivePredictor.record`` — the predicted-provenance record — and
    the gate's decision are the reference's for every instance."""
    spec, root, _, model_path = census
    ref_spec = ref_sweep.SweepSpec.load(os.path.join(root, "spec.json"))
    port_pred = ActivePredictor.open(model_path, spec)
    ref_pred = ref_active.ActivePredictor.open(model_path, ref_spec)
    for inst, ref_inst in zip(spec.expand(), ref_spec.expand()):
        assert port_pred.record(inst) == ref_pred.record(ref_inst)
        assert port_pred.gate(inst) == ref_pred.gate(ref_inst)

"""The port's AnomalyExplainer (``repro_torch.explain``) against the JAX
package's (``repro.explain``), in process: the deterministic explain
stores must be the reference's byte for byte (a cost-model census with
injected efficiency factors, and a simulated one with bimodal timers,
cache-reuse pairs and pure-noise flips, as the reference's CI explains
them), the taxonomy, thresholds, machine registry and calibration must be
the reference's, and each of the nine isolated segment workloads must
compute the reference's value on the same numpy bytes (1e-4 of the
output's scale). The wall-clock path runs here on the CPU
(``device="cpu"``). Also the CUDA-graph launch counting of
:mod:`repro_torch.graphs`, as far as it runs without a card."""

import dataclasses
import json
import os
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.explain.runner as ref_runner  # noqa: E402
import repro_torch.core.sweep as port_sweep  # noqa: E402
import repro_torch.explain.runner as port_runner  # noqa: E402
from repro.explain import decompose as ref_decompose  # noqa: E402
from repro_torch import graphs  # noqa: E402
from repro_torch.explain import decompose as port_decompose  # noqa: E402

#: the two censuses of the reference's CI explain lanes, cut to test size:
#: injected per-algorithm efficiency factors (cost_model, eff-sigma 0.25),
#: and bimodal timers + cache-reuse savings + pure noise (simulated)
CENSUSES = {
    "cost_model": dict(
        backend="cost_model", eff_sigma=0.25, noise_sigma=0.01, max_measurements=9,
        families={"chain": {"count": 24, "n_matrices": [3, 4], "lo": 24, "hi": 128},
                  "bilinear": {"sizes": [32, 64], "per_size": 4}}),
    "simulated": dict(
        backend="simulated", eff_sigma=0.0, noise_sigma=0.01, max_measurements=12,
        bimodal_shift=0.5, bimodal_prob=0.35, bimodal_frac=0.4,
        cache_reuse_frac=0.3, cache_reuse_saving=0.4,
        families={"chain": {"count": 24, "n_matrices": [3, 4], "lo": 24, "hi": 128},
                  "bilinear": {"sizes": [32, 48, 64], "per_size": 4}}),
}
#: explain knobs per census (the simulated lane's --eps -1.0, as in CI)
EXPLAIN = {"cost_model": {}, "simulated": {"eps": -1.0, "max_measurements": 12}}


def _census(root, kind):
    spec = port_sweep.SweepSpec(name=kind, n_shards=4, chunk_size=4, save_every=5,
                                **CENSUSES[kind])
    os.makedirs(root, exist_ok=True)
    spec.save(os.path.join(root, "spec.json"))
    for shard in range(spec.n_shards):
        port_sweep.run_shard(spec, root, shard, device="cpu")
    return spec


def _explain(runner, census, out, kind, **kw):
    espec = runner.ExplainSpec(census=os.path.abspath(census), n_shards=3, chunk_size=2,
                               save_every=4, **EXPLAIN[kind])
    os.makedirs(out, exist_ok=True)
    espec.save(os.path.join(out, runner.SPEC_FILE))
    for shard in range(espec.n_shards):
        runner.run_explain_shard(espec, out, shard, **kw)
    runner.write_merged_explained(espec, out)
    return espec


def _store_bytes(root):
    return {p.name: p.read_bytes() for p in sorted(Path(root).iterdir())
            if p.is_file() and not p.name.endswith("timings.json")}


@pytest.fixture(scope="module", params=sorted(CENSUSES))
def explained(request, tmp_path_factory):
    """(kind, census root, the port's explain root, the reference's)."""
    kind = request.param
    base = tmp_path_factory.mktemp(f"explain_{kind}")
    census = str(base / "census")
    _census(census, kind)
    port, ref = str(base / "port"), str(base / "ref")
    _explain(port_runner, census, port, kind, device="cpu")
    _explain(ref_runner, census, ref, kind)
    return kind, census, port, ref


# ------------------------------------------------ deterministic stores ---

def test_explain_stores_equal_reference(explained):
    """merged.jsonl, every shard file and manifest, and espec.json are the
    reference's byte for byte (the timing sidecars hold wall seconds)."""
    _, _, port, ref = explained
    got, want = _store_bytes(port), _store_bytes(ref)
    assert set(got) == set(want)
    assert {"merged.jsonl", "espec.json", "shard-0000.jsonl", "shard-0002.manifest.json"} <= set(got)
    for name in want:
        assert got[name] == want[name], name


def test_every_anomaly_explained_with_known_causes(explained):
    """What the reference's CI requires: the explained uids are the
    census's anomalies in order, every cause is in CAUSES, every evidence
    in [0, 1], and no row is left unexplained."""
    from repro_torch.explain import CAUSES

    kind, census, port, _ = explained
    spec = port_sweep.SweepSpec.load(os.path.join(census, "spec.json"))
    records = port_sweep.merge_shards(spec, census)
    anomalies = [r["uid"] for r in records if r["is_anomaly"]]
    rows = [json.loads(line) for line in open(os.path.join(port, "merged.jsonl"))]
    assert len(anomalies) >= 10
    assert [r["uid"] for r in rows] == anomalies
    assert all(r["cause"] in CAUSES and 0.0 <= float(r["evidence"]) <= 1.0 for r in rows)
    assert not [r for r in rows if r["cause"] == "unexplained"]
    causes = {r["cause"] for r in rows}
    if kind == "cost_model":
        assert causes == {"shape_kernel_efficiency"}
    else:
        assert {"frequency_bimodality", "cache_reuse_pair"} <= causes


def test_killed_explain_resumes_to_the_same_bytes(explained, tmp_path):
    """An in-process campaign stopped after a few engine steps in every
    shard (engine state on disk, as a kill leaves it) and resumed merges
    to the uninterrupted bytes."""
    kind, census, port, _ = explained
    espec = port_runner.ExplainSpec(census=os.path.abspath(census), n_shards=3, chunk_size=2,
                                    save_every=4, **EXPLAIN[kind])
    out = str(tmp_path / "paused")
    os.makedirs(out)
    espec.save(os.path.join(out, port_runner.SPEC_FILE))
    for shard in range(espec.n_shards):
        port_runner.run_explain_shard(espec, out, shard, max_steps=5, device="cpu")
    assert any(name.endswith("engine.json") for name in os.listdir(out))
    for shard in range(espec.n_shards):
        port_runner.run_explain_shard(espec, out, shard, device="cpu")
    port_runner.write_merged_explained(espec, out)
    assert _store_bytes(out) == _store_bytes(port)


def test_summary_progress_and_report_equal_reference(explained):
    from repro.launch.report_md import explain_tables as ref_tables
    from repro_torch.launch.report_md import explain_tables

    _, _, port, ref = explained
    espec = port_runner.ExplainSpec.load(os.path.join(port, "espec.json"))
    records = port_runner.merge_explained(espec, port)
    assert port_runner.explain_summary(records) == ref_runner.explain_summary(records)
    assert explain_tables(records, name="t") == ref_tables(records, name="t")
    ref_espec = ref_runner.ExplainSpec.load(os.path.join(ref, "espec.json"))
    assert port_runner.explain_progress(espec, port) == ref_runner.explain_progress(ref_espec, ref)


# --------------------------------------------------- taxonomy, machines ---

def test_causes_and_thresholds_equal_reference():
    import repro.explain.classify as ref_classify
    import repro.explain.distributions as ref_dist
    import repro_torch.explain.classify as port_classify
    import repro_torch.explain.distributions as port_dist

    assert port_classify.CAUSES == ref_classify.CAUSES
    for mod_port, mod_ref in ((port_classify, ref_classify), (port_dist, ref_dist)):
        consts = {n for n in dir(mod_ref) if n.isupper() and not n.startswith("_")}
        assert consts, mod_ref.__name__
        for n in consts:
            assert getattr(mod_port, n) == getattr(mod_ref, n), n
    assert {f.name: f.default for f in dataclasses.fields(port_runner.ExplainSpec)} == \
        {f.name: f.default for f in dataclasses.fields(ref_runner.ExplainSpec)}


def test_explain_exports_equal_reference():
    import repro.explain as ref
    import repro_torch.explain as port

    assert set(port.__all__) == set(ref.__all__)
    assert all(hasattr(port, n) for n in port.__all__)


def test_machine_registry_and_spec_round_trip_through_reference_json(tmp_path):
    from repro.explain.calibrate import CalibrationResult as RefResult
    from repro.roofline import terms as ref_terms
    from repro_torch.explain.calibrate import load_calibrated_machine
    from repro_torch.roofline import terms as port_terms

    assert {k: v.to_dict() for k, v in port_terms.MACHINES.items()} == \
        {k: v.to_dict() for k, v in ref_terms.MACHINES.items()}
    assert (port_terms.PEAK_FLOPS, port_terms.HBM_BW, port_terms.ICI_BW) == \
        (ref_terms.PEAK_FLOPS, ref_terms.HBM_BW, ref_terms.ICI_BW)
    spec = ref_terms.MachineSpec("h100-sxm", peak_flops=6.7e13, hbm_bw=3.35e12,
                                 dispatch_overhead_s=7e-6,
                                 eff_curve=((1024.0, 0.001), (3.3e7, 0.2)))
    text = json.dumps(spec.to_dict())
    port_spec = port_terms.MachineSpec.from_dict(json.loads(text))
    assert json.dumps(port_spec.to_dict()) == text
    for flops in (10.0, 5e5, 1e9):
        assert port_spec.t_compute(flops) == spec.t_compute(flops)
    path = RefResult(machine=spec, points=(), dispatch_s=7e-6, r2=0.9).save(str(tmp_path / "m.json"))
    assert load_calibrated_machine(path).to_dict() == spec.to_dict()
    assert port_terms.synthetic_machine("s", 2e9).to_dict() == ref_terms.synthetic_machine("s", 2e9).to_dict()


def test_resolve_machine_keeps_the_reference_order(tmp_path):
    for backend, name in (("cost_model", "sweep:t"), ("wall_clock", "cpu-1core")):
        sweep = port_sweep.SweepSpec(name="t", backend=backend)
        espec = port_runner.ExplainSpec()
        assert port_runner.resolve_machine(espec, sweep).name == name
    espec = port_runner.ExplainSpec(machine="tpu-v5e")
    assert port_runner.resolve_machine(espec, port_sweep.SweepSpec()).name == "tpu-v5e"


def test_calibration_fit_equals_reference():
    from repro.explain import calibrate as ref_cal
    from repro.roofline.terms import get_machine as ref_machine
    from repro_torch.explain import calibrate as port_cal
    from repro_torch.roofline.terms import get_machine

    truth = port_cal.synthetic_truth(get_machine("cpu-1core"), dispatch_s=2e-6, eff_knee=64.0)
    ref_truth = ref_cal.synthetic_truth(ref_machine("cpu-1core"), dispatch_s=2e-6, eff_knee=64.0)
    assert truth.to_dict() == ref_truth.to_dict()
    points = port_cal.micro_points_synthetic(truth, reps=9, seed=3)
    assert [p.to_dict() for p in points] == \
        [p.to_dict() for p in ref_cal.micro_points_synthetic(ref_truth, reps=9, seed=3)]
    base = dataclasses.replace(get_machine("cpu-1core"), dispatch_overhead_s=0.0)
    ref_base = dataclasses.replace(ref_machine("cpu-1core"), dispatch_overhead_s=0.0)
    fit = port_cal.fit_calibration(base, points)
    assert fit.to_dict() == ref_cal.fit_calibration(ref_base, points).to_dict()
    assert port_cal.calibration_table(fit) == ref_cal.calibration_table(
        ref_cal.fit_calibration(ref_base, points))


def test_wall_clock_calibration_ladder_on_the_cpu():
    from repro_torch.explain.calibrate import micro_points_wall_clock

    points = micro_points_wall_clock((8, 16), reps=3, device="cpu")
    assert [p.n for p in points] == [8, 16]
    assert all(p.t_median > 0 and p.flops == 2.0 * p.n ** 3 for p in points)


# ------------------------------------------------- segment workloads ---

#: one shape per op, small
SEGMENTS = [
    ("gemm", (24, 40, 16)), ("syrk", (32, 8)), ("gemv", (40, 24)), ("dot", (64,)),
    ("add", (16, 24)), ("inv", (32,)), ("getrf", (32,)), ("potrf", (32,)), ("trsv", (32,)),
]


def _reference_segment(monkeypatch, kernel, seed):
    """The reference's workload for ``kernel``: its output and the operands
    it runs on (caught at its ``jax.jit`` call), as numpy."""
    import jax

    real_jit = jax.jit
    seen = {}

    def spy(fn, *args, **kwargs):
        jitted = real_jit(fn, *args, **kwargs)

        def call(*operands):
            seen["operands"] = [np.asarray(x) for x in operands]
            return jitted(*operands)

        return call

    monkeypatch.setattr(jax, "jit", spy)
    out = np.asarray(ref_decompose.build_kernel_workload(kernel, seed=seed)(), np.float64)
    monkeypatch.setattr(jax, "jit", real_jit)
    return out, seen["operands"]


@pytest.mark.parametrize("op,shape", SEGMENTS)
def test_segment_workload_matches_reference(monkeypatch, op, shape):
    """Each of the nine segment ops, on the reference's own operands, gives
    the reference's value within 1e-4 of the output's scale. getrf: the
    port's packed LU factor holds the reference's unit-lower L below the
    diagonal."""
    kernel = port_decompose.KernelSpec(op, shape)
    want, operands = _reference_segment(monkeypatch, ref_decompose.KernelSpec(op, shape), seed=5)
    got = port_decompose.build_kernel_workload_from_reference(kernel, operands, device="cpu")()
    got = got.double().numpy()
    if op == "getrf":
        got = np.tril(got, -1) + np.eye(shape[0])
    assert got.shape == want.shape
    scale = max(float(np.max(np.abs(want))), 1.0)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * scale)


@pytest.mark.parametrize("op,shape", SEGMENTS)
def test_segment_workload_draws_its_own_operands(op, shape):
    kernel = port_decompose.KernelSpec(op, shape)
    run = port_decompose.build_kernel_workload(kernel, seed=2, device="cpu")
    first, second = run(), run()
    assert torch.isfinite(first).all()
    assert torch.equal(first, second)  # the same operands at every call
    again = port_decompose.build_kernel_workload(kernel, seed=2, device="cpu")()
    assert torch.equal(first, again)  # drawn from the seed


def test_segment_workload_refuses_a_missing_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        port_decompose.build_kernel_workload(port_decompose.KernelSpec("dot", (8,)))


def test_wall_clock_explain_on_the_cpu(tmp_path):
    """A wall-clock census explained on the CPU: every anomaly explained
    with a known cause, its segments rebuilt through the families'
    ``explain_workloads`` (the chain family builds the involved pair only)."""
    from repro_torch.core.family import get_family
    from repro_torch.explain import CAUSES

    spec = port_sweep.SweepSpec(
        name="wc", n_shards=2, backend="wall_clock", max_measurements=6,
        families={"kernel_variants": {"sites": ["matmul"], "sizes": [32], "per_size": 2,
                                      "interpret": True},
                  "chain": {"count": 4, "n_matrices": [3], "lo": 16, "hi": 48}})
    census = tmp_path / "census"
    census.mkdir()
    spec.save(str(census / "spec.json"))
    for shard in range(spec.n_shards):
        port_sweep.run_shard(spec, str(census), shard, device="cpu")
    inst = next(i for i in spec.expand() if i.family == "chain")
    pair = list(port_sweep.instance_entry(inst)[0])[:2]
    thunks = get_family("chain").explain_workloads(inst, pair, device="cpu")
    assert sorted(thunks) == sorted(pair)
    assert all(torch.isfinite(t()).all() for t in thunks.values())
    anomalies = [r["uid"] for r in port_sweep.merge_shards(spec, str(census)) if r["is_anomaly"]]
    espec = _explain(port_runner, str(census), str(tmp_path / "e"), "cost_model",
                     device="cpu")
    rows = port_runner.merge_explained(espec, str(tmp_path / "e"))
    assert [r["uid"] for r in rows] == anomalies
    assert all(r["cause"] in CAUSES and 0.0 <= r["evidence"] <= 1.0 for r in rows)
    assert all(r["backend"] == "wall_clock" and r["machine"] == "cpu-1core" for r in rows)


# ------------------------------------------------ graph launch counts ---

def test_count_launch_counts_now_or_at_each_replay(monkeypatch):
    """Outside a capture a launch counts at once; inside one it is recorded
    by the capture in progress (and counted at each replay); a capture the
    port does not own refuses, since its replays would go uncounted."""
    counted = []
    bump = lambda: counted.append(1)  # noqa: E731
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: False)
    graphs.count_launch(bump)
    assert counted == [1]
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: True)
    with pytest.raises(RuntimeError, match="uncounted"):
        graphs.count_launch(bump)
    log = []
    graphs._recording.append(log)
    try:
        graphs.count_launch(bump)
    finally:
        graphs._recording.pop()
    assert counted == [1] and log == [bump]

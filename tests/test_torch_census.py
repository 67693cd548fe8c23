"""The port's census (``repro_torch.core.sweep`` and its families) against
the JAX package's (``repro.core.sweep``): the deterministic backends must
write byte-identical stores (the golden store included), the grids must
expand to the same rows and shards, the FLOP tables and kernel
decompositions must be equal, and the generalized families' workloads must
compute the reference's values on the same numpy bytes (1e-4 of the
output's scale). The wall-clock backend runs here on the CPU
(``device="cpu"``: every wrapper takes its plain version), and every
refusal the port adds is held to its message."""

import threading
import time
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core.sweep as ref_sweep  # noqa: E402
import repro_torch.core.sweep as port_sweep  # noqa: E402
import repro_torch.expressions.algorithms as algorithms  # noqa: E402
from repro.core.family import get_family as ref_family  # noqa: E402
from repro.explain import decompose as ref_decompose  # noqa: E402
from repro_torch.core.family import family_names, get_family  # noqa: E402
from repro_torch.explain import decompose as port_decompose  # noqa: E402

GOLDEN = Path(__file__).resolve().parent / "golden" / "census_small.jsonl"

#: the golden store's spec (tests/test_family.py's)
GOLDEN_FAMILIES = {
    "chain": {"count": 8, "n_matrices": [3, 4], "lo": 24, "hi": 96},
    "gram": {"sizes": [24, 40], "per_size": 2},
    "distributive": {"sizes": [24, 40], "per_size": 2},
    "solve": {"sizes": [24, 40], "per_size": 2},
    "bilinear": {"sizes": [24, 40], "per_size": 2},
}

#: one grid per family, the kernel lane's sizes below 16 included
FAMILY_GRIDS = {
    "chain": {"count": 7, "n_matrices": [3, 4, 5], "lo": 16, "hi": 200},
    "gram": {"sizes": [8, 24, 64], "per_size": 2},
    "distributive": {"sizes": [16, 48], "per_size": 3},
    "solve": {"sizes": [12, 40], "per_size": 2},
    "bilinear": {"sizes": [32, 100], "per_size": 2},
    "kernel_variants": {"sites": ["matmul", "attention", "ssd"], "sizes": [16, 64],
                        "per_size": 2, "interpret": False},
}


def _run(sweep, spec_kwargs, root, **kw):
    spec = sweep.SweepSpec(**spec_kwargs)
    for shard in range(spec.n_shards):
        sweep.run_shard(spec, str(root), shard, **kw)
    return spec, Path(sweep.write_merged(spec, str(root)))


def _store_bytes(root, n_shards):
    files = ["merged.jsonl"] + [f"shard-{s:04d}.{ext}" for s in range(n_shards)
                                for ext in ("jsonl", "manifest.json")]
    return {f: (Path(root) / f).read_bytes() for f in files}


# ------------------------------------------------ deterministic stores ---

def test_cost_model_census_matches_golden_store(tmp_path):
    _, merged = _run(port_sweep, dict(name="census", families=GOLDEN_FAMILIES, n_shards=4,
                                      backend="cost_model", max_measurements=12),
                     tmp_path, device="cpu")
    assert merged.read_bytes() == GOLDEN.read_bytes()


def test_simulated_census_stores_equal_reference(tmp_path):
    """Bimodal timers on half the instances, cache-reuse savings and a
    per-kernel dispatch cost: every shard file, manifest and the merge
    are byte-equal between the packages."""
    kwargs = dict(
        name="sim", n_shards=3, backend="simulated", max_measurements=12,
        chunk_size=3, save_every=4, bimodal_shift=0.4, bimodal_prob=0.3,
        bimodal_frac=0.5, cache_reuse_frac=0.4, cache_reuse_saving=0.25,
        dispatch_s=2e-6, base_seed=7,
        families={"chain": {"count": 6, "n_matrices": [3, 4], "lo": 16, "hi": 96},
                  "gram": {"sizes": [24], "per_size": 2},
                  "solve": {"sizes": [24], "per_size": 2},
                  "bilinear": {"sizes": [40], "per_size": 2}},
    )
    _run(port_sweep, kwargs, tmp_path / "port", device="cpu")
    _run(ref_sweep, kwargs, tmp_path / "ref")
    assert _store_bytes(tmp_path / "port", 3) == _store_bytes(tmp_path / "ref", 3)


def test_kernel_variants_cost_model_records_equal_reference(tmp_path):
    """The kernel lane's records, size 8 (a tile the hand GEMM lacks) and
    the library baseline's reference name ``xla_dot`` included."""
    kwargs = dict(name="kv", n_shards=2, backend="cost_model", max_measurements=9,
                  families={"kernel_variants": {"sites": ["matmul", "attention"],
                                                "sizes": [8, 32], "per_size": 2}})
    _, merged = _run(port_sweep, kwargs, tmp_path / "port", device="cpu")
    _run(ref_sweep, kwargs, tmp_path / "ref")
    assert _store_bytes(tmp_path / "port", 2) == _store_bytes(tmp_path / "ref", 2)
    text = merged.read_text()
    assert '"xla_dot"' in text and "torch_matmul" not in text
    assert "kernel_variants-matmul-n8-s000" in text and "blocks_8x8x8" in text


def test_spec_json_equal_reference(tmp_path):
    kwargs = dict(name="s", families=FAMILY_GRIDS, backend="wall_clock", n_shards=5)
    port_sweep.SweepSpec(**kwargs).save(str(tmp_path / "port.json"))
    ref_sweep.SweepSpec(**kwargs).save(str(tmp_path / "ref.json"))
    assert (tmp_path / "port.json").read_bytes() == (tmp_path / "ref.json").read_bytes()
    assert port_sweep.SweepSpec.load(str(tmp_path / "ref.json")) == port_sweep.SweepSpec(**kwargs)


# --------------------------------------------------- grids and metadata ---

@pytest.mark.parametrize("family", sorted(FAMILY_GRIDS))
def test_expand_uids_and_shards_equal_reference(family):
    kwargs = dict(families={family: FAMILY_GRIDS[family]}, n_shards=3)
    port_spec, ref_spec = port_sweep.SweepSpec(**kwargs), ref_sweep.SweepSpec(**kwargs)
    port_rows, ref_rows = port_spec.expand(), ref_spec.expand()
    assert [i.to_dict() for i in port_rows] == [i.to_dict() for i in ref_rows]
    assert [port_spec.shard_of(i) for i in port_rows] == [ref_spec.shard_of(i) for i in ref_rows]


def test_registry_order_equals_reference():
    from repro.core.family import family_names as ref_names

    assert family_names() == ref_names()


@pytest.mark.parametrize("family", sorted(FAMILY_GRIDS))
def test_flops_tables_and_kernels_equal_reference(family):
    """Each instance's FLOP table and compact kernel decomposition (the
    record fields) and the params-only rebuild (``decompose``)."""
    for inst in port_sweep.SweepSpec(families={family: FAMILY_GRIDS[family]}).expand():
        flops, meta, _ = port_sweep.instance_entry(inst)
        ref_flops, ref_meta, _ = ref_sweep.instance_entry(inst)
        assert flops == ref_flops and list(flops) == list(ref_flops)
        assert meta == ref_meta
        assert (port_decompose.kernels_to_compact(get_family(family).decompose(inst.params))
                == ref_decompose.kernels_to_compact(ref_family(family).decompose(inst.params)))


@pytest.mark.parametrize("family,size", [("gram", 8), ("gram", 100), ("distributive", 33),
                                         ("solve", 64), ("bilinear", 17)])
def test_generalized_decomposition_and_flops_equal_reference(family, size):
    from repro.expressions.generalized import FAMILIES as REF
    from repro_torch.expressions.generalized import FAMILIES as PORT

    assert PORT[family](n=size).flops_table() == REF[family](n=size).flops_table()
    got = port_decompose.kernels_to_compact(port_decompose.decompose_generalized(family, size))
    want = ref_decompose.kernels_to_compact(ref_decompose.decompose_generalized(family, size))
    assert got == want
    for alg, kernels in port_decompose.decompose_generalized(family, size).items():
        assert sum(k.flops for k in kernels) == pytest.approx(PORT[family](n=size).flops_table()[alg])


def test_kernels_from_record_round_trip():
    record = {"family": "chain", "kernels": {"a": [["gemm", [3, 4, 5]]]}}
    assert port_decompose.kernels_from_record(record) == {
        "a": [port_decompose.KernelSpec("gemm", (3, 4, 5))]}
    params = {"n_matrices": 4, "lo": 16, "hi": 64, "seed": 3}
    rebuilt = port_decompose.kernels_from_record({"family": "chain", "params": params})
    assert (port_decompose.kernels_to_compact(rebuilt)
            == ref_decompose.kernels_to_compact(
                ref_decompose.kernels_from_record({"family": "chain", "params": params})))


# ------------------------------------------- generalized workloads' values ---

def _numpy_inputs(family, size, seed):
    """The family's inputs made with numpy at the reference's scalings
    (solve: the SPD shift of ``generalized.py``)."""
    rng = np.random.default_rng(seed)

    def normal(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    if family == "gram":
        k = max(1, size // 4)
        return [normal(size, k) / np.float32(np.sqrt(k)), normal(size, size) / np.float32(np.sqrt(size))]
    if family == "distributive":
        return [normal(size, size) / np.float32(np.sqrt(size)) for _ in range(3)]
    if family == "solve":
        a = normal(size, size) / np.float32(np.sqrt(size))
        a = (a @ a.T + size * np.eye(size, dtype=np.float32)).astype(np.float32)
        return [a, normal(size)]
    return [normal(size), normal(size, size) / np.float32(np.sqrt(size)), normal(size)]


@pytest.mark.parametrize("family", ["gram", "distributive", "solve", "bilinear"])
@pytest.mark.parametrize("size", [24, 96])
def test_generalized_workloads_match_reference(family, size):
    import jax.numpy as jnp
    from repro.expressions.generalized import FAMILIES as REF
    from repro_torch.expressions.generalized import FAMILIES as PORT

    arrays = _numpy_inputs(family, size, seed=size)
    ref_fam = REF[family](n=size)
    port_table = PORT[family](n=size).workloads_from_reference(arrays, device="cpu")
    assert list(port_table) == [v.name for v in ref_fam.variants]
    for variant in ref_fam.variants:
        want = np.asarray(variant.build(*[jnp.asarray(a) for a in arrays])(), dtype=np.float64)
        got = port_table[variant.name]().double().numpy()
        assert got.shape == want.shape, variant.name
        scale = float(np.max(np.abs(want)))
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * scale, err_msg=variant.name)


@pytest.mark.parametrize("family", ["gram", "distributive", "solve", "bilinear"])
def test_generalized_inputs_follow_the_reference_scalings(family):
    """The port's own generator: seeded (same seed, same bytes), the
    reference's shapes, and solve's matrix symmetric positive definite."""
    from repro_torch.expressions.generalized import FAMILIES as PORT

    fam = PORT[family](n=32)
    a = fam.make_inputs(32, 3, torch.device("cpu"))
    b = fam.make_inputs(32, 3, torch.device("cpu"))
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert [tuple(x.shape) for x in a] == [tuple(x.shape) for x in _numpy_inputs(family, 32, 0)]
    if family == "solve":
        assert torch.allclose(a[0], a[0].T)
        assert float(torch.linalg.eigvalsh(a[0].double()).min()) > 32 - 1e-3


# ------------------------------------------------ wall clock on the CPU ---

def test_wall_clock_census_pauses_mid_chunk_and_resumes_on_cpu(tmp_path):
    """Chain, bilinear and kernel_variants (plain versions) on wall clock:
    a pause mid-chunk leaves engine state, the resume rebuilds the
    workloads on the CPU and completes every instance."""
    spec = port_sweep.SweepSpec(
        backend="wall_clock", n_shards=1, chunk_size=2, max_measurements=6,
        eps=-1.0,  # never converges: each session takes exactly 2 steps
        families={"chain": {"count": 2, "n_matrices": [3], "lo": 8, "hi": 24},
                  "bilinear": {"sizes": [16], "per_size": 1},
                  "kernel_variants": {"sites": ["matmul", "attention", "ssd"], "sizes": [16],
                                      "per_size": 1}},
    )
    port_sweep.run_shard(spec, str(tmp_path), 0, max_steps=3, device="cpu")
    assert port_sweep.ShardStore(str(tmp_path), 0).has_engine_state()
    port_sweep.run_shard(spec, str(tmp_path), 0, device="cpu")
    store = port_sweep.ShardStore(str(tmp_path), 0)
    assert not store.has_engine_state()
    records = store.open().records
    assert sorted(r["uid"] for r in records) == sorted(i.uid for i in spec.expand())
    matmul = next(r for r in records if r["uid"] == "kernel_variants-matmul-n16-s000")
    assert set(matmul["flops"]) == {"blocks_16x16x16", "xla_dot"}
    # sessions measured after the resume carry the timer's inner repeats
    assert any(set(r.get("inner_repeats", {})) == set(r["flops"]) for r in records)
    assert all(r["backend"] == "wall_clock" for r in records)


# -------------------------------------------------------------- refusals ---

def _kv_instance(site="matmul", size=16, interpret=True):
    return get_family("kernel_variants").expand_grid(
        {"sites": [site], "sizes": [size], "interpret": interpret})[0]


@pytest.mark.parametrize("site", ["matmul", "attention", "ssd"])
def test_interpret_instance_refuses_cuda(site, monkeypatch):
    """interpret=True has no counterpart on the card; the refusal comes
    before anything is allocated (CUDA is faked as present)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    _, _, build = port_sweep.instance_entry(_kv_instance(site))
    with pytest.raises(ValueError, match="--kernel-native"):
        build("cuda")


def test_native_instance_builds_on_cpu_plain_versions():
    _, _, build = port_sweep.instance_entry(_kv_instance(interpret=False))
    table = build("cpu")
    assert set(table) == {"blocks_16x16x16", "xla_dot"}
    assert torch.allclose(table["blocks_16x16x16"](), table["xla_dot"](), atol=1e-4)


def test_size_8_wall_clock_matmul_build_refuses():
    _, _, build = port_sweep.instance_entry(_kv_instance(size=8))
    with pytest.raises(ValueError, match=r"unsupported GEMM tile \(8, 8, 8\).*size of 16 or more"):
        build("cpu")


def test_cuda_device_without_a_card_refuses(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    inst = port_sweep.SweepSpec(families={"bilinear": {"sizes": [16]}}).expand()[0]
    _, _, build = port_sweep.instance_entry(inst)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build("cuda")


def test_predictor_spec_refused(tmp_path):
    """A spec with ``predictor_model`` (an active census) runs and predicts
    the instances its model is sure of, and its store is the reference's
    byte for byte. The name is the refusal test's that this one replaced,
    kept so that its history stays traceable."""
    from repro_torch.predict.model import train_model

    families = {"solve": {"sizes": [16, 32], "per_size": 3}, "bilinear": {"sizes": [16], "per_size": 2}}
    full, _ = _run(port_sweep, dict(families=families, max_measurements=6), tmp_path / "full", device="cpu")
    model = train_model(full, port_sweep.merge_shards(full, str(tmp_path / "full"))).save(
        str(tmp_path / "model.json"))
    kwargs = dict(families=families, max_measurements=6, predictor_model=model)
    spec, _ = _run(port_sweep, kwargs, tmp_path / "port", device="cpu")
    _run(ref_sweep, kwargs, tmp_path / "ref")
    records = port_sweep.merge_shards(spec, str(tmp_path / "port"))
    assert {r["family"] for r in records if r.get("provenance") == "predicted"} == {"solve"}
    assert _store_bytes(tmp_path / "port", spec.n_shards) == _store_bytes(tmp_path / "ref", spec.n_shards)


def test_explain_tables_equal_reference_without_records():
    """The explain tables are ported (item 4): with no explained anomaly
    they render the reference's text (records: tests/test_torch_explain.py)."""
    from repro.launch.report_md import explain_tables as ref_tables
    from repro_torch.launch.report_md import explain_tables

    assert explain_tables([], name="t") == ref_tables([], name="t")


def test_census_tables_render_the_port_store(tmp_path):
    from repro.launch.report_md import census_tables as ref_tables
    from repro_torch.launch.report_md import census_tables

    spec, _ = _run(port_sweep, dict(families=GOLDEN_FAMILIES, n_shards=2, max_measurements=9),
                   tmp_path, device="cpu")
    records = port_sweep.merge_shards(spec, str(tmp_path))
    assert census_tables(records, name="t") == ref_tables(records, name="t")
    assert port_sweep.census_summary(records) == ref_sweep.census_summary(records)


# ------------------------------------------------------------ draw-ahead ---

DRAW_PREFIX = "rt-draw"


def _draw_threads():
    return [t for t in threading.enumerate() if t.name.startswith(DRAW_PREFIX)]


def _mixed_jobs(n=8):
    """(dims, seed) of ``n`` chain instances of 3 to 5 matrices, dims in [8, 64]."""
    rng = np.random.default_rng(7)
    return [(tuple(int(d) for d in rng.integers(8, 65, size=int(rng.integers(4, 7)))), 100 + k)
            for k in range(n)]


def _wait_for(cond, what, timeout=20.0):
    deadline = time.monotonic() + timeout
    while not cond():
        assert time.monotonic() < deadline, what
        time.sleep(0.005)


def _cores(monkeypatch, n):
    """Usable cores seen by the draw-ahead: ``n`` (so ``n - 1`` workers)."""
    monkeypatch.setattr(algorithms.os, "sched_getaffinity", lambda pid: set(range(n)))


def test_draw_ahead_hands_back_the_serial_draws_whatever_order_they_finish(monkeypatch):
    """Eight instances of mixed dims: the first draw is held until the other
    started draws have finished, and every instance still comes back
    ``torch.equal`` to the serial ``make_chain_inputs(..., device="cpu")``."""
    jobs = _mixed_jobs()
    real, finished, lock = algorithms.draw_chain_inputs, [], threading.Lock()
    _cores(monkeypatch, 4)

    def delayed(dims, seed):
        if seed == jobs[0][1]:  # the first job finishes after the others it started with
            _wait_for(lambda: len(finished) >= ahead.workers - 1, "the other draws never finished")
        out = real(dims, seed)
        with lock:
            finished.append(seed)
        return out

    monkeypatch.setattr(algorithms, "draw_chain_inputs", delayed)
    ahead = algorithms.DrawAhead()
    try:
        ahead.plan(jobs)
        assert ahead.workers == 3
        got = [ahead.take(dims, seed) for dims, seed in jobs]
    finally:
        ahead.close()
    assert finished[0] != jobs[0][1] and sorted(finished) == sorted(s for _, s in jobs)
    for (dims, seed), mats in zip(jobs, got):
        want = algorithms.make_chain_inputs(dims, seed=seed, device="cpu")
        assert len(mats) == len(want) == len(dims) - 1
        assert all(m.dtype == torch.float32 and torch.equal(m, w) for m, w in zip(mats, want))
    assert not _draw_threads()


def test_draw_ahead_holds_at_most_workers_instances_untaken(monkeypatch):
    """An instrumented draw that finishes at once: with 4 usable cores (3
    workers), 3 draws start at the plan and one more after each take, so
    never more than 3 instances are drawn and not yet taken."""
    jobs = _mixed_jobs()
    real, started, lock = algorithms.draw_chain_inputs, [], threading.Lock()
    _cores(monkeypatch, 4)

    def counted(dims, seed):
        with lock:
            started.append(seed)
        return real(dims, seed)

    monkeypatch.setattr(algorithms, "draw_chain_inputs", counted)
    ahead = algorithms.DrawAhead()
    try:
        ahead.plan(jobs)
        assert ahead.workers == 3
        for taken in range(len(jobs) + 1):
            expect = min(ahead.workers + taken, len(jobs))
            _wait_for(lambda: len(started) >= expect, f"{expect} draws never started")
            time.sleep(0.05)  # room for a draw the bound forbids to start
            assert len(started) == expect
            if taken < len(jobs):
                assert ahead.take(*jobs[taken]) is not None
    finally:
        ahead.close()
    assert sorted(started) == sorted(s for _, s in jobs)


def test_draw_ahead_raises_a_draw_fault_at_its_take(monkeypatch):
    """A worker's exception is raised on the caller when that instance is
    taken, not before; the instances before it come back whole."""
    jobs = _mixed_jobs(3)
    real, raised_on = algorithms.draw_chain_inputs, []

    def faulty(dims, seed):
        if seed == jobs[1][1]:
            raised_on.append(threading.current_thread())
            raise RuntimeError(f"planted draw fault {seed}")
        return real(dims, seed)

    monkeypatch.setattr(algorithms, "draw_chain_inputs", faulty)
    ahead = algorithms.DrawAhead()
    try:
        ahead.plan(jobs)
        assert ahead.take(*jobs[0]) is not None
        with pytest.raises(RuntimeError, match="planted draw fault"):
            ahead.take(*jobs[1])
        assert ahead.take(*jobs[2]) is not None
    finally:
        ahead.close()
    assert raised_on and raised_on[0] is not threading.main_thread()
    assert not _draw_threads()


CHAIN_SPEC = dict(backend="wall_clock", n_shards=1, chunk_size=2, max_measurements=6,
                  eps=-1.0,  # never converges: each session takes exactly 2 steps
                  families={"chain": {"count": 4, "n_matrices": [3, 4], "lo": 8, "hi": 40}})


def _recorded_builds(monkeypatch):
    """Wrap the draw and ``build_workloads``: the threads each draw ran on,
    and whether each build's matrices equal the serial CPU draw."""
    real_draw, real_build = algorithms.draw_chain_inputs, algorithms.build_workloads
    seen = {"draw_threads": [], "builds": []}
    serial = {}  # dims -> the serial CPU draw, made before the draw is wrapped
    for inst in port_sweep.SweepSpec(**CHAIN_SPEC).expand():
        dims = tuple(get_family("chain").entry(inst)[1]["dims"])
        serial[dims] = algorithms.make_chain_inputs(dims, seed=inst.params["seed"], device="cpu")

    def draw(dims, seed):
        seen["draw_threads"].append((threading.current_thread(), _draw_threads()))
        return real_draw(dims, seed)

    def build(algs, mats, **kw):
        dims = [m.shape[0] for m in mats] + [mats[-1].shape[1]]
        want = serial[tuple(dims)]
        seen["builds"].append(len(mats) == len(want)
                              and all(torch.equal(m, w) for m, w in zip(mats, want)))
        return real_build(algs, mats, **kw)

    monkeypatch.setattr(algorithms, "draw_chain_inputs", draw)
    monkeypatch.setattr(algorithms, "build_workloads", build)
    return seen


def test_cpu_census_draws_on_the_caller_and_starts_no_thread(tmp_path, monkeypatch):
    """A wall-clock census on the CPU draws each instance serially on the
    caller's thread: no draw thread is ever started."""
    seen = _recorded_builds(monkeypatch)
    port_sweep.run_shard(port_sweep.SweepSpec(**CHAIN_SPEC), str(tmp_path), 0, device="cpu")
    assert len(seen["draw_threads"]) == len(seen["builds"]) == 4 and all(seen["builds"])
    assert all(t is threading.main_thread() and not live for t, live in seen["draw_threads"])


def _forced(monkeypatch):
    """The draw-ahead engaged on the CPU, as on a CUDA device."""
    monkeypatch.setattr(algorithms, "draws_ahead", lambda device: True)


def test_census_draw_fault_surfaces_and_leaves_no_draw_thread(tmp_path, monkeypatch):
    _forced(monkeypatch)
    real = algorithms.draw_chain_inputs
    raised_on = []

    def faulty(dims, seed):
        if seed == 1:
            raised_on.append(threading.current_thread())
            raise RuntimeError("planted draw fault")
        return real(dims, seed)

    monkeypatch.setattr(algorithms, "draw_chain_inputs", faulty)
    with pytest.raises(RuntimeError, match="planted draw fault"):
        port_sweep.run_shard(port_sweep.SweepSpec(**CHAIN_SPEC), str(tmp_path), 0, device="cpu")
    assert raised_on and raised_on[0].name.startswith(DRAW_PREFIX)
    assert not _draw_threads()


def test_census_draws_ahead_counts_each_build_once_under_the_profiler(tmp_path, monkeypatch):
    """The draw-ahead engaged on the CPU: a census paused mid-chunk and
    resumed builds 6 instances (2, the paused chunk's 2 again on resume,
    2), each from matrices equal to the serial draw, drawn on draw threads;
    under ``torch.profiler`` ``rt.inputs.ready`` + ``rt.inputs.waited``
    equals the instances built and the ``rt.inputs`` spans; no draw thread
    outlives ``run_shard``."""
    from torch.profiler import ProfilerActivity, profile

    _forced(monkeypatch)
    seen = _recorded_builds(monkeypatch)
    spec = port_sweep.SweepSpec(**CHAIN_SPEC)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        port_sweep.run_shard(spec, str(tmp_path), 0, max_steps=3, device="cpu")
        assert not _draw_threads()
        assert port_sweep.ShardStore(str(tmp_path), 0).has_engine_state()
        port_sweep.run_shard(spec, str(tmp_path), 0, device="cpu")
    assert not _draw_threads()
    names = [e.name() for e in prof.profiler.kineto_results.events()]
    counters = names.count("rt.inputs.ready") + names.count("rt.inputs.waited")
    assert counters == names.count("rt.inputs") == len(seen["builds"]) == 6
    assert all(seen["builds"])
    assert all(t.name.startswith(DRAW_PREFIX) for t, _ in seen["draw_threads"])
    assert len(port_sweep.ShardStore(str(tmp_path), 0).open().records) == 4

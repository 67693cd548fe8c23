"""The ``kda-prefill-16k`` and ``chain-census-small`` cells at CPU size, the
KDA cell's yardstick against the port, and the new readers on hand-built
traces.

The KDA cell's run is the driver as on the chip at small widths (2 heads of
16, 64 tokens a call as 1x64 and 2x32, chunks 16 and 32): ``correct`` on
the program as it is, not correct for the TF32 control and for each
planted fault. Tolerances: the chunked core in float32 against the float64
recurrence reads about 1e-7 at these widths (a few float32 roundings of
sums of at most 64 terms), under the cell's limit of 5e-5 with room; the
recurrence with TF32 operands (10 mantissa bits) reads above 1e-4.
``chain-census-small`` is the census driver on its own traffic file,
at dims U[16, 40] here."""

import json
import time

import pytest
import torch

from portbench import formulas_kda, reference, reference_kda
from portbench.harness import Calls, RunData, Verdict, cell_metrics, load_module, run_cell
from portbench.trace import TraceData, Tracer

from .conftest import ROOT

KDA = "kda-prefill-16k"
CENSUS = "chain-census-small"
SMALL = {
    KDA: ({"hidden_size": 64, "linear_attn_config": {"num_heads": 2, "head_dim": 16}},
          {"tokens": 64, "seq_lens": [64, 32], "chunks": [16, 32], "check_every": 2}),
    CENSUS: ({}, {"lo": 16, "hi": 40, "pool_shards": 2, "warmup_instances": 1, "check_per_shard": 2}),
}
MS = 1_000_000  # ns


def small(cell):
    from portbench.run import load_cell

    bench, _, config, traffic = load_cell(cell)
    config.update(SMALL[cell][0])
    traffic.update(SMALL[cell][1])
    return bench, config, traffic


def run(cell=KDA, trace=False, control=False, seed=2**33 + 13):
    bench, config, traffic = small(cell)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return run_cell(bench, cell, config, traffic, seed=seed, seconds=0.3, trace=trace,
                        device=torch.device("cpu"), started=time.monotonic(), control=control)
    finally:
        torch.set_num_threads(threads)


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("cell", [KDA, CENSUS])
def test_cell_runs_correct_with_its_metrics(cell, trace):
    result = run(cell, trace=trace)
    json.loads(json.dumps(result, allow_nan=False))
    assert result["correct"], result["checks"]
    assert result["failed"] == 0 and result["attempted"] >= 1
    bench = small(cell)[0]
    expected = {m["name"] for m in cell_metrics(bench, cell, "per_layer" if trace else "end_to_end")}
    if not trace:
        assert set(result["metrics"]) == expected == {"verdicts_per_s", "setup_s"}
    elif cell == KDA:  # kda_roofline reads device activity, which a CPU run has none of
        assert expected == {"kda_roofline", "kda_host_ms_per_verdict"}
        assert set(result["metrics"]) == {"kda_host_ms_per_verdict"}
        assert result["metrics"]["kda_host_ms_per_verdict"]["value"] > 0
    else:
        assert expected == {"inputs_ms_per_verdict"} and set(result["metrics"]) == expected
    if cell == KDA:
        assert set(result["checks"]) == {"verdict_mismatches", "out_err", "verdicts", "failed"}
        assert result["checks"]["out_err"]["value"] < 1e-6
    else:
        assert result["checks"]["product_err"]["value"] < 1e-5


def test_control_is_not_correct():
    result = run(control=True)
    assert not result["correct"]
    assert result["checks"]["out_err"]["value"] > 1e-4


def _fault(monkeypatch, kind):
    import repro_torch.autotune.variants as variants

    if kind == "beta":  # the delta rule's β dropped: every write at full strength
        real = variants.kda_chunked
        monkeypatch.setattr(variants, "kda_chunked",
                            lambda q, k, v, g, beta, *a, **kw: real(q, k, v, g, torch.ones_like(beta), *a, **kw))
    elif kind == "state":  # the incoming state ignored
        real = variants.kda_chunked
        monkeypatch.setattr(variants, "kda_chunked", lambda *a, **kw: real(*a[:6]))
    elif kind == "tf32":  # the core's products in TF32
        real = torch.Tensor.__matmul__
        monkeypatch.setattr(torch.Tensor, "__matmul__",
                            lambda a, b: real(reference.tf32(a), reference.tf32(b)))
    else:
        import dataclasses

        import repro_torch.autotune.tuner as tuner

        real = tuner.flops_discriminant_test
        monkeypatch.setattr(tuner, "flops_discriminant_test", lambda *a, **k: dataclasses.replace(
            real(*a, **k), is_anomaly=not real(*a, **k).is_anomaly))


@pytest.mark.parametrize("kind", ["beta", "state", "tf32", "verdict"])
def test_planted_fault_is_not_correct(monkeypatch, kind):
    _fault(monkeypatch, kind)
    result = run()
    assert not result["correct"], result["checks"]


def test_frozen_formulas_match_the_site_and_the_model():
    from repro_torch.autotune.variants import kda_chunk_site
    from repro_torch.configs.kimi_linear_48b_a3b import ONE_CARD
    from repro_torch.models.flops import kda_chunk_flops

    config = json.loads((ROOT / "portbench" / "configs" / "kimi-linear-48b-a3b.json").read_text())
    w = formulas_kda.widths(config)
    assert w == {"h": ONE_CARD.kda_heads, "dk": ONE_CARD.kda_head_dim, "dv": ONE_CARD.kda_head_dim}
    for b, s in ((1, 16384), (2, 8192), (4, 4096), (8, 2048), (1, 100)):
        for c in (16, 32, 64, 128):
            assert formulas_kda.kda_flops(b, s, 32, 128, 128, c) == kda_chunk_flops(b, s, 32, 128, 128, c)
    site = kda_chunk_site(b=2, s=64, h=2, dk=16, dv=16, chunks=(16, 32), device="cpu")
    assert site.flops_table() == {f"chunk_{c}": formulas_kda.kda_flops(2, 64, 2, 16, 16, c) for c in (16, 32)}
    # 1 x 16384 at 32 heads of 128: 126976, 151552 and 200704 FLOPs a token and head
    assert [formulas_kda.kda_flops(1, 16384, 32, 128, 128, c) / (16384 * 32) for c in (32, 64, 128)] == [
        126976.0, 151552.0, 200704.0]
    assert formulas_kda.kda_bytes(1, 16384, 32, 128, 128) == (16384 * 32 * (4 * 128 + 1 + 128)
                                                              + 2 * 32 * 128 * 128) * 4


def test_reference_matches_the_model_path():
    from portbench.drivers.kda_rank import inputs
    from repro_torch.models.kda import kda_chunked

    w = {"h": 2, "dk": 16, "dv": 16}
    q, k, v, g, beta, s0 = inputs(2, 80, w, 0.2, 7, torch.device("cpu"))
    ref_o, ref_s = reference_kda.recurrence(q, k, v, g, beta, s0)
    for chunk in (16, 32, 64):
        o, s = kda_chunked(q, k, v, g, beta, chunk, s0)
        assert reference.rel_max_err(o, ref_o) < 1e-6 and reference.rel_max_err(s, ref_s) < 1e-6
    ctl = reference_kda.recurrence(q, k, v, g, beta, s0, control=True)
    assert max(reference.rel_max_err(a, b) for a, b in zip(ctl, (ref_o, ref_s))) > 1e-4


def _run_of(host, verdicts=2):
    trace = TraceData(window=(0, 100 * MS), host=[(a, b, n, 0) for a, b, n in host], device=[])
    return RunData(window_s=0.1, calls=Calls(Tracer(on=False, cuda=False)), trace=trace,
                   verdicts=[Verdict(latency_s=None, measurements=1, build_s=None)] * verdicts)


def test_host_reader():
    read = load_module("metrics", "kda_host_ms_per_verdict").read
    host = [(-10 * MS, 10 * MS, "rt.kda.chunk"), (20 * MS, 26 * MS, "rt.kda.chunk"),
            (21 * MS, 25 * MS, "rt.kda.pass"), (0, 50 * MS, "rt.build")]
    assert read(_run_of(host)) == pytest.approx((10 + 6) / 2)
    assert read(_run_of([(0, 50 * MS, "rt.build")])) is None  # a program without the span
    assert read(_run_of([])) is None


def test_roofline_reader_reads_nothing_without_device_work():
    read = load_module("metrics", "kda_roofline").read
    run_ = _run_of([(0, 50 * MS, "rt.kda.chunk")])
    assert read(run_) is None
    run_.calls.bounds[0] = 1e-3
    run_.trace.calls[0] = (0, 40 * MS)
    assert read(run_) is None  # no kernel in the call's span
    run_.trace.host.append((MS, 2 * MS, "cudaLaunchKernel", 7))
    run_.trace.device.append((3 * MS, 7 * MS, "kernel", 7))
    assert read(run_) == pytest.approx(100 * 1e-3 / 4e-3)


def test_yardstick_imports_nothing_of_the_program():
    from portbench.harness import HERE

    from .test_portbench_imports import imported_tops

    for name in ("formulas_kda.py", "reference_kda.py"):
        assert not {"repro_torch", "repro", "jax"} & set(imported_tops(HERE / name)), name

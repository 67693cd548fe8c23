"""The ``mla-extend-16k`` cell at CPU size, its yardstick against the port,
and ``inputs_ms_per_verdict`` on hand-built traces.

The cell's run is the driver as on the chip at small widths (4 heads, a
latent of 32, a cache of 128 rows): ``correct`` on the program as it is,
not correct for the TF32 control and for each planted fault. Tolerances:
the model path in float32 against the float64 reference at these widths
reads about 1e-7 (a few float32 roundings of sums of at most 128 terms),
under the cell's limit of 5e-5 with room; TF32 operands (10 mantissa bits)
read above 1e-4."""

import dataclasses
import json
import time

import pytest
import torch

from portbench import formulas_mla, reference, reference_mla
from portbench.harness import Calls, RunData, Verdict, cell_metrics, load_module, run_cell
from portbench.trace import TraceData, Tracer

from .conftest import ROOT

CELL = "mla-extend-16k"
SMALL_CONFIG = {"hidden_size": 64, "num_attention_heads": 4, "num_key_value_heads": 4,
                "kv_lora_rank": 32, "qk_nope_head_dim": 16, "qk_rope_head_dim": 8, "v_head_dim": 16}
SMALL_TRAFFIC = {"cache_len": 128, "q_lens": [8, 32], "check_every": 2}
MS = 1_000_000  # ns


def small():
    from portbench.run import load_cell

    bench, _, config, traffic = load_cell(CELL)
    config.update(SMALL_CONFIG)
    traffic.update(SMALL_TRAFFIC)
    return bench, config, traffic


def run(trace=False, control=False, seed=2**33 + 11):
    bench, config, traffic = small()
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return run_cell(bench, CELL, config, traffic, seed=seed, seconds=0.3, trace=trace,
                        device=torch.device("cpu"), started=time.monotonic(), control=control)
    finally:
        torch.set_num_threads(threads)


@pytest.mark.parametrize("trace", [False, True])
def test_cell_runs_correct_with_its_metrics(trace):
    result = run(trace=trace)
    json.loads(json.dumps(result, allow_nan=False))
    assert result["correct"], result["checks"]
    assert set(result["checks"]) == {"verdict_mismatches", "out_err", "verdicts", "failed"}
    assert result["checks"]["out_err"]["value"] < 1e-6
    bench = small()[0]
    expected = {m["name"] for m in cell_metrics(bench, CELL, "per_layer" if trace else "end_to_end")}
    if trace:  # mla_roofline reads device activity, which a CPU run has none of
        assert expected == {"mla_roofline"} and result["metrics"] == {}
    else:
        assert set(result["metrics"]) == expected == {"verdicts_per_s", "setup_s"}


def test_control_is_not_correct():
    result = run(control=True)
    assert not result["correct"]
    assert result["checks"]["out_err"]["value"] > 1e-4


def _fault(monkeypatch, kind):
    import repro_torch.autotune.variants as variants
    import repro_torch.models.mla as mla

    if kind == "answer":
        real = variants.mla_attention

        def altered(*a, **k):
            out = real(*a, **k).clone()
            out[0, 0, 0] += 1.0
            return out

        monkeypatch.setattr(variants, "mla_attention", altered)
    elif kind == "cache":  # the new latents written one row early
        real = mla.update_slice_
        monkeypatch.setattr(mla, "update_slice_", lambda t, new, start, dim: real(t, new, start - 1, dim))
    elif kind == "scale":  # YaRN's attention factor left out of the softmax scale
        monkeypatch.setattr(mla, "softmax_scale",
                            lambda cfg: (cfg.qk_nope_head_dim + cfg.qk_rope_head_dim) ** -0.5)
    else:
        import repro_torch.autotune.tuner as tuner

        real = tuner.flops_discriminant_test
        monkeypatch.setattr(tuner, "flops_discriminant_test", lambda *a, **k: dataclasses.replace(
            real(*a, **k), is_anomaly=not real(*a, **k).is_anomaly))


@pytest.mark.parametrize("kind", ["answer", "cache", "scale", "verdict"])
def test_planted_fault_is_not_correct(monkeypatch, kind):
    _fault(monkeypatch, kind)
    result = run()
    assert not result["correct"], result["checks"]


def test_frozen_flops_match_the_site_and_the_model():
    from repro_torch.autotune.variants import mla_site
    from repro_torch.configs import get_config
    from repro_torch.models.flops import mla_algorithm_flops

    config = json.loads((ROOT / "portbench" / "configs" / "deepseek-v2-lite.json").read_text())
    w = formulas_mla.widths(config)
    full = get_config("deepseek-v2-lite")
    for q in (1, 64, 128, 169, 256, 512):
        assert formulas_mla.mla_flops(w, q, 16384) == mla_algorithm_flops(full, q, 16384)
    assert formulas_mla.mla_flops(w, 64, 16384)["absorb"] == pytest.approx(38.27e9, rel=1e-3)
    assert formulas_mla.mla_flops(w, 64, 16384)["decompress"] == pytest.approx(80.95e9, rel=1e-3)
    _, config, _ = small()
    from portbench.drivers.mla_rank import model_config

    cfg = model_config(config)
    site = mla_site(q=8, L=128, b=2, cfg=cfg, device="cpu")
    assert site.flops_table() == formulas_mla.mla_flops(formulas_mla.widths(config), 8, 128, 2)
    assert tuple(site.flops_table()) == formulas_mla.VARIANTS


def test_reference_matches_the_model_path():
    from portbench.drivers.mla_rank import inputs, model_config, weights
    from repro_torch.models.mla import mla_attention

    _, config, _ = small()
    w = formulas_mla.widths(config)
    params = weights(w, 3, torch.device("cpu"))
    x, c, kr = inputs(w, 2, 8, 128, 4, torch.device("cpu"))
    ref = reference_mla.extend(config, params, x, c, kr)
    tf32 = reference_mla.extend(config, params, x, c, kr, control=True)
    for impl in formulas_mla.VARIANTS:
        cache = {"c": c.clone(), "kr": kr.clone()}
        out = mla_attention(model_config(config), params, x, 120, cache, impl=impl)
        for got, want in zip((out, cache["c"][:, 120:], cache["kr"][:, 120:]), ref):
            assert reference.rel_max_err(got, want) < 1e-6, impl
        assert torch.equal(cache["c"][:, :120], c[:, :120])
    assert max(reference.rel_max_err(a, b) for a, b in zip(tf32, ref)) > 1e-4


def _run_of(host, verdicts=2):
    trace = TraceData(window=(0, 100 * MS), host=[(a, b, n, 0) for a, b, n in host], device=[])
    return RunData(window_s=0.1, calls=Calls(Tracer(on=False, cuda=False)), trace=trace,
                   verdicts=[Verdict(latency_s=None, measurements=1, build_s=None)] * verdicts)


def test_inputs_reader():
    read = load_module("metrics", "inputs_ms_per_verdict").read
    host = [(-10 * MS, 10 * MS, "rt.inputs"), (20 * MS, 26 * MS, "rt.inputs"), (0, 50 * MS, "rt.build")]
    assert read(_run_of(host)) == pytest.approx((10 + 6) / 2)
    assert read(_run_of([(0, 50 * MS, "rt.build")])) is None  # a program without the span
    assert read(_run_of([])) is None


def test_yardstick_imports_nothing_of_the_program():
    from portbench.harness import HERE

    from .test_portbench_imports import imported_tops

    for name in ("formulas_mla.py", "reference_mla.py"):
        assert not {"repro_torch", "repro", "jax"} & set(imported_tops(HERE / name)), name

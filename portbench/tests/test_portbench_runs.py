"""Each cell's driver run in process on the CPU at small sizes: the result
line's schema, and ``correct`` true on the program as it is."""

import json

import pytest

from portbench.harness import cell_metrics

CELLS = ["chain-census", "gemm-chain-rank", "ssd-chunk-rank"]


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_correct_with_its_metrics(bench_later, run_small, cell, trace):
    result = run_small(cell, trace=trace)
    json.loads(json.dumps(result, allow_nan=False))
    keys = list(result)
    assert keys[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert keys[-1] == "checks" and ("breakdown" in keys) == trace
    assert result["correct"], result["checks"]
    assert result["failed"] == 0 and result["attempted"] >= 1
    group = "per_layer" if trace else "end_to_end"
    expected = {m["name"]: m["unit"] for m in cell_metrics(bench_later, cell, group)}
    got = {name: m["unit"] for name, m in result["metrics"].items()}
    assert set(got) <= set(expected) and all(expected[n] == u for n, u in got.items())
    if trace:  # idle_share and gemm_roofline read device activity, which a CPU run has none of
        assert set(expected) - set(got) <= {"idle_share", "gemm_roofline"}
        assert result["device"]["window_s"] > 0 and len(result["breakdown"]["idle_gaps"]) <= 10
    else:
        assert set(got) == set(expected)
        assert all(m["value"] > 0 for m in result["metrics"].values())
    for check in result["checks"].values():
        assert set(check) <= {"value", "limit", "at_least"}

"""Fixtures of the benchmark's CPU tests: the benchmark's files, and a cell
run in process on the CPU at sizes a test run holds."""

import copy
import json
import time
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]

#: the cells' traffic and configurations cut to CPU sizes (the same drivers)
SMALL_TRAFFIC = {
    "chain-census": {"lo": 16, "hi": 40, "pool_shards": 2, "warmup_instances": 1,
                     "check_per_shard": 2},
    "gemm-chain-rank": {"lo": 16, "hi": 40, "pool": 4, "check_every": 2},
    "ssd-chunk-rank": {"tokens": 64, "seq_lens": [16, 32], "chunks": [8, 16], "check_every": 2},
}
SMALL_CONFIG = {"mamba2-1.3b": {"d_model": 32, "headdim": 8, "d_state": 8}}


#: a cell whose driver and traffic are ready but which BENCHMARK.json
#: leaves out while the program's census times graphs whose inputs it has
#: freed; its CPU runs (eager, inputs held) are sound
LATER_CELLS = {
    "chain-census": {"name": "chain-census", "config": "paper-chain",
                     "traffic": "census-3000-6000", "chips": 1, "why": "the census path"},
}
LATER_METRICS = ("verdicts_per_s", "setup_s", "idle_share", "mfu", "measurements_per_verdict",
                 "build_ms_per_verdict")


@pytest.fixture(scope="session")
def bench():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


@pytest.fixture(scope="session")
def bench_later(bench):
    """BENCHMARK.json with the later cells added, reporting their metrics."""
    out = copy.deepcopy(bench)
    out["workloads"] += list(LATER_CELLS.values())
    for m in out["end_to_end"] + out["per_layer"]:
        if m["name"] in LATER_METRICS and "workloads" in m:
            m["workloads"] += list(LATER_CELLS)
    return out


def load_small(cell):
    """(cell entry, configuration, traffic) of ``cell``, at CPU sizes."""
    from portbench.run import load_cell

    if cell in LATER_CELLS:
        w = LATER_CELLS[cell]
        config = json.loads((ROOT / "portbench" / "configs" / f"{w['config']}.json").read_text())
        traffic = json.loads((ROOT / "portbench" / "traffic" / f"{w['traffic']}.json").read_text())
    else:
        _, w, config, traffic = load_cell(cell)
    config.update(SMALL_CONFIG.get(w["config"], {}))
    traffic.update(SMALL_TRAFFIC[cell])
    return w, config, traffic


@pytest.fixture
def run_small(bench_later):
    """``run_small(cell, trace=False, control=False)``: one CPU run of a cell."""
    from portbench.harness import run_cell

    def run(cell, trace=False, control=False, seconds=0.3, seed=2**33 + 5):
        w, config, traffic = load_small(cell)
        threads = torch.get_num_threads()
        torch.set_num_threads(1)
        try:
            return run_cell(bench_later, cell, config, traffic, seed=seed, seconds=seconds,
                            trace=trace, device=torch.device("cpu"), started=time.monotonic(),
                            control=control)
        finally:
            torch.set_num_threads(threads)

    return run

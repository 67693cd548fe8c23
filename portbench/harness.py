"""One run of one cell: set-up, the measured window, the readers, the check.

``run_cell`` drives a cell's driver (``drivers/<driver>.py``, named by the
traffic file) through set-up and a window of whole units of work that ends
with the unit during which ``seconds`` elapsed, then reads the cell's
metrics and decides ``correct``. It takes no notice of whether a chip is
present: ``run.py`` checks that before calling it, and the CPU tests call
it directly.
"""

from __future__ import annotations

import dataclasses
import importlib
import math
import subprocess
import sys
import time
import traceback
from pathlib import Path
from typing import Any, Callable, Dict, List, Mapping, Optional

import numpy as np
import torch

from .trace import TraceData, Tracer

HERE = Path(__file__).resolve().parent
#: top-level module names the port may never bring into the process
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


@dataclasses.dataclass
class Verdict:
    """One FLOPs-discriminant verdict the window completed."""

    latency_s: Optional[float]   # instance drawn -> verdict returned (None: not timed alone)
    measurements: int            # Procedure 4's runs: N x the algorithms kept
    build_s: Optional[float]     # instance set-up: workloads built and their single runs
                                 # (None: the program ran no set-up the driver spans)


class Calls:
    """Counts every call made to the workloads a driver wraps, whichever
    part of the program makes it, and their useful FLOPs (frozen formulas);
    in a traced run, marks each as ``pb.call:<i>`` with the least time its
    GEMMs could take."""

    def __init__(self, tracer: Tracer):
        self.tracer = tracer
        self.n = 0
        self.flops = 0.0
        self.bounds: Dict[int, float] = {}

    def reset(self) -> None:
        """Forget what set-up counted: only the window's calls are read."""
        self.n, self.flops = 0, 0.0
        self.bounds.clear()

    def wrap(self, fn: Callable[[], Any], flops: float, bound: Optional[float] = None,
             keep: Optional[Dict[str, Any]] = None, name: str = "") -> Callable[[], Any]:
        def call():
            if self.tracer.on:
                i = self.n
                with torch.profiler.record_function(f"pb.call:{i}"):
                    out = fn()
                if bound is not None:
                    self.bounds[i] = bound
            else:
                out = fn()
            self.n += 1
            self.flops += flops
            if keep is not None:
                keep[name] = out
            return out

        return call


@dataclasses.dataclass
class RunData:
    """What the metric readers read."""

    window_s: float
    verdicts: List[Verdict]
    calls: Calls
    trace: Optional[TraceData]


def load_module(kind: str, name: str):
    """``portbench.<kind>.<name>``: a driver or a metric reader, by name."""
    if not (HERE / kind / f"{name}.py").is_file():
        raise FileNotFoundError(f"no {kind} named {name!r} under {HERE / kind}")
    return importlib.import_module(f"portbench.{kind}.{name}")


def cell_metrics(bench: Mapping, cell: str, group: str) -> List[Mapping]:
    """The metrics of ``group`` (end_to_end or per_layer) that ``cell``
    reports: those without a ``workloads`` key, and those that list it."""
    return [m for m in bench[group] if cell in m.get("workloads", [cell])]


def forbidden_modules() -> List[str]:
    tops = {name.split(".")[0] for name in list(sys.modules)}
    return sorted(tops.intersection(FORBIDDEN))


def run_cell(bench: Mapping, cell: str, config: Mapping, traffic: Mapping, *, seed: int,
             seconds: float, trace: bool, device: torch.device, started: float,
             control: bool = False) -> Dict[str, Any]:
    """Run ``cell`` once and return its result line (as a dict).

    ``started`` is the process's start on the ``time.monotonic`` clock:
    ``setup_s`` runs from it to the window's start. ``control`` judges the
    reference computed in TF32 in the program's place (the control that
    has to come out not correct); the benchmark's own runs never set it.
    """
    torch.backends.cuda.matmul.allow_tf32 = bool(config["tf32"])
    torch.backends.cudnn.allow_tf32 = bool(config["tf32"])
    cuda = device.type == "cuda"
    tracer = Tracer(on=trace, cuda=cuda)
    calls = Calls(tracer)
    driver = load_module("drivers", traffic["driver"]).Driver(
        config, traffic, seed=seed, device=device, tracer=tracer, calls=calls)
    verdicts: List[Verdict] = []
    attempted = failed = 0
    try:
        driver.setup()
        if cuda:
            torch.cuda.synchronize(device)
            torch.cuda.empty_cache()
        calls.reset()
        with tracer.window():  # a traced run starts the profiler before the window opens
            t0 = time.perf_counter()
            setup_s = time.monotonic() - started
            while True:
                attempted += driver.unit_size
                try:
                    verdicts.extend(driver.unit())
                except Exception:  # a unit that raised delivers no verdict: counted, not retried
                    traceback.print_exc(file=sys.stderr)
                    failed += driver.unit_size
                if cuda:
                    # Each graph the program captures keeps a private memory
                    # pool, cached after the graph is dropped; the allocator
                    # cannot release it while a later capture needs memory,
                    # so the caller returns it between units.
                    torch.cuda.empty_cache()
                if time.perf_counter() - t0 >= seconds:
                    break
            window_s = time.perf_counter() - t0
    except BaseException:
        driver.release()
        raise
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    run = RunData(window_s=window_s, verdicts=verdicts, calls=calls, trace=tracer.data)

    metrics: Dict[str, Dict[str, Any]] = {}
    if trace:
        for m in cell_metrics(bench, cell, "per_layer"):
            value = load_module("metrics", m["name"]).read(run)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        latencies = [v.latency_s for v in verdicts if v.latency_s is not None]
        e2e = {"verdicts_per_s": len(verdicts) / window_s, "setup_s": setup_s,
               "verdict_s_p95": float(np.percentile(latencies, 95)) if latencies else None}
        for m in cell_metrics(bench, cell, "end_to_end"):
            if e2e.get(m["name"]) is not None:
                metrics[m["name"]] = {"value": e2e[m["name"]], "unit": m["unit"]}

    dev: Dict[str, Any] = {
        "platform": "gpu" if cuda else device.type,
        "kind": torch.cuda.get_device_name(device) if cuda else device.type,
        "count": 1,
        "memory_peak_bytes": int(peak),
    }
    result: Dict[str, Any] = {"correct": False, "attempted": attempted, "failed": failed,
                              "metrics": metrics, "device": dev}
    if trace:
        dev["busy_s"] = run.trace.busy_s()
        dev["window_s"] = run.trace.window_s
        result["breakdown"] = {"device_ops": run.trace.device_ops(),
                               "idle_gaps": run.trace.idle_gaps()}
    result["window"] = {"seconds": window_s, "verdicts": len(verdicts), "timed_calls": calls.n}
    # set-up's seconds building the program's own kernels (nvcc on a
    # checkout's first run; a cache hit after it): inside setup_s, read apart
    result["kernel_build_s"] = getattr(driver, "kernel_build_s", 0.0)
    if trace and cuda:  # a share of a peak is read beside the card's power limit
        result["power_limit_w"] = power_limit_w(device)

    del run
    tracer.data = None
    driver.release()
    if cuda:
        torch.cuda.empty_cache()
    checks = driver.check(control=control)
    checks["verdicts"] = {"value": len(verdicts), "limit": 1, "at_least": True}
    checks["failed"] = {"value": failed, "limit": 0}
    result["correct"] = all(passes(c) for c in checks.values())
    for c in checks.values():  # a reading that is no number (nothing compared, a NaN) fails as None
        if isinstance(c["value"], float) and not math.isfinite(c["value"]):
            c["value"] = None
    result["checks"] = checks  # last: the numbers compared, each beside its limit
    return result


def power_limit_w(device: torch.device) -> Optional[float]:
    """The card's power limit as ``nvidia-smi`` reads it; None where it cannot."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader,nounits",
                              "-i", str(device.index or 0)], capture_output=True, text=True,
                             timeout=30, check=True).stdout
        return float(out.strip().splitlines()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def passes(check: Mapping[str, Any]) -> bool:
    value, limit = check["value"], check["limit"]
    if value is None or (isinstance(value, float) and math.isnan(value)):
        return False
    return value >= limit if check.get("at_least") else value <= limit


def check_lines(checks: Mapping[str, Mapping[str, Any]]) -> List[str]:
    return [f"check {name}: {c['value']!r} {'>=' if c.get('at_least') else '<='} limit "
            f"{c['limit']!r} {'ok' if passes(c) else 'FAILED'}" for name, c in checks.items()]

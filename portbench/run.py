"""Run one cell of ``BENCHMARK.json`` once and print its result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout. The cell names its configuration and its
traffic in ``BENCHMARK.json``; the configuration's file and
``portbench/traffic/<traffic>.json`` give the sizes and the driver. The
run sets up (builds, loads and warms every kernel the traffic uses), then
measures whole units of work for ``--seconds``, then checks what the timed
path produced against the plain reference. With ``--trace 0`` the last line
of standard output holds the cell's end-to-end metrics, with ``--trace 1``
its per-layer metrics from a profiled window. The numbers compared for
``correct`` close standard error and the result line.

``--control 1`` puts the reference, computed in TF32, in the program's
place in the check: the control, which has to come out not correct. The
limits of ``correct`` are set from runs with and without it, one process a
seed; the benchmark's own runs never set it.

Exits non-zero, printing no result, when no CUDA device is present (or
fewer than the cell asks for), when the program is missing from the
checkout, or when JAX or the JAX package was loaded.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path


def process_started() -> float:
    """The process's start on the ``time.monotonic`` clock (both count from
    boot on Linux); the module's own import time where /proc cannot say."""
    now = time.monotonic()
    try:
        with open("/proc/self/stat") as fh:
            ticks = int(fh.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as fh:
            uptime = float(fh.read().split()[0])
        return now - max(0.0, uptime - ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return now


STARTED = process_started()
ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def load_cell(name: str):
    """(BENCHMARK.json, the cell's entry, its configuration, its traffic),
    each found by the name the one before gives."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = {w["name"]: w for w in bench["workloads"]}[name]
    entry = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    config = json.loads((ROOT / entry["file"]).read_text())
    traffic = json.loads((ROOT / "portbench" / "traffic" / f"{cell['traffic']}.json").read_text())
    return bench, cell, config, traffic


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    try:
        bench, cell, config, traffic = load_cell(args.workload)
    except (OSError, KeyError) as exc:
        print(f"cannot load {args.workload!r}: {exc!r}", file=sys.stderr)
        return 2

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < int(cell["chips"]):
        print(f"{args.workload} needs {cell['chips']} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} present",
              file=sys.stderr)
        return 3
    try:
        import repro_torch
    except ImportError as exc:
        print(f"the program is missing from this checkout: {exc}", file=sys.stderr)
        return 4
    if not Path(repro_torch.__file__).resolve().is_relative_to(ROOT / "src"):
        print(f"repro_torch comes from {repro_torch.__file__}, not this checkout", file=sys.stderr)
        return 4

    from portbench.harness import check_lines, forbidden_modules, run_cell

    result = run_cell(bench, args.workload, config, traffic, seed=args.seed,
                      seconds=args.seconds, trace=bool(args.trace),
                      device=torch.device("cuda", 0), started=STARTED,
                      control=bool(args.control))
    found = forbidden_modules()
    if found:
        print(f"forbidden modules in the process: {', '.join(found)}", file=sys.stderr)
        return 5
    sys.stderr.write("\n".join(check_lines(result["checks"])) + "\n")
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

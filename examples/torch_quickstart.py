"""Quickstart on the PyTorch port: the paper's methodology in ~40 lines.

Ranks the six algorithms of the paper's anomaly instance of X = ABCD into
performance classes with real measurements on ``--device`` (``cuda`` by
default: each algorithm one CUDA graph of ``torch.matmul`` calls; ``cpu`` on
request), then runs the FLOPs-discriminant test.

    PYTHONPATH=src python examples/torch_quickstart.py [--full] [--device cpu]
"""

import argparse

from repro_torch.core import (
    WallClockTimer,
    flops_discriminant_test,
    initial_hypothesis_by_time,
    measure_and_rank,
    relative_flops,
)
from repro_torch.expressions import (
    build_workloads,
    flops_table,
    get_instance,
    make_chain_inputs,
)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--full", action="store_true", help="paper-size matrices")
    ap.add_argument("--instance", default="anomaly_331")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args()

    inst = get_instance(args.instance, smoke=not args.full)
    algs = inst.algorithms()
    print(f"instance {inst.name} dims={inst.dims}: {len(algs)} algorithms")

    mats = make_chain_inputs(inst.dims, device=args.device)
    workloads = build_workloads(algs, mats, warmup=True)
    flops = flops_table(algs)
    rf = relative_flops(flops)

    timer = WallClockTimer(workloads)
    single = {name: timer.measure(name) for name in workloads}
    h0 = initial_hypothesis_by_time(single)
    print("h0 (single-run order):", " ".join(h0))

    result = measure_and_rank(h0, timer, m_per_iteration=3, eps=0.03,
                              max_measurements=30)
    print(f"converged={result.converged} after {result.measurements_per_alg} "
          "measurements/alg")
    for a in result.sequence:
        print(f"  rank {a.rank}  {a.name:12s} ({algs[int(a.name[9:])].label:20s}) "
              f"mean_rank={a.mean_rank:.2f}  RF={rf[a.name]:.2f}")

    report = flops_discriminant_test(result, flops)
    verdict = "ANOMALY: " + report.reason if report.is_anomaly else "valid discriminant"
    print(f"FLOPs test: {verdict}  (S_F = {', '.join(report.min_flops_algs)})")


if __name__ == "__main__":
    main()

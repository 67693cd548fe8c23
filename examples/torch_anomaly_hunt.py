"""Anomaly hunting on the PyTorch port: sweep random chain instances,
classify each with the FLOPs-discriminant test, and report the anomaly
rate — the experiment the paper positions as the input to
performance-model research (Sec. V: "verify that there exists an abundance
of anomalies").

This example is a thin wrapper over the port's stable Python facade
(:func:`repro_torch.api.run_census` — the same operation as
``python -m repro_torch census run``): the hunt is a one-shard census of the
chain family whose state lives under ``--out``, so a killed hunt resumes
exactly where it stopped by re-running the same command — and scaling up
is just switching to the umbrella CLI with more shards and workers.

    PYTHONPATH=src python examples/torch_anomaly_hunt.py --n 12 --lo 32 --hi 256 \
        [--backend wall_clock|cost_model] [--max-steps N] [--out DIR] [--device cpu]

A wall-clock hunt times each algorithm on ``--device`` (``cuda`` by
default, ``cpu`` on request); the cost model and the simulated machine
touch no device.
"""

import argparse
import os
import tempfile

from repro_torch.api import run_census
from repro_torch.core.sweep import ShardStore, SweepSpec, census_summary

MAX_MEASUREMENTS = 24


def build_spec(args: argparse.Namespace) -> SweepSpec:
    """The hunt as a census spec: one shard over the chain family."""
    return SweepSpec(
        name="anomaly_hunt",
        families={
            "chain": {
                "count": args.n,
                "n_matrices": [args.chain],
                "lo": args.lo,
                "hi": args.hi,
            }
        },
        n_shards=1,
        backend=args.backend,
        max_measurements=MAX_MEASUREMENTS,
        policy=args.policy,
        chunk_size=max(args.n, 1),   # one interleaved campaign, like before
        save_every=10,
    )


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=12, help="instances to test")
    ap.add_argument("--lo", type=int, default=32)
    ap.add_argument("--hi", type=int, default=256)
    ap.add_argument("--chain", type=int, default=4, help="matrices per chain")
    ap.add_argument("--backend", default="wall_clock",
                    choices=["wall_clock", "cost_model", "simulated"],
                    help="real PyTorch measurements on --device, or the "
                    "deterministic synthetic machine (bit-identical resume)")
    ap.add_argument("--policy", default="least_converged_first",
                    choices=["round_robin", "least_converged_first"])
    ap.add_argument("--max-steps", type=int, default=None,
                    help="pause the campaign after N engine iterations "
                    "(re-run the same command to resume)")
    ap.add_argument("--out", default=None,
                    help="sweep state directory (default: a fresh tempdir)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu: where a wall-clock hunt measures")
    args = ap.parse_args()

    out = args.out or tempfile.mkdtemp(prefix="anomaly_hunt_")
    if os.path.exists(os.path.join(out, "spec.json")):
        # resuming: the facade takes the grid from disk; warn when this
        # command line's flags disagree with the planned census
        spec = SweepSpec.load(os.path.join(out, "spec.json"))
        if spec.to_dict() != build_spec(args).to_dict():
            print(f"# resuming the census planned in {out}/spec.json: grid "
                  "and backend flags from this command line are ignored "
                  "(use a fresh --out to start a different hunt)")
        spec = run_census(out, max_steps=args.max_steps, device=args.device)
    else:
        spec = run_census(out, build_spec(args), max_steps=args.max_steps,
                          device=args.device)

    records = {r["uid"]: r for r in ShardStore(out, 0).open().records}
    done = 0
    for inst in spec.shard_instances(0):
        rep = records.get(inst.uid)
        if rep is None:
            print(f"{inst.uid}  (pending: re-run to resume the campaign)")
            continue
        done += 1
        tag = f"ANOMALY ({rep['reason']})" if rep["is_anomaly"] else "ok"
        more = "" if rep["converged"] else " (budget hit before convergence)"
        print(f"dims={rep['dims']}  N={rep['measurements_per_alg']:2d} "
              f"classes={rep['classes']}  {tag}{more}")

    grid = spec.families["chain"]
    if done:
        total = census_summary(list(records.values()))["total"]
        print(f"\nanomaly rate: {total['anomalies']}/{total['n']} "
              f"({100.0 * total['rate']:.0f}%) at dims in "
              f"[{grid['lo']}, {grid['hi']}]")
        print("(paper [5] reports ~0.4% at BLAS scale on 10-core MKL; small "
              "sizes on a noisy shared core are far more anomaly-prone)")
    print(f"census state: {out}"
          + (" (re-run with --out to resume)" if done < grid["count"] else ""))


if __name__ == "__main__":
    main()

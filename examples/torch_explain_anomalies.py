"""Explain census anomalies on the PyTorch port: census -> AnomalyExplainer
-> cause table.

The paper stops at detecting anomalies; this example closes the loop. It
runs a small deterministic cost-model census (or reuses one you already
have), explains every anomaly, and prints the per-anomaly verdicts plus
the aggregated cause table — all through the port's stable Python facade
(:func:`repro_torch.api.run_census` / :func:`repro_torch.api.explain_census`,
the same operations as ``python -m repro_torch census run`` /
``python -m repro_torch explain run``). A wall-clock census given with
``--census`` is explained on ``--device`` (``cuda`` by default, ``cpu`` on
request); the demo census touches no device.

    PYTHONPATH=src python examples/torch_explain_anomalies.py
    PYTHONPATH=src python examples/torch_explain_anomalies.py --census /tmp/census
    PYTHONPATH=src python examples/torch_explain_anomalies.py --out /tmp/demo  # resumable

Both phases are killable: re-running the same command resumes the census
and the explanation campaign exactly where they stopped.
"""

import argparse
import os
import tempfile

from repro_torch.api import explain_census, run_census
from repro_torch.core.sweep import SweepSpec, merge_shards
from repro_torch.explain.runner import explain_summary


def build_census(out: str, args: argparse.Namespace) -> str:
    """A one-shard chain+bilinear census with strong injected efficiency
    factors (so the equal-FLOPs regime splits often enough to explain)."""
    root = os.path.join(out, "census")
    if os.path.exists(os.path.join(root, "spec.json")):
        run_census(root, device=args.device)   # resume whatever was planned
        return root
    run_census(
        root,
        SweepSpec(
            name="explain_demo",
            families={
                "chain": {"count": args.n, "n_matrices": [3, 4],
                          "lo": args.lo, "hi": args.hi},
                "bilinear": {"sizes": [32, 64], "per_size": 3},
            },
            n_shards=1,
            backend="cost_model",
            eff_sigma=args.eff_sigma,
            noise_sigma=0.01,
            max_measurements=12,
        ),
        device=args.device,
    )
    return root


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--census", default=None,
                    help="existing sweep --out dir (default: run a demo census)")
    ap.add_argument("--n", type=int, default=16, help="demo census chains")
    ap.add_argument("--lo", type=int, default=24)
    ap.add_argument("--hi", type=int, default=128)
    ap.add_argument("--eff-sigma", type=float, default=0.25,
                    help="injected per-algorithm efficiency spread")
    ap.add_argument("--out", default=None,
                    help="state directory (default: a fresh tempdir)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu: where a wall-clock census is explained")
    args = ap.parse_args()

    out = args.out or tempfile.mkdtemp(prefix="explain_demo_")
    census = args.census or build_census(out, args)
    sweep_spec = SweepSpec.load(os.path.join(census, "spec.json"))
    records = merge_shards(sweep_spec, census)
    anomalies = [r for r in records if r["is_anomaly"]]
    print(f"census: {len(records)} instances, {len(anomalies)} anomalies")
    if not anomalies:
        print("nothing to explain — try a larger --n or --eff-sigma")
        return

    explained = explain_census(
        census, os.path.join(out, "explain"),
        name="explain_demo", n_shards=1, device=args.device,
    )
    for e in explained:
        off = f"  <- {e['offending_kernel']} of {e['offending_algorithm']}" \
            if e["offending_kernel"] else ""
        print(f"{e['uid']:24s} {e['reason']:24s} -> {e['cause']} "
              f"(evidence {e['evidence']:.2f}){off}")

    s = explain_summary(explained)
    print(f"\n{s['total']} anomalies explained, mean evidence "
          f"{s['mean_evidence']:.2f}")
    for cause, a in s["by_cause"].items():
        print(f"  {cause:28s} {a['n']:3d}  ({100.0 * a['share']:.0f}%, "
              f"evidence {a['mean_evidence']:.2f})")
    print(f"state: {out} (re-run with --out to resume)")


if __name__ == "__main__":
    main()

"""Variant autotuning walkthrough on the PyTorch port: the paper's
methodology selecting implementation variants inside the framework.

Runs three variant sites (MoE dispatch, attention implementation, SSD chunk
length; each variant pure PyTorch on ``--device``, ``cuda`` by default) as
ONE interleaved ExperimentEngine campaign via ``rank_sites`` — the
scheduler spends Procedure-4 iterations on whichever site is farthest from
convergence — then prints the full ranking pipeline per site: candidate
filtering, converged performance classes, FLOPs-discriminant verdict,
selection.

    PYTHONPATH=src python examples/torch_rank_algorithms.py \\
        [--policy least_converged_first] [--max-steps N] [--device cpu]

``--max-steps`` demonstrates a budgeted campaign: reports are best-so-far
(check ``converged`` per site) instead of blocking until every site stops.
"""

import argparse

from repro_torch.autotune import (
    attention_site,
    moe_dispatch_site,
    rank_sites,
    ssd_chunk_site,
)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--scale", type=float, default=1.0)
    ap.add_argument("--policy", default="least_converged_first",
                    choices=["round_robin", "least_converged_first"])
    ap.add_argument("--max-steps", type=int, default=None,
                    help="stop the campaign after N engine iterations")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args()
    s, dev = args.scale, args.device

    sites = [
        moe_dispatch_site(tokens=int(2048 * s), d=256, e=16, top_k=2, d_ff=256, device=dev),
        attention_site(b=2, s=int(1024 * s), h=8, kv=2, d=64, device=dev),
        ssd_chunk_site(b=2, s=int(1024 * s), h=8, p=32, n=32, chunks=(64, 128, 256), device=dev),
    ]
    reports = rank_sites(
        sites, max_measurements=18, policy=args.policy, max_steps=args.max_steps
    )
    for site in sites:
        report = reports.get(site.name)
        if report is None:  # never scheduled before the step budget ran out
            print(f"site {site.name}: no iterations yet (raise --max-steps)\n")
            continue
        print(report.summary())
        if report.dropped:
            print(f"  dropped by RT filter: {', '.join(report.dropped)}")
        if not report.ranking.converged:
            print("  (not converged: campaign budget hit; ranks are best-so-far)")
        print()


if __name__ == "__main__":
    main()

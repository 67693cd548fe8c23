"""§Perf iteration driver: run one cell with overrides on the card, compute
baseline AND kernel-adjusted roofline terms, append to the iteration log
(the reference's ``launch/perf.py``).

    python -m repro_torch.launch.perf --arch qwen2-moe-a2.7b --shape train_4k \\
        --label it2_micro8 --override '{"num_microbatches": 8}'

The cell runs as in :mod:`.dryrun`: rank 0's shard of the 16x16 mesh on a
``fake`` process group, one step, counted op by op. Kernel adjustment (the
port's hand flash-attention kernel, ``kernels/flash_attention``):
  * memory: subtract the materialised score-tensor traffic (the kernel
    keeps score tiles in shared memory and registers);
  * compute: subtract half the attention-score FLOPs for causal cells (the
    kernel skips the tiles above the diagonal; the plain path computes the
    rectangle).
Both the plain-path and kernel-path terms are recorded, on the card's
``MachineSpec`` (``h100-sxm-bf16``).

Campaign mode — rank the logged iterations of one (arch, shape) pair with
the paper's methodology over the roofline cost model:

    python -m repro_torch.launch.perf --rank-labels --arch ... --shape ... \\
        [--rel-sigma 0.05] [--max-steps N] [--resume]

Each logged label becomes an algorithm; a CostModelTimer draws from its
kernel-adjusted bounding term. The ExperimentEngine campaign persists to
``reports/torch/perf_campaign_<arch>_<shape>.json``, so a partial run
(--max-steps) resumes bit-identically with --resume. This half touches no
device: from the same logged rows its campaign state is the reference's
byte for byte.
"""

import argparse
import gzip
import json
import os
import time
from typing import Any, Dict, Optional

from ..configs import SHAPES, get_config

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), "../../.."))
LOG = os.path.join(ROOT, "reports", "torch", "perf_iterations.json")


def causal_score_flops(cfg, b: int, s: int, training: bool) -> float:
    """Per-step FLOPs the flash kernel SKIPS vs the full rectangle: the
    strictly-upper causal half of QKᵀ and PV, fwd (+2x bwd when training)."""
    from ..models.config import LayerKind

    hd = cfg.resolved_head_dim
    n_attn = sum(
        spec.kind in (LayerKind.ATTN, LayerKind.ATTN_LOCAL)
        for spec in cfg.pattern_unit()
    ) * cfg.n_units
    rect = 4.0 * b * s * s * cfg.n_heads * hd * n_attn  # QK^T + PV fwd
    skipped = rect / 2.0
    return skipped * (3.0 if training else 1.0)


def run_iteration(
    arch: str,
    shape_name: str,
    label: str,
    overrides: Optional[Dict[str, Any]] = None,
    hypothesis: str = "",
    device: Any = "cuda",
) -> Dict[str, Any]:
    """Run the cell on a 16x16 ``fake`` process group (started and ended
    here) and append its row to :data:`LOG`."""
    import numpy as np

    from ..roofline.counts import analyze, attention_score_traffic
    from ..roofline.terms import H100_SXM_BF16 as machine
    from .compat import destroy_process_group, init_process_group, make_mesh
    from .dryrun import MESHES, model_flops_for, run_cell

    cfg = get_config(arch, smoke=False)
    shape = SHAPES[shape_name]
    sizes, names, label_mesh = MESHES["single"]
    counts_dir = os.path.join(os.path.dirname(LOG), "perf_counts", label)
    t0 = time.time()
    init_process_group("fake", world_size=int(np.prod(sizes)), rank=0)
    try:
        mesh = make_mesh(sizes, names, str(device).split(":")[0])
        row = run_cell(arch, shape_name, mesh, label_mesh, overrides, device=device, counts_dir=counts_dir)
    finally:
        destroy_process_group()
    if not row["status"].startswith("ok"):
        raise RuntimeError(f"{arch}/{shape_name} ended {row['status']}: {row.get('error', '')}")
    with gzip.open(os.path.join(counts_dir, f"{arch}_{shape_name}_{label_mesh}.json.gz"), "rt") as f:
        records = json.load(f)
    counts = analyze(records)
    n_dev = int(np.prod(sizes))

    # --- kernel-adjusted (the hand flash kernel's path) ---
    tp = 16
    sdims = {shape.seq_len, shape.seq_len // tp}
    score_bytes = attention_score_traffic(records, sdims) if shape.kind != "decode" else 0.0
    skip_flops = 0.0
    if shape.kind in ("train", "prefill") and cfg.family != "ssm":
        skip_flops = causal_score_flops(
            cfg, shape.global_batch, shape.seq_len, shape.kind == "train"
        ) / n_dev
    adj_bytes = max(counts.bytes - score_bytes, 0.0)
    adj_flops = max(counts.flops - skip_flops, 0.0)
    t_mem_k = machine.t_memory(adj_bytes)
    t_comp_k = machine.t_compute(adj_flops)
    t_coll = row["t_collective_s"]
    t_bound_k = max(t_comp_k, t_mem_k, t_coll)
    ideal = model_flops_for(cfg, shape) / (n_dev * machine.peak_flops)
    frac_k = ideal / t_bound_k if t_bound_k else 0.0

    row.update({
        "label": label,
        "hypothesis": hypothesis,
        "overrides": overrides or {},
        "kernel_adjusted": {
            "score_bytes_gb": round(score_bytes / 2**30, 2),
            "skipped_flops": f"{skip_flops:.3e}",
            "t_compute_s": round(t_comp_k, 4),
            "t_memory_s": round(t_mem_k, 4),
            "t_collective_s": round(t_coll, 4),
            "dominant": max(
                [("compute", t_comp_k), ("memory", t_mem_k),
                 ("collective", t_coll)], key=lambda kv: kv[1],
            )[0],
            "roofline_fraction": round(frac_k, 4),
        },
        "step_s": round(time.time() - t0, 1),
    })
    log = json.load(open(LOG)) if os.path.exists(LOG) else []
    log.append(row)
    os.makedirs(os.path.dirname(LOG), exist_ok=True)
    with open(LOG, "w") as f:
        json.dump(log, f, indent=1)
    return row


def campaign_path(arch: str, shape: str) -> str:
    safe = f"{arch}_{shape}".replace("/", "_").replace(".", "_")
    return os.path.join(os.path.dirname(LOG), f"perf_campaign_{safe}.json")


def rank_logged_labels(
    arch: str,
    shape: str,
    rel_sigma: float = 0.05,
    max_steps: Optional[int] = None,
    resume: bool = False,
):
    """Rank this (arch, shape)'s logged §Perf iterations as an engine
    campaign over the kernel-adjusted roofline model. Returns the
    TuneReport, or None when fewer than two labels are logged."""
    from ..autotune import CampaignSite, rank_sites
    from ..core import CostModelTimer

    rows = json.load(open(LOG)) if os.path.exists(LOG) else []
    rows = [r for r in rows if r.get("arch") == arch and r.get("shape") == shape]
    state = campaign_path(arch, shape)
    site_name = f"{arch}/{shape}"

    if resume and os.path.exists(state):
        reports = rank_sites(resume_from=state, max_steps=max_steps,
                             save_path=state)
        return reports.get(site_name)

    costs, flops = {}, {}
    for r in rows:
        ka = r.get("kernel_adjusted", {})
        label = r.get("label")
        if not label or not ka:
            continue
        costs[label] = max(
            ka.get("t_compute_s", 0.0), ka.get("t_memory_s", 0.0),
            ka.get("t_collective_s", 0.0),
        )
        flops[label] = float(r.get("hlo_flops_per_dev", "0") or 0)
    if len(costs) < 2:
        return None
    site = CampaignSite(
        name=site_name,
        timer=CostModelTimer(costs, rel_sigma=rel_sigma),
        flops=flops,
        backend="cost-model",
    )
    reports = rank_sites([site], max_steps=max_steps, save_path=state)
    return reports[site_name]


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--arch", required=True)
    p.add_argument("--shape", required=True)
    p.add_argument("--label", default=None)
    p.add_argument("--hypothesis", default="")
    p.add_argument("--override", default=None)
    p.add_argument("--device", default="cuda")
    p.add_argument("--rank-labels", action="store_true",
                   help="rank this (arch, shape)'s logged labels as an "
                        "engine campaign over the roofline cost model")
    p.add_argument("--rel-sigma", type=float, default=0.05)
    p.add_argument("--max-steps", type=int, default=None)
    p.add_argument("--resume", action="store_true",
                   help="resume a persisted --rank-labels campaign")
    args = p.parse_args(argv)

    if args.rank_labels:
        report = rank_logged_labels(
            args.arch, args.shape, rel_sigma=args.rel_sigma,
            max_steps=args.max_steps, resume=args.resume,
        )
        if report is None:
            print(f"need >= 2 logged labels for {args.arch}/{args.shape} in {LOG}")
        else:
            print(report.summary())
            print(f"campaign state: {campaign_path(args.arch, args.shape)}")
        return

    if args.label is None:
        p.error("--label is required unless --rank-labels is given")
    from ..device import resolve_device

    row = run_iteration(
        args.arch, args.shape, args.label,
        overrides=json.loads(args.override) if args.override else None,
        hypothesis=args.hypothesis, device=resolve_device(args.device),
    )
    ka = row["kernel_adjusted"]
    print(f"{args.label}: mem={row['mem_per_dev_gb']}GB "
          f"PLAIN[tc={row['t_compute_s']} tm={row['t_memory_s']} tx={row['t_collective_s']} "
          f"frac={row['roofline_fraction']}] "
          f"KERNEL[tc={ka['t_compute_s']} tm={ka['t_memory_s']} dom={ka['dominant']} "
          f"frac={ka['roofline_fraction']}]")


if __name__ == "__main__":
    main()

"""Multi-pod dry run: build rank 0's shard of every (architecture x
input-shape) cell on the production mesh, run one step of it on the card,
prove memory fits, and extract roofline terms (the reference's
``launch/dryrun.py``, which compiles each cell for 512 placeholder devices).

``main()`` starts a ``fake`` process group of the mesh's world size (256
for 16x16, 512 for 2x16x16): one process plays rank 0, every collective
returns at once and moves no data. Each cell's arguments are rank 0's
shards, drawn at their local shapes on the device (:meth:`CellPlan.build`),
and the step runs on them as DTensors, so the device holds what rank 0 of
the real mesh would: its shards, the weights DTensor gathers at use, the
activations of its own rows. A dry run's *values* are meaningless (fake
collectives hand back unwritten buffers); its shapes, memory and counts are
the result.

Usage (each run writes/updates a JSON report under ``reports/torch/``):

    python -m repro_torch.launch.dryrun --mesh single            # 16x16 = 256
    python -m repro_torch.launch.dryrun --mesh multi             # 2x16x16 = 512
    python -m repro_torch.launch.dryrun --arch granite-8b --shape train_4k
    python -m repro_torch.launch.dryrun --list
    # on the CPU, small: SMOKE configs, a 2x4 mesh, a custom shape
    python -m repro_torch.launch.dryrun --device cpu --smoke --mesh-shape 2x4 \\
        --arch granite-8b --shape train:128:8

Memory is ``torch.cuda.max_memory_allocated`` over the step: the arguments
are the local state's bytes, temp is the rest. Fit loop: if a train cell's
peak exceeds the budget — the card's memory less the reference's 1 GiB
headroom — or the step runs out of memory, the microbatch count is doubled
and the cell rebuilt; every attempt is recorded. The per-device counts of
the step (:mod:`repro_torch.roofline.counts`) are cached next to the report
(``counts/<arch>_<shape>_<mesh>.json.gz``), the counterpart of the
reference's gzipped HLO, so :mod:`.reanalyze` re-derives rows without
running a step again.
"""

from __future__ import annotations

import argparse
import gc
import gzip
import json
import os
import time
import traceback
from typing import Any, Dict, List, Optional, Union

from ..configs import ARCH_NAMES, SHAPES, SKIPS, get_config
from ..configs.shapes import ShapeSpec
from ..models.flops import decode_flops, param_counts, prefill_flops, training_flops

HEADROOM_BYTES = 1 << 30          # the reference's headroom below the card's memory
MAX_FIT_ATTEMPTS = 5
MESHES = {"single": ((16, 16), ("data", "model"), "16x16"),
          "multi": ((2, 16, 16), ("pod", "data", "model"), "2x16x16")}

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), "../../.."))
REPORT_DIR = os.path.join(ROOT, "reports", "torch")


def model_flops_for(cfg, shape: ShapeSpec) -> float:
    if shape.kind == "train":
        return training_flops(cfg, shape.global_batch, shape.seq_len)
    if shape.kind == "prefill":
        return prefill_flops(cfg, shape.global_batch, shape.seq_len)
    return decode_flops(cfg, shape.global_batch, shape.seq_len)


def parse_shape(name: str) -> ShapeSpec:
    """A name of ``SHAPES``, or ``kind:seq_len:global_batch`` (a small
    custom shape for the CPU)."""
    if name in SHAPES:
        return SHAPES[name]
    kind, seq, batch = name.split(":")
    return ShapeSpec(name, int(seq), int(batch), kind)


def mesh_spec(mesh: str, mesh_shape: Optional[str] = None):
    """(sizes, names, label) of ``--mesh`` or of ``--mesh-shape`` (``DxT``
    or ``PxDxT``)."""
    if mesh_shape is None:
        return MESHES[mesh]
    sizes = tuple(int(x) for x in mesh_shape.split("x"))
    names = ("data", "model") if len(sizes) == 2 else ("pod", "data", "model")
    return sizes, names, mesh_shape


def hbm_budget(device: Any) -> Optional[int]:
    """The card's memory less the headroom (None on the CPU)."""
    import torch

    dev = torch.device(device)
    if dev.type != "cuda":
        return None
    return torch.cuda.get_device_properties(dev).total_memory - HEADROOM_BYTES


def _run_step(cell, device) -> Dict[str, Any]:
    """Build the cell's local args on ``device``, run the step once under a
    counting mode; memory in bytes (CUDA) and the op records."""
    import torch

    from ..roofline.counts import CountingMode
    from .compat import implicit_replication

    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.synchronize(device)
        base = torch.cuda.memory_allocated(device)
    fn, args = cell.build(device)
    if cuda:
        torch.cuda.synchronize(device)
        args_bytes = torch.cuda.memory_allocated(device) - base
        torch.cuda.reset_peak_memory_stats(device)
    else:
        args_bytes = _local_bytes(args)
    with implicit_replication(), CountingMode() as mode:
        out = fn(*args)
        if cuda:
            torch.cuda.synchronize(device)
    peak = torch.cuda.max_memory_allocated(device) - base if cuda else None
    del out, args
    return {"args": args_bytes, "peak": peak, "records": [r.to_list() for r in mode.records()]}


def _local_bytes(tree: Any) -> int:
    import torch

    if isinstance(tree, dict):
        return sum(_local_bytes(v) for v in tree.values())
    if isinstance(tree, (tuple, list)):
        return sum(_local_bytes(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        t = tree.to_local() if hasattr(tree, "to_local") else tree
        return t.numel() * t.element_size()
    return 0


def _free(device) -> None:
    import torch

    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


def run_cell(
    arch: str,
    shape: Union[str, ShapeSpec],
    mesh,
    mesh_label: str,
    overrides: Optional[Dict[str, Any]] = None,
    *,
    device: Any = "cuda",
    smoke: bool = False,
    counts_dir: Optional[str] = None,
) -> Dict[str, Any]:
    """Build and run rank 0's shard of one cell; returns the report row (or
    an error row)."""
    import torch

    from ..roofline.counts import analyze
    from ..roofline.terms import H100_SXM_BF16, terms_from_counts
    from .specs import build_cell

    shape = parse_shape(shape) if isinstance(shape, str) else shape
    skip = SKIPS.get((arch, shape.name))
    if skip:
        return {"arch": arch, "shape": shape.name, "mesh": mesh_label,
                "status": "skipped", "reason": skip}

    cfg = get_config(arch, smoke=smoke)
    overrides = dict(overrides or {})
    budget = hbm_budget(device)
    attempts: List[Dict[str, Any]] = []
    t_start = time.time()
    run = None
    for _ in range(MAX_FIT_ATTEMPTS):
        cell = None
        try:
            cell = build_cell(arch, cfg, shape, mesh, opts_override=overrides)
            run = _run_step(cell, device)
            oom = False
        except torch.cuda.OutOfMemoryError:
            run, oom = None, True
        except Exception as e:  # sharding/runtime bug — the thing dry runs catch
            _free(device)
            return {
                "arch": arch, "shape": shape.name, "mesh": mesh_label,
                "status": "error", "error": f"{type(e).__name__}: {e}",
                "trace": traceback.format_exc()[-2000:],
                "attempts": attempts,
            }
        _free(device)
        attempts.append({
            "num_microbatches": cell.num_microbatches,
            "oom": oom,
            "mem_per_dev_gb": None if run is None or run["peak"] is None else round(run["peak"] / 2**30, 3),
            "temp_gb": None if run is None or run["peak"] is None else round((run["peak"] - run["args"]) / 2**30, 3),
        })
        fits = run is not None and (budget is None or run["peak"] <= budget)
        if fits or shape.kind != "train":
            break
        # fit loop: double microbatches (halving live activations), capped
        # at 1 sequence per microbatch
        from ..distributed.sharding import dp_size

        b_local = max(shape.global_batch // dp_size(mesh), 1)
        cur = overrides.get("num_microbatches", cell.num_microbatches)
        nxt = min(max(cur * 2, 2), b_local)
        if nxt == cur:
            break  # already at the floor; report as-is
        overrides["num_microbatches"] = nxt

    if run is None:
        return {"arch": arch, "shape": shape.name, "mesh": mesh_label,
                "status": "oom", "attempts": attempts,
                "hbm_budget_gb": None if budget is None else round(budget / 2**30, 3)}

    if counts_dir is not None:
        os.makedirs(counts_dir, exist_ok=True)
        with gzip.open(os.path.join(counts_dir, f"{arch}_{shape.name}_{mesh_label}.json.gz"), "wt") as f:
            json.dump(run["records"], f)
    mem = run["peak"] if run["peak"] is not None else run["args"]
    terms = terms_from_counts(
        arch=arch, shape=shape.name, mesh_desc=mesh_label, kind=shape.kind,
        n_devices=mesh.size(), counts=analyze(run["records"]),
        model_flops_total=model_flops_for(cfg, shape),
        memory_per_dev_bytes=mem, machine=H100_SXM_BF16,
    )
    row = terms.row()
    pc = param_counts(cfg)
    row.update({
        "status": "ok" if budget is None or mem <= budget else "ok_overbudget",
        "attention_strategy": cell.attention_strategy,
        "num_microbatches": cell.num_microbatches,
        "notes": list(cell.notes),
        "fit_attempts": attempts,
        "args_gb": round(run["args"] / 2**30, 3),
        "temp_gb": None if run["peak"] is None else round((run["peak"] - run["args"]) / 2**30, 3),
        "hbm_budget_gb": None if budget is None else round(budget / 2**30, 3),
        "machine": H100_SXM_BF16.name,
        "device": str(device),
        "step_s": round(time.time() - t_start, 1),
        "params_total": pc.total,
        "params_active": pc.active,
    })
    return row


def main(argv: Optional[List[str]] = None) -> None:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--mesh", choices=sorted(MESHES), default="single")
    p.add_argument("--mesh-shape", default=None, help="DxT or PxDxT instead of --mesh (small meshes)")
    p.add_argument("--arch", default=None, help="one arch (default: all)")
    p.add_argument("--shape", default=None, help="one shape, or kind:seq_len:batch (default: all)")
    p.add_argument("--out", default=None, help="report JSON path")
    p.add_argument("--list", action="store_true")
    p.add_argument("--override", default=None, help="JSON dict of opts overrides (perf experiments)")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--smoke", action="store_true", help="the SMOKE configs (CPU rehearsal)")
    args = p.parse_args(argv)

    if args.list:
        for a in ARCH_NAMES:
            for s in SHAPES:
                skip = SKIPS.get((a, s))
                print(f"{a:26s} {s:12s} {'SKIP: ' + skip if skip else 'run'}")
        return

    import numpy as np

    from ..device import resolve_device
    from .compat import destroy_process_group, init_process_group
    from .compat import make_mesh as compat_make_mesh
    from .mesh import describe

    device = resolve_device(args.device)
    sizes, names, label = mesh_spec(args.mesh, args.mesh_shape)
    init_process_group("fake", world_size=int(np.prod(sizes)), rank=0)
    try:
        mesh = compat_make_mesh(sizes, names, device.type)
        print(f"# dry-run mesh {label}: {describe(mesh)} (rank 0's shard on {device})", flush=True)

        archs = [args.arch] if args.arch else ARCH_NAMES
        shapes = [args.shape] if args.shape else list(SHAPES)
        overrides = json.loads(args.override) if args.override else None
        out_path = args.out or os.path.join(REPORT_DIR, f"dryrun_{label}.json")
        os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
        counts_dir = os.path.join(os.path.dirname(os.path.abspath(out_path)), "counts")
        rows: List[Dict[str, Any]] = []
        if os.path.exists(out_path) and (args.arch or args.shape):
            rows = [r for r in json.load(open(out_path))
                    if not ((args.arch is None or r["arch"] in archs)
                            and (args.shape is None or r["shape"] in shapes))]

        for arch in archs:
            for shape_name in shapes:
                t0 = time.time()
                row = run_cell(arch, shape_name, mesh, label, overrides, device=device,
                               smoke=args.smoke, counts_dir=counts_dir)
                rows.append(row)
                status = row["status"]
                extra = ""
                if status.startswith("ok"):
                    extra = (f"dom={row['dominant']} frac={row['roofline_fraction']}"
                             f" mem={row['mem_per_dev_gb']}GB micro={row['num_microbatches']}"
                             f" attempts={len(row['fit_attempts'])}")
                elif status == "error":
                    extra = row["error"][:120] + "\n" + row["trace"][-1500:]
                elif status == "skipped":
                    extra = row["reason"][:80]
                print(f"[{time.time()-t0:6.1f}s] {arch:26s} {shape_name:12s} "
                      f"{status:8s} {extra}", flush=True)
                with open(out_path, "w") as f:
                    json.dump(rows, f, indent=1)
    finally:
        destroy_process_group()

    n_ok = sum(r["status"].startswith("ok") for r in rows)
    n_skip = sum(r["status"] == "skipped" for r in rows)
    n_err = len(rows) - n_ok - n_skip
    print(f"# done: {n_ok} ok, {n_skip} skipped, {n_err} errors -> {out_path}")
    if n_err:
        raise SystemExit(1)


if __name__ == "__main__":
    main()

#!/usr/bin/env python3
"""Run the PyTorch / H100 port's main path once on the card.

    python3 chip_smoke.py

The path is the paper's method, end to end: take a chain instance at paper
size, enumerate its algorithms, time each on the card (WallClockTimer),
rank them into performance classes (Procedures 1-4) and give the FLOPs
discriminant verdict — once with the algorithms' GEMMs on ``torch.matmul``
and once on the port's hand-written Hopper GEMM — then rank the GEMM's tile
shapes against ``torch.matmul`` through the autotuner's ``rank_site``.

Phases (any failure exits non-zero and prints no result):
1. record the card, toolchain and matmul precision (TF32 off);
2. build the CUDA GEMM from ``src/repro_torch/kernels/matmul/csrc``;
3. hold the kernel against its plain version on the card, every tile;
4. time the kernel, its plain version and ``torch.matmul`` beside the bound;
5. the quickstart path on the four paper instances, on both GEMM routes;
6. the ``matmul_blocks`` site through ``rank_site``.

The launch counter of the GEMM is set to 0 just before each path and read
just after it. The next-to-last line is a JSON object with the kernel's
numbers, the last is ``{"ok": true, "device": {...}}``. Details go to
``chiprun_out/chip_smoke.json``. Imports nothing of JAX or of ``repro``.
"""

import functools
import importlib.util
import itertools
import json
import math
import shutil
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
OUT = ROOT / "chiprun_out" / "chip_smoke.json"

SWEEP_SHAPES = ((256, 256, 256), (300, 200, 450), (64, 512, 128), (128, 128, 1024))
PROPERTY_SHAPES = tuple((17 * i, 23 * j, 13 * k) for i, j, k in itertools.product((1, 2, 3), repeat=3))
TIMED_SHAPES = ((1000, 1000, 1000), (1024, 1024, 1024), (4096, 4096, 4096))
INSTANCES = ("anomaly_331", "fig3_75", "instance_A", "instance_B")
TOL = {"float32": 2e-4, "bfloat16": 2e-2, "chain": 5e-4}


def log(msg=""):
    print(msg, flush=True)


def nvidia_smi():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def peaks(name):
    """Published dense peaks of the H100 SXM (NVIDIA data sheet, 700 W) used
    for the bound: FP32 outside the tensor cores (the hand GEMM's FFMA rate)
    and HBM3. Any other card raises, so a wrong bound is never picked."""
    if "H100" not in name or "HBM3" not in name:
        raise SystemExit(f"chip_smoke: no peak table for {name!r}; the bound is for an H100 SXM")
    return {"sku": "H100 SXM", "f32_flops": 67e12, "bytes_per_s": 3.35e12}


def gemm_bound(m, k, n, in_bytes, out_bytes, peak):
    """Least time (ms) for one GEMM: each input read once, the output written
    once, 2mkn FFMA-rate operations; returns (ms, what bounds it)."""
    t_bytes = ((m * k + k * n) * in_bytes + m * n * out_bytes) / peak["bytes_per_s"]
    t_ops = 2.0 * m * k * n / peak["f32_flops"]
    return max(t_bytes, t_ops) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def cuda_ms(torch, fn, iters):
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def main():
    import torch

    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device; the port's path runs only on the card")
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.autotune import matmul_blocks_site, rank_site
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
        verify_algorithms,
    )
    from repro_torch.kernels.matmul import matmul as kmod
    from repro_torch.kernels.matmul.ops import chain_matmul, matmul
    from repro_torch.kernels.matmul.ref import matmul_ref

    details = {}
    dev = torch.device("cuda")

    # ---------------------------------------------------------- 1. setup --
    card = nvidia_smi()
    name = torch.cuda.get_device_name(0)
    peak = peaks(name)
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    nvcc_version = subprocess.run([nvcc, "--version"], capture_output=True, text=True,
                                  timeout=60, check=True).stdout.strip().splitlines()[-1]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    setup = {
        "card": card, "device_name": name, "device_count": torch.cuda.device_count(),
        "python": sys.version.split()[0], "torch": torch.__version__,
        "torch_cuda": torch.version.cuda, "nvcc": f"{nvcc}: {nvcc_version}",
        "ninja": shutil.which("ninja"), "triton": importlib.util.find_spec("triton") is not None,
        "allow_tf32_matmul": torch.backends.cuda.matmul.allow_tf32,
        "allow_tf32_cudnn": torch.backends.cudnn.allow_tf32,
        "float32_matmul_precision": torch.get_float32_matmul_precision(),
        "peaks": peak,
    }
    details["setup"] = setup
    log("[1 setup] " + json.dumps(setup))

    # ---------------------------------------------------------- 2. build --
    t0 = time.perf_counter()
    lib_path = kmod.build()
    kmod._library()
    build_s = time.perf_counter() - t0
    ptxas = lib_path.with_suffix(".log").read_text() if lib_path.with_suffix(".log").exists() else ""
    used = [ln.split(":", 1)[1].strip() for ln in ptxas.splitlines() if "Used" in ln]
    spills = [ln.strip() for ln in ptxas.splitlines()
              if "spill" in ln and " 0 bytes spill stores, 0 bytes spill loads" not in ln]
    details["build"] = {"seconds": build_s, "library": str(lib_path.relative_to(ROOT)),
                        "ptxas_used": used, "ptxas_spills": spills}
    log(f"[2 build] {lib_path.name} in {build_s:.1f} s; {len(used)} kernels; "
        f"nonzero spill lines: {len(spills)}")
    for line in used:
        log(f"  ptxas: {line}")

    # ---------------------------------------------- 3. kernel vs plain ---
    gen = torch.Generator(device=dev).manual_seed(0)
    failures, errs = [], {"float32": 0.0, "bfloat16": 0.0, "chain": 0.0}
    n_checks = 0

    def fail_on(what):
        if failures:
            for f in failures[:20]:
                log("  FAIL " + f)
            sys.exit(f"chip_smoke: the GEMM kernel disagrees with its plain version ({what})")

    def compare(kind, out, ref, tol, what):
        nonlocal n_checks
        n_checks += 1
        diff = (out.float() - ref.float()).abs()
        err = float(diff.max()) if diff.numel() else 0.0
        errs[kind] = max(errs[kind], err)
        if not bool((diff <= tol + tol * ref.float().abs()).all()):
            failures.append(f"{what}: max_abs_err {err:.3e} > tol {tol}")

    for tile in kmod.SUPPORTED_TILES:
        bm, bn, bk = tile
        shapes = SWEEP_SHAPES + (PROPERTY_SHAPES if tile == (16, 16, 16) else ())
        for (m, k, n), dtype in itertools.product(shapes, (torch.float32, torch.bfloat16)):
            # One operand scaled: |C| is about 1, so the bf16 tolerance is tight.
            a = (torch.randn(m, k, generator=gen, device=dev) / math.sqrt(k)).to(dtype)
            b = torch.randn(k, n, generator=gen, device=dev).to(dtype)
            kind = str(dtype).split(".")[1]
            for out_dtype in (None, torch.bfloat16 if dtype == torch.float32 else torch.float32):
                out = kmod.matmul_kernel(a, b, block_m=bm, block_n=bn, block_k=bk,
                                         out_dtype=out_dtype)
                torch.cuda.synchronize()
                tol = TOL[kind] if out_dtype is None else TOL["bfloat16"]
                compare(kind if out_dtype is None else "bfloat16", out,
                        matmul_ref(a, b, out_dtype), tol,
                        f"tile {tile} {kind}->{out_dtype or kind} {(m, k, n)}")
    for inst_name in INSTANCES:
        inst = get_instance(inst_name, smoke=False)
        algs = inst.algorithms()
        mats = make_chain_inputs(inst.dims)
        verify_algorithms(algs, mats)  # torch.matmul route, the reference's 1e-4
        for alg, tile in itertools.product(algs, kmod.SUPPORTED_TILES):
            out = chain_matmul(alg, mats, block_m=tile[0], block_n=tile[1], block_k=tile[2])
            plain = chain_matmul(alg, mats, use_kernel=False)
            torch.cuda.synchronize()
            compare("chain", out, plain, TOL["chain"], f"chain {inst_name} {alg.name} tile {tile}")
    log(f"[3 kernel vs plain] {n_checks} checks, |kernel - plain| <= tol * (1 + |plain|) "
        f"with tol {TOL}: max_abs_err {errs}, failures {len(failures)}")
    fail_on("phase 3")

    # ------------------------------------------------------------ 4. time --
    timings = []
    for m, k, n in TIMED_SHAPES:
        a = torch.randn(m, k, generator=gen, device=dev) / math.sqrt(k)
        b = torch.randn(k, n, generator=gen, device=dev)
        plain = matmul_ref(a, b)
        for bm, bn, bk in kmod.SUPPORTED_TILES:  # every timed tile, checked at this shape
            compare("float32", kmod.matmul_kernel(a, b, block_m=bm, block_n=bn, block_k=bk),
                    plain, TOL["float32"], f"timed tile {(bm, bn, bk)} {(m, k, n)}")
        fail_on(f"phase 4, {m}x{k}x{n}")
        iters = 10 if m >= 4096 else 50
        bound_ms, bound_by = gemm_bound(m, k, n, 4, 4, peak)
        row = {
            "shape": [m, k, n], "dtype": "float32", "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": cuda_ms(torch, lambda: torch.matmul(a, b), iters),
            "plain_ms": cuda_ms(torch, lambda: matmul_ref(a, b), iters),
            "kernel_ms": {},
        }
        for bm, bn, bk in kmod.SUPPORTED_TILES:
            row["kernel_ms"][f"{bm}x{bn}x{bk}"] = cuda_ms(
                torch, lambda: kmod.matmul_kernel(a, b, block_m=bm, block_n=bn, block_k=bk), iters)
        timings.append(row)
        log(f"[4 time] {m}x{k}x{n} f32: bound {bound_ms:.4f} ms ({bound_by}), "
            f"torch.matmul {row['library_ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, kernel "
            + ", ".join(f"{t} {ms:.4f} ms" for t, ms in row["kernel_ms"].items()))
    details["timings"] = timings

    # ------------------------------------------------- 5. quickstart path --
    default_tile = kmod.DEFAULT_TILE
    hand_gemm = functools.partial(matmul, block_m=default_tile[0], block_n=default_tile[1],
                                  block_k=default_tile[2])
    launches = {}
    quickstart = {}
    for route, gemm in (("torch_matmul", torch.matmul), ("hand_gemm", hand_gemm)):
        kmod.matmul_kernel.launches = 0
        for inst_name in INSTANCES:
            inst = get_instance(inst_name, smoke=False)
            algs = inst.algorithms()
            flops = flops_table(algs)
            rf = relative_flops(flops)
            mats = make_chain_inputs(inst.dims)
            t_start = time.perf_counter()
            timer = WallClockTimer(build_workloads(algs, mats, gemm=gemm))
            single = {a.name: timer.measure(a.name) for a in algs}
            result = measure_and_rank(initial_hypothesis_by_time(single), timer,
                                      m_per_iteration=3, eps=0.03, max_measurements=30)
            report = flops_discriminant_test(result, flops)
            verdict = "ANOMALY: " + report.reason if report.is_anomaly else "valid discriminant"
            labels = {a.name: a.label for a in algs}
            entry = {
                "dims": list(inst.dims), "converged": result.converged,
                "measurements_per_alg": result.measurements_per_alg,
                "ranks": result.ranks, "mean_ranks": result.mean_ranks, "rf": rf,
                "single_run_ms": {k: v * 1e3 for k, v in single.items()},
                "inner_repeats": timer.inner_repeats, "verdict": verdict,
                "min_flops_algs": list(report.min_flops_algs),
                "seconds": time.perf_counter() - t_start,
            }
            quickstart[f"{route}/{inst_name}"] = entry
            log(f"[5 quickstart {route}] {inst_name} dims={inst.dims} converged="
                f"{result.converged} N={result.measurements_per_alg} -> {verdict} "
                f"(S_F = {', '.join(report.min_flops_algs)})")
            for alg in result.sequence:
                log(f"    rank {alg.rank}  {alg.name:11s} {labels[alg.name]:18s} "
                    f"mr={alg.mean_rank:.2f} RF={rf[alg.name]:.2f} "
                    f"t1={single[alg.name] * 1e3:.4f} ms r={timer.inner_repeats[alg.name]}")
        launches[f"quickstart[{route}]"] = kmod.matmul_kernel.launches
        log(f"[5 quickstart {route}] GEMM kernel launches: {kmod.matmul_kernel.launches}")
    details["quickstart"] = quickstart
    if launches["quickstart[hand_gemm]"] == 0:
        sys.exit("chip_smoke: the hand-GEMM quickstart path launched no GEMM kernel")

    # --------------------------------------------------- 6. autotune path --
    site = matmul_blocks_site(1024, 1024, 1024, blocks=kmod.SUPPORTED_TILES)
    a, b = site.make_inputs(0)  # the inputs rank_site times (seed 0)
    plain = matmul_ref(a, b)
    for variant in site.variants:
        compare("float32", variant.build(a, b)(), plain, TOL["float32"],
                f"site {site.name} {variant.name}")
    fail_on("phase 6")
    del a, b, plain
    kmod.matmul_kernel.launches = 0
    report = rank_site(site)
    launches["autotune[matmul_blocks]"] = kmod.matmul_kernel.launches
    log("[6 autotune] " + report.summary().replace("\n", "\n    "))
    log(f"[6 autotune] GEMM kernel launches: {launches['autotune[matmul_blocks]']}")
    details["autotune"] = {
        "site": report.site, "ranks": report.ranking.ranks,
        "mean_ranks": report.ranking.mean_ranks, "selected": report.selected,
        "single_run_ms": {k: v * 1e3 for k, v in report.single_run_times.items()},
        "dropped": list(report.dropped),
        "verdict": report.discriminant.reason if report.discriminant.is_anomaly else "valid",
    }
    if launches["autotune[matmul_blocks]"] == 0:
        sys.exit("chip_smoke: the autotune path launched no GEMM kernel")
    details["launches"] = launches
    details["correctness"] = {"checks": n_checks, "max_abs_err": errs, "tolerance": TOL}
    log(f"[checks] {n_checks} kernel-vs-plain checks in phases 3, 4 and 6: max_abs_err {errs}")

    # ---------------------------------------------------------- results --
    main_row = timings[0]  # 1000^3, the chain GEMMs of instance_B
    tile_key = "x".join(map(str, default_tile))
    kernel = {
        "name": "gemm",
        "route": "cuda",
        "source": "src/repro_torch/kernels/matmul/csrc/gemm.cu",
        "replaces": "src/repro/kernels/matmul/matmul.py:45",
        "launches": launches["quickstart[hand_gemm]"] + launches["autotune[matmul_blocks]"],
        "max_abs_err": max(errs.values()),
        "ms": main_row["kernel_ms"][tile_key],
        "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"],
        "bound_by": main_row["bound_by"],
        "library_ms": main_row["library_ms"],
        "tolerance": TOL, "shape": main_row["shape"], "tile": list(default_tile),
        "launches_by_path": launches,
    }
    details["kernels"] = [kernel]
    OUT.parent.mkdir(parents=True, exist_ok=True)
    OUT.write_text(json.dumps(details, indent=1))
    log(card)
    log(json.dumps({"kernels": [kernel]}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                           "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()

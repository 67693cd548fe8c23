#!/usr/bin/env python3
"""Run the PyTorch / H100 port's paths once on the card.

    python3 chip_smoke.py

The main path is the paper's method, end to end: take a chain instance at
paper size, enumerate its algorithms, time each on the card
(WallClockTimer), rank them into performance classes (Procedures 1-4) and
give the FLOPs discriminant verdict — once with the algorithms' GEMMs on
``torch.matmul`` and once on the port's hand-written Hopper GEMM — then rank
the GEMM's tile shapes against ``torch.matmul`` through the autotuner's
``rank_site``. The attention and SSD paths run the kernels' entry points
(``flash_attention``, ``ssd_mix``) at the full width of qwen3-14b,
gemma2-27b and mamba2-1.3b, and rank the ``attention_impl`` and
``ssd_chunk`` sites.

Phases (any failure exits non-zero and prints no result):
1. record the card, toolchain and matmul precision (TF32 off);
2. build the CUDA GEMM from ``src/repro_torch/kernels/matmul/csrc`` (the
   flash-attention, SSD, mma.sync-rate and planted-fault builds start
   beside it), with the SASS check: every GEMM instantiation holds HMMA
   (mma.sync) and LDGSTS (cp.async), touches no local memory and spills
   nothing;
3. hold the kernel against its plain version on the card, every tile, dtype
   pair and both copy widths; the f32 comparison's power: builds of the
   GEMM with planted faults must fail it at 1000^3; a NaN made on the card
   in A must give the plain version's NaN positions at every tile;
4. the card's mma.sync rate; time the kernel (f32 and bf16), its plain
   version and ``torch.matmul`` beside the bounds (3xTF32 and FFMA for f32);
   the cost of the TF32 split's NaN guard (a build without it, in turns);
   the wrapper's host cost per launch against ``torch.matmul``'s;
5. the quickstart path on the four paper instances, on both GEMM routes;
6. the ``matmul_blocks`` site through ``rank_site``;
7. the flash-attention and SSD builds, with ``ptxas -v``'s report of every
   instantiation and the SASS check: every bf16 flash instantiation holds
   HGMMA (wgmma) and UTMALDG (TMA) and spills nothing; every f32 one holds
   HMMA (mma.sync) and LDGSTS (cp.async), touches no local memory and
   spills nothing;
8. flash attention: kernel against ``flash_attention_plain`` (f32, bf16)
   on the reference's sweep, its two traps, a decode case and an f32 case
   with a NaN made on the card in q; the ``flash_attention`` path with GQA
   and at full width; the full-width comparisons' power (bf16 and f32):
   builds of the kernel with planted faults must fail them; timing beside
   the bound (3xTF32 and FFMA for f32; with TFLOP/s and the share of it),
   the plain version and ``scaled_dot_product_attention`` (the
   dispatcher's backend, the flash backend as a second yardstick, and for
   f32 the memory-efficient backend on K/V repeated to the query heads);
9. SSD: the SASS check (every instantiation that carries a product holds
   HMMA, none touches local memory or spills); kernel against
   ``ssd_scan_ref`` on the reference's sweep and groups cases, the overflow
   case, a ragged chunk at the SMOKE widths, several heads a group over
   many chunks and a NaN made on the card in C; the ``ssd_mix`` path at
   mamba2-1.3b's width; the power of that comparison (builds with planted
   faults must fail it); timing of the scan and of each of its passes
   (queued behind a device sleep, so that the host's enqueue cost stays
   out) beside the FFMA, 3xTF32 and byte bounds, and the NaN guard's cost;
10. the ``attention_impl`` and ``ssd_chunk`` sites, each variant first held
   against ``attention_reference`` / ``ssd_reference``, through ``rank_site``.

Each kernel's launch counter is set to 0 just before each path and read just
after it. The next-to-last line is a JSON object with the kernels' numbers,
the last is ``{"ok": true, "device": {...}}``. Details go to
``chiprun_out/chip_smoke.json``. Imports nothing of JAX or of ``repro``.
"""

import concurrent.futures
import functools
import importlib.util
import itertools
import json
import math
import re
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
OUT = ROOT / "chiprun_out" / "chip_smoke.json"

SWEEP_SHAPES = ((256, 256, 256), (300, 200, 450), (64, 512, 128), (128, 128, 1024))
PROPERTY_SHAPES = tuple((17 * i, 23 * j, 13 * k) for i, j, k in itertools.product((1, 2, 3), repeat=3))
TIMED_SHAPES = ((1000, 1000, 1000), (1024, 1024, 1024), (4096, 4096, 4096))
BF16_TIMED_SHAPES = ((1000, 1000, 1000), (4096, 4096, 4096))
HOST_LAUNCHES = 1000  # launches of a 64^3 GEMM timed on the host clock (phase 4)
INSTANCES = ("anomaly_331", "fig3_75", "instance_A", "instance_B")
TOL = {"float32": 2e-4, "bfloat16": 2e-2, "chain": 5e-4}

# Planted faults in the GEMM that the 1000^3 f32 comparison at the 64^3 tile
# must reject (phase 3): name, the text of csrc/gemm.cu (it must occur there
# exactly once) and its replacement.
GEMM_FAULTS = (
    ("lo forced to 0 (1xTF32)", "  lo = round_tf32(x - __uint_as_float(hi));\n", "  lo = 0u;\n"),
    ("cross term a_hi*b_lo dropped", "        mma_tf32(d, ahi, blo[j]);\n",
     "        // a_hi*b_lo dropped\n"),
    ("last K stage skipped", "  for (int kt = 0; kt < k_tiles; ++kt) {",
     "  for (int kt = 0; kt < k_tiles - 1; ++kt) {"),
)

# Flash attention: the reference's tolerances (tests/test_kernels.py).
FLASH_TOL = {"float32": 2e-3, "bfloat16": 3e-2}
# bh, sq, skv, d, causal, window, logit_cap, block_q, block_k
FLASH_CASES = (
    ("sweep", 2, 256, 256, 64, True, None, None, 128, 128),
    ("sweep", 1, 128, 128, 128, False, None, None, 64, 128),
    ("sweep", 2, 128, 512, 64, True, None, None, 64, 128),
    ("sweep", 1, 256, 256, 64, True, 64, None, 64, 64),
    ("sweep", 1, 256, 256, 64, True, None, 50.0, 128, 64),
    ("trap: causal, sq > skv", 1, 128, 64, 32, True, None, None, 64, 64),
    ("trap: window, not causal", 1, 64, 128, 32, False, 32, None, 64, 64),
    ("decode", 8, 1, 4096, 128, True, None, None, 128, 512),
)
# The ops path draws q at 4x the unit scale: the scores q.k / sqrt(d) then
# have a standard deviation of 4, the softmax is peaked and |o| is a good
# share of |v|. At unit scale a row spreads over about i / e keys and a
# typical |o| at s = 4096 is about 0.03, no larger than the bf16 tolerance.
# A power of two, so q / 4 is exactly the unit-scale draw.
FLASH_Q_SCALE = 4.0
# Planted faults in the bf16 kernel (flash_bf16_kernel) that the full-width
# bf16 comparison must reject: name, the text of csrc/flash_attention.cu (it
# must occur there exactly once) and its replacement (None: the fault is made
# on the kernel's output), and whether the comparison must reject it. The
# tile faults change which tiles a consumer computes, never which it waits
# on, so a fault cannot deadlock. l summed from the bf16-rounded p moves l by
# at most 2^-9 of itself, below the bf16 tolerance by design: it is
# recorded, not required.
FLASH_FAULTS = (
    ("last live kv tile skipped", "const int live_end = wr.end;",
     "const int live_end = wr.end - 1;", True),
    ("first live kv tile skipped from query row 2048 on", "const int live_begin = wr.begin;",
     "const int live_begin = wr.begin + (wrow0 >= 2048 ? 1 : 0);", True),
    ("rows from 512 on written as 0", None, None, True),
    ("O not rescaled by alpha", "o_acc[j] *= alpha[(j >> 1) & 1];", "o_acc[j] *= 1.f;", True),
    ("l summed from the bf16-rounded p", "l[r] += p0 + p1;",
     "l[r] += __bfloat162float(__float2bfloat16(p0)) + __bfloat162float(__float2bfloat16(p1));",
     False),
)
# Planted faults in the f32 kernel (flash_f32_kernel) that the full-width f32
# comparison at qwen3-14b must reject: name, the text of
# csrc/flash_attention.cu (it must occur there exactly once), its
# replacement, and whether the comparison must reject it. A CPU emulation of
# causal attention at d 128 with q at 4x puts P V at 1xTF32 near 0.3-0.5 of
# the f32 tolerance: recorded, not required (both products stay 3xTF32).
FLASH_F32_FAULTS = (
    ("Q K^T at 1xTF32", "        mma_tf32(s[n], qlo, khi);\n        mma_tf32(s[n], qhi, klo);\n", "", True),
    ("last live kv tile skipped", "const int warp_end = own.end;", "const int warp_end = own.end - 1;", True),
    ("O not rescaled by alpha", "o_acc[j][e] *= alpha[e >> 1];", "o_acc[j][e] *= 1.f;", True),
    ("P V at 1xTF32", "        mma_tf32(d, plo[n], vhi);\n        mma_tf32(d, phi[n], vlo);\n", "", False),
)
# The NaN guard of the 3xTF32 split in gemm.cu and ssd.cu (to_tf32): the
# text that builds without it delete (one occurrence in each). Phases 3 and 9
# time both builds in turns and show what the guard changes for a NaN made on
# the card.
TF32_GUARD = "  if (!(fabsf(x) < __uint_as_float(0x7f800000u))) return bits;  // inf or NaN\n"
# The ops path: name, (b, s, h, kv, d), keyword arguments.
FLASH_PATH = (
    ("gqa", (2, 128, 4, 2, 32), dict(block_q=64, block_k=64)),
    ("qwen3-14b", (1, 4096, 40, 8, 128), {}),
    ("gemma2-27b", (1, 8192, 32, 16, 128), dict(window=4096, logit_cap=50.0)),
)
# SSD: the reference's f32 tolerance; b, s, h, p, n, g, chunk, a_shift,
# dt_shift (a_log = N(0, 0.5^2) + a_shift, dt = softplus(N(0, 1) + dt_shift)).
SSD_TOL = 3e-4
SSD_CASES = (
    ("sweep", 2, 128, 4, 32, 16, 1, 32, 0.0, 0.0),
    ("sweep", 2, 128, 4, 32, 16, 1, 64, 0.0, 0.0),
    ("sweep", 2, 128, 4, 32, 16, 1, 128, 0.0, 0.0),
    ("groups", 1, 64, 4, 16, 8, 2, 32, 0.0, 0.0),
    # |A| dt about 20 a token: exp(cum_i - cum_j) above the diagonal overflows
    ("overflow above the diagonal", 1, 128, 2, 16, 8, 1, 128, 2.0, 2.0),
    ("ragged chunk, SMOKE widths", 1, 64, 8, 16, 16, 1, 8, 0.0, 0.0),
    ("4 heads a group, 4 chunks", 1, 1024, 8, 64, 64, 2, 256, 0.0, 0.0),
)
MAMBA2 = (2, 4096, 64, 64, 128, 1, 256)  # mamba2-1.3b: b, s, h, p, n, g, chunk
SSD_TILE, SSD_KT = 64, 64  # csrc/ssd.cu's kTile and kKT (a CPU test holds them equal)
# Planted faults in the SSD kernel that the mamba2-1.3b comparison must
# reject: name, the text of csrc/ssd.cu (it must occur there exactly once),
# its replacement, and whether the comparison must reject it. An f32 cum
# lands near the tolerance by design (the reason cum is f64): recorded, not
# required.
SSD_FAULTS = (
    ("lo forced to 0 (1xTF32)", "  lo = round_tf32(x - __uint_as_float(hi));\n", "  lo = 0u;\n", True),
    ("state passing without its chunk decay",
     "    const float decay = expf(static_cast<float>(cum_end[static_cast<int64_t>(c) * p.chunk]));\n",
     "    const float decay = 1.f;\n", True),
    ("chunk scan reads the state after its own chunk",
     "  const float* state_before = states + slot(p, bi, c, hi) * P * p.ns;\n",
     "  const float* state_before = states + slot(p, bi, c + 1, hi) * P * p.ns;\n", True),
    ("diagonal left out of L (i > j)", "      return j <= i ? sa[", "      return j < i ? sa[", True),
    ("cum in f32", "  using Cum = double;\n", "  using Cum = float;\n", False),
)


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
    for the bounds: FP32 outside the tensor cores (FFMA), TF32 and bf16 on
    them, and HBM3. Any other card raises, so a wrong bound is never picked."""
    if "H100" not in name or "HBM3" not in name:
        raise SystemExit(f"chip_smoke: no peak table for {name!r}; the bound is for an H100 SXM")
    return {"sku": "H100 SXM", "f32_flops": 67e12, "tf32_flops": 494.7e12, "bf16_flops": 989e12,
            "bytes_per_s": 3.35e12}


def gemm_bound(m, k, n, in_bytes, out_bytes, flops_per_s, peak, products=1):
    """Least time (ms) for one GEMM: each input read once, the output written
    once, ``products`` x 2mkn operations at ``flops_per_s`` (3 TF32 products
    for an f32 GEMM on the tensor cores); returns (ms, what bounds it)."""
    nbytes = (m * k + k * n) * in_bytes + m * n * out_bytes
    return bound(products * 2.0 * m * k * n, nbytes, flops_per_s, peak)


def bound(flops, nbytes, flops_per_s, peak):
    """Least time (ms) for ``flops`` at ``flops_per_s`` and ``nbytes`` at the
    memory rate; returns (ms, what bounds it)."""
    t_ops, t_bytes = flops / flops_per_s, nbytes / peak["bytes_per_s"]
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def live_pairs(sq, skv, causal, window):
    """(query, key) pairs the flash kernel must compute: the kernel's mask,
    q_offset = skv - sq only when causal."""
    pos = np.arange(sq, dtype=np.int64) + (skv - sq if causal else 0)
    hi = np.minimum(pos, skv - 1) if causal else np.full(sq, skv - 1)
    lo = np.maximum(pos - window + 1, 0) if window is not None else np.zeros(sq, np.int64)
    return int(np.clip(hi - lo + 1, 0, None).sum())


def kernel_name(mangled):
    """A kernel instantiation's short name from its mangled one:
    '_ZN51_GLOBAL__N__<hash>_18_flash_attention_cu_<hash>17flash_bf16_kernelILi128EEEv...'
    -> 'flash_bf16_kernel<Li128E>'. An Itanium name is a run of
    length-prefixed names; the one followed by template arguments ('I') is
    the kernel. Anything else comes back as it is."""
    head = re.match(r"_ZN?", mangled)
    pos = head.end() if head else len(mangled)
    while (length := re.match(r"\d+", mangled[pos:])) is not None:
        start = pos + length.end()
        pos = start + int(length.group())
        if mangled.startswith("I", pos):
            args = re.match(r"I(\w*?)EEv", mangled[pos:])
            return f"{mangled[start:pos]}<{args.group(1) if args else '?'}>"
    return mangled


def ptxas_report(lib_path):
    """``ptxas -v``'s register lines and its nonzero spill lines, each
    tagged with the kernel instantiation it belongs to."""
    log_path = lib_path.with_suffix(".log")
    used, spills, entry = [], [], "?"
    for ln in (log_path.read_text() if log_path.exists() else "").splitlines():
        if "Compiling entry function" in ln:
            entry = kernel_name(ln.split("'")[1] if "'" in ln else ln.strip())
        elif "Used" in ln:
            used.append(f"{entry}: {ln.split(':', 1)[1].strip()}")
        elif "spill" in ln and " 0 bytes spill stores, 0 bytes spill loads" not in ln:
            spills.append(f"{entry}: {ln.strip()}")
    return used, spills


SASS_OPS = ("HGMMA", "UTMALDG", "HMMA", "LDGSTS", "LDL", "STL")


def sass_report(lib_path):
    """``cuobjdump -sass`` of a library: for each kernel instantiation, the
    number of HGMMA (wgmma), UTMALDG (TMA load), HMMA (mma.sync), LDGSTS
    (cp.async) and LDL/STL (local memory: spills) instructions."""
    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    text = subprocess.run([cuobjdump, "-sass", str(lib_path)], capture_output=True, text=True,
                          timeout=300, check=True).stdout
    counts = {}
    for chunk in re.split(r"\n\s*Function : ", text)[1:]:
        name = kernel_name(chunk.split("\n", 1)[0].strip())
        counts[name] = {op: len(re.findall(rf"\b{op}\b", chunk)) for op in SASS_OPS}
    return counts


def cuda_ms(torch, fn, iters, warmup=3):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(torch, fn, iters, warmup=3):
    """CUDA-event time per launch of ``fn`` with the launches queued behind
    ``torch.cuda._sleep``, so that the host's enqueue cost (tens of us a
    launch through ctypes) stays out of the window and a short kernel reads
    its device time."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(2_000_000)  # about 1 ms at the card's clock: the host gets ahead
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


class Checks:
    """``|out - ref| <= tol * (1 + |ref|)`` on every element (NaN fails).
    Kept per key: the largest ``|out - ref|`` (``errs``) and the largest
    share of the tolerance used, ``|out - ref| / (tol * (1 + |ref|))``
    (``used``, at most 1 when every check passes); failures end the run."""

    def __init__(self, torch, what):
        self.torch, self.what = torch, what
        self.n, self.errs, self.used, self.failures = 0, {}, {}, []

    def hold(self, key, out, ref, tol, what):
        self.n += 1
        diff = (out.float() - ref.float()).abs()
        allowed = tol + tol * ref.float().abs()
        err = float(diff.max()) if diff.numel() else 0.0
        used = float((diff / allowed).max()) if diff.numel() else 0.0
        self.errs[key] = max(self.errs.get(key, 0.0), err)
        self.used[key] = max(self.used.get(key, 0.0), used)
        if not bool((diff <= allowed).all()):
            self.failures.append(f"{what}: max_abs_err {err:.3e} > tol {tol}")

    def hold_nans(self, key, out, ref, tol, what):
        """A case with a NaN in its inputs: the kernel's NaNs must lie exactly
        where the plain version's do, and every other element must agree as
        ``hold`` asks."""
        torch = self.torch
        if not torch.equal(out.isnan(), ref.isnan()):
            self.n += 1
            self.failures.append(f"{what}: NaN at {int(out.isnan().sum())} elements, the plain version "
                                 f"at {int(ref.isnan().sum())}, positions differ")
            return
        keep = ~ref.isnan()
        self.hold(key, out[keep], ref[keep], tol, what)

    def stop_if_failed(self, phase):
        if self.failures:
            for f in self.failures[:20]:
                log("  FAIL " + f)
            sys.exit(f"chip_smoke: {self.what} disagrees with its plain version ({phase})")


def build_fault(mod, build_library, tmp, index, old, new):
    """Build a kernel module's ``SOURCE`` with ``old`` replaced by ``new``
    into ``tmp`` (outside the checkout) and return the library's path."""
    src = mod.SOURCE.read_text()
    if src.count(old) != 1:
        raise SystemExit(f"chip_smoke: planted fault text {old!r} not found once in {mod.SOURCE}")
    path = Path(tmp) / f"{mod.SOURCE.stem}_fault{index}.cu"
    path.write_text(src.replace(old, new))
    return build_library(path, Path(tmp))


def counts_of(wrapper):
    """A copy of a kernel wrapper's launch counters (its attributes)."""
    return {k_: dict(v) if isinstance(v, dict) else v for k_, v in vars(wrapper).items()}


def run_with(mod, wrapper, lib, fn):
    """``fn()`` with ``mod``'s kernel bound to the loaded library ``lib``
    (a planted fault, a build without the NaN guard); the wrapper's launch
    counters are restored afterwards, since these launches are no path's."""
    real, saved = mod._library, counts_of(wrapper)
    mod._library = lambda: lib
    try:
        return fn()
    finally:
        mod._library = real
        vars(wrapper).update(saved)


def in_turns(torch, mod, wrapper, lib, call, iters):
    """CUDA-event ms of ``call()`` with ``mod``'s own library and with
    ``lib``, in turns (own, other, other, own), on the same inputs; no
    launch is counted."""
    saved = counts_of(wrapper)
    ms = {"own": [], "other": []}
    for which in ("own", "other", "other", "own"):
        if which == "own":
            ms[which].append(cuda_ms(torch, call, iters))
        else:
            ms[which].append(run_with(mod, wrapper, lib, lambda: cuda_ms(torch, call, iters)))
    torch.cuda.synchronize()
    vars(wrapper).update(saved)
    return ms


def device_nan(torch, dev):
    """A NaN made on the card (0 / 0) and its bit pattern: CUDA's division
    returns the canonical 0x7fffffff, whose top mantissa bits are all set,
    unlike torch's host-made ``nan`` (0x7fc00000)."""
    nan = torch.zeros((), device=dev) / 0
    return nan, f"0x{int(nan.view(torch.int32).item()) & 0xFFFFFFFF:08x}"


def flash_power(torch, fmod, faults, fault_libs, key, entry, plain, q, k, v):
    """The power of a full-width comparison in dtype ``key``: the share of
    its tolerance, max |out - plain| / (tol * (1 + |plain|)), that the kernel
    and each planted fault of ``faults`` use, on the path's q and on q at
    unit scale. Returns the shares and the required faults that the path's
    comparison did not reject. The faults' launches are not counted."""
    tol = FLASH_TOL[key]

    def share(out, ref):
        return float(((out.float() - ref.float()).abs() / (tol * (1 + ref.float().abs()))).max())

    wrapper = fmod.flash_attention_kernel
    saved = counts_of(wrapper)
    shares = {}
    for label, qs in (("path", q), ("unit scale", (q.float() / FLASH_Q_SCALE).to(q.dtype))):
        ref = plain(qs, k, v)
        out = entry(qs, k, v)
        row = {"kernel": share(out, ref)}
        for name, old, _, _ in faults:
            if old is None:
                bad = out.clone()
                bad[:, 512:] = 0
            else:
                bad = run_with(fmod, wrapper, fmod.bind(fault_libs[name]), lambda: entry(qs, k, v))
            row[name] = share(bad, ref)
        shares[label] = row
    torch.cuda.synchronize()
    vars(wrapper).update(saved)
    missed = [name for name, _, _, must in faults if must and shares["path"][name] <= 1.0]
    return shares, missed


def reset_gemm_counts(kmod):
    kmod.matmul_kernel.launches = 0
    kmod.matmul_kernel.launches_by_copy = {w: 0 for w in kmod.COPY_WIDTHS}


def gemm_sass_check(kmod, lib_path, spills):
    """Phase 2's SASS check: every GEMM instantiation (each tile, dtype pair
    and copy width) runs its products on HMMA (mma.sync), loads by LDGSTS
    (cp.async) and touches no local memory; ptxas reports no spill."""
    sass = sass_report(lib_path)
    gemm = {k_: c for k_, c in sass.items() if k_.startswith("gemm_kernel")}
    want = len(kmod.SUPPORTED_TILES) * 4 * len(kmod.COPY_WIDTHS)
    bad = [k_ for k_, c in gemm.items() if not (c["HMMA"] and c["LDGSTS"]) or c["LDL"] or c["STL"]]
    span = {op: sorted(c[op] for c in gemm.values()) or [0] for op in ("HMMA", "LDGSTS")}
    log(f"[2 sass] gemm: {len(gemm)} instantiations (want {want}); "
        + ", ".join(f"{op} {v[0]}-{v[-1]}" for op, v in span.items())
        + f", LDL/STL {sum(c['LDL'] + c['STL'] for c in gemm.values())}")
    if len(gemm) != want or bad:
        sys.exit(f"chip_smoke: GEMM instantiations without HMMA and LDGSTS, or with local memory: "
                 f"{bad} ({len(gemm)} of {want} found)")
    if spills:
        sys.exit(f"chip_smoke: GEMM instantiations spill: {spills}")
    return gemm


def gemm_power(torch, kmod, fault_libs, a, b, ref):
    """The power of the 1000^3 f32 comparison at the 64^3 tile: the share of
    its tolerance that the kernel and each planted fault use. Returns the
    shares and the faults it did not reject. The faults' launches are not
    counted."""
    tol = TOL["float32"]

    def share():
        out = kmod.matmul_kernel(a, b, block_m=64, block_n=64, block_k=64)
        return float(((out - ref).abs() / (tol * (1 + ref.abs()))).max())

    saved = counts_of(kmod.matmul_kernel)
    shares = {"kernel": share()}
    for name, _, _ in GEMM_FAULTS:
        shares[name] = run_with(kmod, kmod.matmul_kernel, kmod.bind(fault_libs[name]), share)
    torch.cuda.synchronize()
    vars(kmod.matmul_kernel).update(saved)
    return shares, [name for name, _, _ in GEMM_FAULTS if shares[name] <= 1.0]


def mma_rates(torch, lib_path):
    """The rate of mma.sync on the card (``csrc/mma_peak.cu``): TFLOP/s of
    m16n8k8 TF32 and m16n8k16 bf16, registers only, 4 blocks of 256 threads
    an SM. The ceiling of the GEMM's products."""
    import ctypes

    lib = ctypes.CDLL(str(lib_path))
    lib.repro_mma_peak.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p] * 2
    lib.repro_mma_peak.restype = ctypes.c_int
    out = torch.zeros(256, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    blocks, threads, iters = 4 * torch.cuda.get_device_properties(0).multi_processor_count, 256, 4096
    rates = {}
    for label, tf32, depth in (("tf32", 1, 8), ("bf16", 0, 16)):
        def call():
            if lib.repro_mma_peak(tf32, blocks, threads, iters, out.data_ptr(), stream) != 0:
                raise RuntimeError("mma_peak launch failed")
        ms = cuda_ms(torch, call, 3, warmup=1)
        flops = blocks * threads / 32 * iters * 16 * 2 * 16 * 8 * depth
        rates[label] = flops / (ms * 1e-3)
    return rates


def host_cost(torch, kmod, dev):
    """Host clock around ``HOST_LAUNCHES`` launches with one synchronize, us
    per launch: the wrapper on a 64^3 GEMM at the 64^3 tile, its parts
    (the output's allocation, the ctypes call with fixed arguments) and
    ``torch.matmul`` on the same inputs."""
    a = torch.randn(64, 64, device=dev)
    b = torch.randn(64, 64, device=dev)
    c = torch.empty(64, 64, device=dev)
    lib = kmod._library()
    args = (64, 64, 64, 0, 0, kmod.copy_bytes(a, b, c), a.data_ptr(), b.data_ptr(), c.data_ptr(),
            64, 64, 64, 64, 64, 64, torch.cuda.current_stream().cuda_stream)
    launches = (kmod.matmul_kernel.launches, dict(kmod.matmul_kernel.launches_by_copy))

    def per_launch(fn):
        for _ in range(20):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(HOST_LAUNCHES):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / HOST_LAUNCHES * 1e6

    out = {
        "matmul_kernel": per_launch(lambda: kmod.matmul_kernel(a, b)),
        "torch.empty [64, 64]": per_launch(lambda: torch.empty((64, 64), device=dev)),
        "repro_gemm through ctypes": per_launch(lambda: lib.repro_gemm(*args)),
        "torch.matmul": per_launch(lambda: torch.matmul(a, b)),
    }
    kmod.matmul_kernel.launches, kmod.matmul_kernel.launches_by_copy = launches
    return out


def sdpa_call(torch, q, k, v):
    """One ``scaled_dot_product_attention`` call on the model layout (causal,
    GQA) and the backend PyTorch's dispatcher picks for it; the yardstick
    only, the port never calls it."""
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    backend = "not recorded"
    if hasattr(torch, "_fused_sdp_choice"):
        choice = torch._fused_sdp_choice(qt, kt, vt, None, 0.0, True, enable_gqa=True)
        names = {m.value: n for n, m in torch.nn.attention.SDPBackend.__members__.items()}
        backend = names.get(choice, str(choice))

    def call():
        return torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True).transpose(1, 2)

    return call, backend


def sdpa_flash_ms(torch, q, k, v):
    """``scaled_dot_product_attention`` held to its flash backend, a second
    yardstick beside the dispatcher's choice: (ms, what ran) or (None, why
    not). The port never calls it."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    try:
        with sdpa_kernel(SDPBackend.FLASH_ATTENTION):
            call = lambda: torch.nn.functional.scaled_dot_product_attention(  # noqa: E731
                qt, kt, vt, is_causal=True, enable_gqa=True)
            call()
            return cuda_ms(torch, call, 5), "FLASH_ATTENTION, enable_gqa=True"
    except RuntimeError as err:
        first = str(err).strip().splitlines()[0] if str(err).strip() else type(err).__name__
        return None, f"FLASH_ATTENTION not available for these inputs: {first[:200]}"


def sdpa_efficient_ms(torch, q, k, v):
    """``scaled_dot_product_attention`` held to its memory-efficient backend
    on the model layout's q and on k, v repeated to q's heads before the
    timed window (the repeat is not timed): the f32 yardstick, since the
    dispatcher picks the math backend for f32 with ``enable_gqa``. (ms, what
    ran) or (None, why not). The port never calls it."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    rep = q.shape[2] // k.shape[2]
    qt = q.transpose(1, 2)
    kt, vt = (x.repeat_interleave(rep, dim=2).transpose(1, 2) for x in (k, v))
    try:
        with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):
            call = lambda: torch.nn.functional.scaled_dot_product_attention(  # noqa: E731
                qt, kt, vt, is_causal=True)
            call()
            return cuda_ms(torch, call, 5), f"EFFICIENT_ATTENTION, K/V repeated to {q.shape[2]} heads"
    except RuntimeError as err:
        first = str(err).strip().splitlines()[0] if str(err).strip() else type(err).__name__
        return None, f"EFFICIENT_ATTENTION not available for these inputs: {first[:200]}"


def phase_flash(torch, dev, peak, rates, fmod, fault_libs, f32_fault_libs, launches):
    """Phase 8: flash attention against its plain version (with a NaN made on
    the card in one f32 case), its ops path, the power of the full-width
    comparisons (bf16 and f32) and the timing. Returns the phase's record
    with the kernels' JSON entries (bf16 and f32)."""
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.flash_attention.ref import flash_attention_plain

    checks = Checks(torch, "the flash-attention kernel")
    gen = torch.Generator(device=dev).manual_seed(1)
    dtypes = (torch.float32, torch.bfloat16)

    def randn(*shape, dtype=torch.float32, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(dtype)

    def plain_by_head(q, k, v, **kw):
        """The plain version on [b, s, h, d], head by head (the scores of
        all heads at once would not fit: 8.6 GB at gemma2-27b's width)."""
        g = q.shape[2] // k.shape[2]
        return torch.stack([flash_attention_plain(q[:, :, i], k[:, :, i // g], v[:, :, i // g], **kw)
                            for i in range(q.shape[2])], dim=2)

    for (label, bh, sq, skv, d, causal, win, cap, bq, bk), dtype in itertools.product(FLASH_CASES, dtypes):
        key = str(dtype).split(".")[1]
        q, k, v = randn(bh, sq, d, dtype=dtype), randn(bh, skv, d, dtype=dtype), randn(bh, skv, d, dtype=dtype)
        kw = dict(causal=causal, window=win, logit_cap=cap)
        out = fmod.flash_attention_kernel(q, k, v, block_q=bq, block_k=bk, **kw)
        torch.cuda.synchronize()
        checks.hold(key, out, flash_attention_plain(q, k, v, **kw), FLASH_TOL[key],
                    f"{label} {key} {(bh, sq, skv, d, causal, win, cap)}")
        if causal and sq > skv:  # the first sq - skv queries see no key: exactly 0
            checks.hold(key, out[:, : sq - skv], torch.zeros_like(out[:, : sq - skv]), 0.0,
                        f"{label} {key}: rows that see no key")
    # A NaN made on the card in one element of q (f32, the first sweep case):
    # that query row, and only that row, is NaN in the plain version. Not in
    # V: the kernel skips masked tiles at its own tile size, while the plain
    # version multiplies the 0s of P by every V row, so a NaN there spreads
    # differently in the two for no fault of either.
    nan, nan_bits = device_nan(torch, dev)
    _, bh, sq, skv, d, causal, win, cap, bq, bk = FLASH_CASES[0]
    q, k, v = randn(bh, sq, d), randn(bh, skv, d), randn(bh, skv, d)
    q[1, 100, 5] = nan
    kw = dict(causal=causal, window=win, logit_cap=cap)
    ref = flash_attention_plain(q, k, v, **kw)
    out = fmod.flash_attention_kernel(q, k, v, block_q=bq, block_k=bk, **kw)
    torch.cuda.synchronize()
    checks.hold_nans("float32", out, ref, FLASH_TOL["float32"], f"NaN {nan_bits} in q[1, 100, 5]")
    nan_rows = sorted({tuple(x) for x in ref.isnan().nonzero()[:, :2].tolist()})
    nan_case = {"bits": nan_bits, "plain_nan_rows": nan_rows, "kernel_nan": int(out.isnan().sum()),
                "plain_nan": int(ref.isnan().sum())}
    log(f"[8 flash] NaN made on the card, bits {nan_bits}, in q[1, 100, 5] (f32 {FLASH_CASES[0][1:5]}): "
        f"kernel NaN at {nan_case['kernel_nan']} elements, plain at {nan_case['plain_nan']} "
        f"(rows {nan_rows}); positions equal: {torch.equal(out.isnan(), ref.isnan())}")
    log(f"[8 flash] kernel vs plain, {checks.n} checks (sweep, traps, decode, the NaN case; f32 and "
        f"bf16): max_abs_err {checks.errs}, failures {len(checks.failures)}")
    checks.stop_if_failed("phase 8, kernel cases")

    inputs = {}
    for (name, (b, s, h, kv, d), _), dtype in itertools.product(FLASH_PATH, dtypes):
        inputs[name, dtype] = (randn(b, s, h, d, dtype=dtype, scale=FLASH_Q_SCALE),
                               randn(b, s, kv, d, dtype=dtype), randn(b, s, kv, d, dtype=dtype))
    outs = {}
    fmod.reset_counts()
    for (name, _, kw), dtype in itertools.product(FLASH_PATH, dtypes):
        outs[name, dtype] = flash_attention(*inputs[name, dtype], **kw)
    torch.cuda.synchronize()
    launches["flash_attention[ops]"] = fmod.flash_attention_kernel.launches
    by_dtype = dict(fmod.flash_attention_kernel.launches_by_dtype)
    log(f"[8 flash] ops path (gqa, qwen3-14b, gemma2-27b; f32 and bf16): flash kernel launches "
        f"{launches['flash_attention[ops]']} (by dtype: {by_dtype})")
    if not all(by_dtype.values()):
        sys.exit(f"chip_smoke: the flash_attention path did not launch both flash kernels: {by_dtype}")
    by_config = Checks(torch, "the flash-attention kernel")  # the same comparisons, per config
    for (name, _, kw), dtype in itertools.product(FLASH_PATH, dtypes):
        key = str(dtype).split(".")[1]
        pkw = {a: kw[a] for a in ("window", "logit_cap") if a in kw}
        ref = plain_by_head(*inputs[name, dtype], **pkw)
        checks.hold(key, outs[name, dtype], ref, FLASH_TOL[key], f"ops path {name} {key}")
        by_config.hold(f"{name} {key}", outs[name, dtype], ref, FLASH_TOL[key], "")
        del ref
    del outs
    log(f"[8 flash] ops path vs plain (q at {FLASH_Q_SCALE:g}x unit scale): max_abs_err "
        f"{checks.errs}, share of tolerance used {checks.used}, failures {len(checks.failures)}")
    log("[8 flash] share of tolerance used per config: "
        + ", ".join(f"{k_} {x:.4g}" for k_, x in by_config.used.items()))
    checks.stop_if_failed("phase 8, ops path")

    power = {}
    for key, faults, libs in (("bfloat16", FLASH_FAULTS, fault_libs),
                              ("float32", FLASH_F32_FAULTS, f32_fault_libs)):
        power[key], missed = flash_power(torch, fmod, faults, libs, key,
                                         lambda q, k, v: flash_attention(q, k, v), plain_by_head,
                                         *inputs["qwen3-14b", getattr(torch, key)])
        for label, row in power[key].items():
            log(f"[8 power] qwen3-14b {key}, q at {label}: share of tolerance used by "
                + ", ".join(f"{n_}: {x:.4g}" for n_, x in row.items()))
        if missed:
            sys.exit(f"chip_smoke: the full-width {key} flash comparison does not reject {missed}")

    rows = []
    for (name, (b, s, h, kv, d), kw), dtype in itertools.product(FLASH_PATH[1:], dtypes):
        key = str(dtype).split(".")[1]
        q, k, v = inputs[name, dtype]
        pkw = {a: kw[a] for a in ("window", "logit_cap") if a in kw}
        flops = 4.0 * d * b * h * live_pairs(s, s, True, kw.get("window"))
        nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
        if key == "float32":  # 3xTF32 on the tensor cores; FFMA as the old roof
            bound_ms, bound_by = bound(3 * flops, nbytes, peak["tf32_flops"], peak)
            extra = {"bound_ms_ffma": bound(flops, nbytes, peak["f32_flops"], peak)[0],
                     "mma_sync_ms": bound(3 * flops, nbytes, rates["tf32"], peak)[0]}
        else:
            bound_ms, bound_by = bound(flops, nbytes, peak["bf16_flops"], peak)
            extra = {"mma_sync_ms": None}
        row = {"config": name, "dtype": key, "shape": [b, s, h, kv, d], "flops": flops, "bytes": nbytes,
               "bound_ms": bound_ms, "bound_by": bound_by, **extra,
               "ms": cuda_ms(torch, lambda: flash_attention(q, k, v, **kw), 5),
               "plain_ms": cuda_ms(torch, lambda: plain_by_head(q, k, v, **pkw), 2, warmup=1)}
        row["tflops"] = flops / row["ms"] * 1e-9
        row["share_of_bound"] = bound_ms / row["ms"]
        if name == "qwen3-14b":
            call, backend = sdpa_call(torch, q, k, v)
            row["library_ms"] = cuda_ms(torch, call, 5)
            row["library"] = f"scaled_dot_product_attention(is_causal=True, enable_gqa=True), {backend}"
            row["library_max_abs_diff_vs_kernel"] = float((call().float() - flash_attention(q, k, v).float()).abs().max())
            row["sdpa_flash_ms"], row["sdpa_flash"] = sdpa_flash_ms(torch, q, k, v)
            if key == "float32":
                row["sdpa_efficient_ms"], row["sdpa_efficient"] = sdpa_efficient_ms(torch, q, k, v)
        else:
            row["library_ms"] = None
            row["library"] = "none: no single PyTorch call applies the tanh softcap"
        rows.append(row)
        flash_ms = row.get("sdpa_flash_ms")
        bounds = (f"bound {bound_ms:.4f} ms ({bound_by}"
                  + (f", 3xTF32 at 494.7 TFLOP/s; FFMA at 67: {row['bound_ms_ffma']:.4f} ms; at this "
                     f"card's mma.sync rate {row['mma_sync_ms']:.4f} ms)" if key == "float32" else ")"))
        log(f"[8 time] {name} {key}: kernel {row['ms']:.4f} ms ({row['tflops']:.1f} TFLOP/s, "
            f"{100 * row['share_of_bound']:.1f} % of the bound), {bounds}, "
            f"plain {row['plain_ms']:.4f} ms, library "
            + (f"{row['library_ms']:.4f} ms ({row['library']})" if row["library_ms"] is not None
               else f"- ({row['library']})")
            + ("" if "sdpa_flash" not in row else "; SDPA flash backend "
               + (f"{flash_ms:.4f} ms" if flash_ms is not None else "-") + f" ({row['sdpa_flash']})")
            + ("" if "sdpa_efficient" not in row else "; SDPA efficient backend "
               + (f"{row['sdpa_efficient_ms']:.4f} ms" if row["sdpa_efficient_ms"] is not None else "-")
               + f" ({row['sdpa_efficient']})"))
    head = next(r for r in rows if r["config"] == "qwen3-14b" and r["dtype"] == "bfloat16")
    f32 = next(r for r in rows if r["config"] == "qwen3-14b" and r["dtype"] == "float32")
    kernel = {
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention/flash_attention.py:103",
        "launches": by_dtype["bfloat16"],
        "max_abs_err": checks.errs["bfloat16"],
        "ms": head["ms"], "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
        "bound_by": head["bound_by"], "library_ms": head["library_ms"],
        "tflops": head["tflops"], "share_of_bound": head["share_of_bound"],
        "sdpa_flash_ms": head.get("sdpa_flash_ms"), "tolerance": FLASH_TOL["bfloat16"],
        "kernel": "flash_bf16_kernel", "config": "qwen3-14b", "dtype": "bfloat16", "shape": head["shape"],
        "launches_by_path": {"flash_attention[ops]": launches["flash_attention[ops]"]},
    }
    kernel_f32 = {
        "name": "flash_attention_f32", "route": "cuda",
        "source": "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention/flash_attention.py:103",
        "launches": by_dtype["float32"],
        "max_abs_err": checks.errs["float32"],
        "ms": f32["ms"], "plain_ms": f32["plain_ms"], "bound_ms": f32["bound_ms"],
        "bound_by": f32["bound_by"], "library_ms": f32["sdpa_efficient_ms"],
        "library": f32["sdpa_efficient"],
        "tflops": f32["tflops"], "share_of_bound": f32["share_of_bound"],
        "bound_ms_3xtf32": f32["bound_ms"], "bound_ms_ffma": f32["bound_ms_ffma"],
        "mma_sync_ms": f32["mma_sync_ms"], "sdpa_dispatcher_ms": f32["library_ms"],
        "tolerance": FLASH_TOL["float32"], "kernel": "flash_f32_kernel",
        "config": "qwen3-14b", "dtype": "float32", "shape": f32["shape"],
        "gemma2_27b_ms": next(r["ms"] for r in rows if r["config"] == "gemma2-27b" and r["dtype"] == "float32"),
        "launches_by_path": {"flash_attention[ops]": launches["flash_attention[ops]"]},
    }
    return {"checks": checks.n, "max_abs_err": checks.errs, "tolerance_used": checks.used,
            "tolerance_used_by_config": by_config.used, "nan_case": nan_case,
            "tolerance": FLASH_TOL, "q_scale_of_path": FLASH_Q_SCALE, "power": power,
            "timings": rows, "kernels": [kernel, kernel_f32]}


def ssd_sass_check(smod, lib_path, spills):
    """Phase 9's SASS check: every SSD instantiation that carries a product
    (scores, chunk state and chunk scan per head dim) runs it on HMMA
    (mma.sync); no instantiation touches local memory; ptxas reports no
    spill."""
    sass = sass_report(lib_path)
    products = {k_: c for k_, c in sass.items()
                if any(part in k_ for part in ("scores", "chunk_state", "chunk_scan"))}
    want = 1 + 2 * len(smod.HEAD_DIMS)
    log("[9 sass] ssd: " + "; ".join(
        f"{k_} HMMA {c['HMMA']} LDGSTS {c['LDGSTS']} LDL/STL {c['LDL'] + c['STL']}"
        for k_, c in sass.items()))
    missing = [k_ for k_, c in products.items() if not c["HMMA"]]
    local = [k_ for k_, c in sass.items() if c["LDL"] or c["STL"]]
    if len(products) != want or missing or local:
        sys.exit(f"chip_smoke: SSD product instantiations without HMMA {missing} or with local "
                 f"memory {local} ({len(products)} of {want} found)")
    if spills:
        sys.exit(f"chip_smoke: SSD instantiations spill: {spills}")
    return sass


def ssd_kernel_flops(b, s, h, p, n, g, chunk):
    """The f32 multiply-adds (x 2) that csrc/ssd.cu issues, at its tiling
    (``SSD_TILE`` rows, K steps of ``SSD_KT``): score tiles on and below the
    diagonal once per (batch, chunk, group); the chunk state over n in the
    warps' 32-column blocks; the chunk scan's C . state^T per row tile, and
    its y_intra per 32-row warp band up to the band's diagonal, in slabs of
    8 columns within the diagonal step."""
    def up(x, m):
        return -(-x // m) * m

    tile, kt = SSD_TILE, SSD_KT
    nc, tiles = s // chunk, -(-chunk // tile)
    scores = b * nc * g * tiles * (tiles + 1) // 2 * 2 * tile * tile * up(n, kt)
    state = b * nc * h * 2 * p * min(128, up(n, 32)) * up(chunk, kt)
    inter = b * nc * h * tiles * 2 * tile * up(n, kt) * p
    intra = 0  # columns a 32-row band takes: whole K steps, then up to its diagonal
    for it in range(tiles):
        jmax = min(chunk, tile * it + tile)
        for row0 in range(tile * it, tile * it + tile, 32):
            for j0 in range(0, min(jmax, row0 + 32), kt):
                intra += 2 * 32 * p * min(kt, row0 + 32 - j0)
    return float(scores + state + inter + b * nc * h * intra)


def ssd_power(torch, smod, fault_libs, run, ref):
    """The power of the mamba2-1.3b comparison: the share of its tolerance,
    max |out - plain| / (tol * (1 + |plain|)), that the kernel and each
    planted fault use. Returns the shares and the required faults that it
    did not reject. The faults' launches are not counted."""
    def share(out):
        return float(((out - ref).abs() / (SSD_TOL * (1 + ref.abs()))).max())

    saved = counts_of(smod.ssd_scan_kernel)
    shares = {"kernel": share(run())}
    for name, _, _, _ in SSD_FAULTS:
        shares[name] = share(run_with(smod, smod.ssd_scan_kernel, smod.bind(fault_libs[name]), run))
    torch.cuda.synchronize()
    vars(smod.ssd_scan_kernel).update(saved)
    return shares, [name for name, _, _, must in SSD_FAULTS if must and not shares[name] > 1.0]


def phase_ssd(torch, dev, peak, smod, launches, fault_libs, rates, built, unguarded):
    """Phase 9: the SSD library's SASS, the kernel against its plain
    version (with a NaN made on the card in one case), the ``ssd_mix`` path
    at mamba2-1.3b's width, the power of that comparison (planted faults),
    the timing of the scan and each pass, and what the split's NaN guard
    costs (``unguarded``: the library built without it)."""
    from repro_torch.kernels.ssd.ops import ssd_mix
    from repro_torch.kernels.ssd.ref import ssd_scan_ref

    sass = ssd_sass_check(smod, ROOT / built["library"], built["ptxas_spills"])
    checks = Checks(torch, "the SSD kernel")
    by_case = Checks(torch, "the SSD kernel")  # the same comparisons, per case
    gen = torch.Generator(device=dev).manual_seed(2)

    def mixer_inputs(b, s, h, p, n, g, a_shift=0.0, dt_shift=0.0):
        """The reference tests' distributions: dt = softplus(N(0, 1) +
        dt_shift), a_log = N(0, 0.5^2) + a_shift."""
        r = lambda *shape: torch.randn(shape, generator=gen, device=dev)  # noqa: E731
        return (r(b, s, h, p), torch.nn.functional.softplus(r(b, s, h) + dt_shift),
                r(h) * 0.5 + a_shift, r(b, s, g, n), r(b, s, g, n))

    def kernel_inputs(x, dt, a_log):
        return x * dt[..., None], dt * -torch.exp(a_log)  # xbar, logda

    def plain(xbar, logda, bm, cm):
        b, s, h, p = xbar.shape
        y, _ = ssd_scan_ref(*smod.heads_flat(xbar, logda, bm, cm))
        return y.reshape(b, h, s, p).transpose(1, 2)

    for label, b, s, h, p, n, g, chunk, a_shift, dt_shift in SSD_CASES:
        x, dt, a_log, bm, cm = mixer_inputs(b, s, h, p, n, g, a_shift, dt_shift)
        xbar, logda = kernel_inputs(x, dt, a_log)
        out = smod.ssd_scan_kernel(xbar, logda, bm, cm, chunk=chunk)
        torch.cuda.synchronize()
        ref = plain(xbar, logda, bm, cm)
        what = f"{label} {(b, s, h, p, n, g, chunk)}"
        checks.hold("float32", out, ref, SSD_TOL, what)
        by_case.hold(what, out, ref, SSD_TOL, what)
    # A NaN made on the card in one element of C (the groups case, group 1):
    # token 40's y, for every head of that group, is NaN in the plain version.
    nan, nan_bits = device_nan(torch, dev)
    label, b, s, h, p, n, g, chunk, _, _ = SSD_CASES[3]
    x, dt, a_log, bm, cm = mixer_inputs(b, s, h, p, n, g)
    xbar, logda = kernel_inputs(x, dt, a_log)
    cm[0, 40, 1, 3] = nan
    ref = plain(xbar, logda, bm, cm)
    run = lambda: smod.ssd_scan_kernel(xbar, logda, bm, cm, chunk=chunk)  # noqa: E731
    out = run()
    torch.cuda.synchronize()
    checks.hold_nans("float32", out, ref, SSD_TOL, f"NaN {nan_bits} in C[0, 40, 1, 3], {label}")
    nan_case = {"bits": nan_bits, "plain_nan_tokens_heads": sorted(
                    {tuple(t_) for t_ in ref.isnan().nonzero()[:, :3].tolist()}),
                "kernel_nan": int(out.isnan().sum()), "plain_nan": int(ref.isnan().sum()),
                "unguarded_nan": int(run_with(smod, smod.ssd_scan_kernel, unguarded, run).isnan().sum())}
    log(f"[9 ssd] NaN made on the card (bits {nan_bits}) in C[0, 40, 1, 3] ({label} "
        f"{(b, s, h, p, n, g, chunk)}): kernel NaN at {nan_case['kernel_nan']} elements, plain at "
        f"{nan_case['plain_nan']} ((batch, token, head): {nan_case['plain_nan_tokens_heads']}); "
        f"the build without the guard: NaN at {nan_case['unguarded_nan']}")
    log(f"[9 ssd] kernel vs plain, {checks.n} checks: max_abs_err {checks.errs}, "
        f"failures {len(checks.failures)}; share of tolerance used per case: "
        + ", ".join(f"{k_} {x:.4g}" for k_, x in by_case.used.items()))
    checks.stop_if_failed("phase 9, kernel cases")

    b, s, h, p, n, g, chunk = MAMBA2
    x, dt, a_log, bm, cm = mixer_inputs(b, s, h, p, n, g)
    smod.ssd_scan_kernel.launches = 0
    y = ssd_mix(x, dt, a_log, bm, cm, chunk=chunk)
    torch.cuda.synchronize()
    launches["ssd[ssd_mix]"] = smod.ssd_scan_kernel.launches
    log(f"[9 ssd] ssd_mix path at mamba2-1.3b {MAMBA2}: SSD kernel launches {launches['ssd[ssd_mix]']}")
    if launches["ssd[ssd_mix]"] == 0:
        sys.exit("chip_smoke: the ssd_mix path launched no SSD kernel")
    ref = ssd_mix(x, dt, a_log, bm, cm, use_kernel=False)
    checks.hold("float32", y, ref, SSD_TOL, "ssd_mix mamba2-1.3b")
    by_case.hold("mamba2-1.3b", y, ref, SSD_TOL, "")
    xbar, logda = kernel_inputs(x, dt, a_log)
    # the largest cum_i - cum_j above a chunk's diagonal; exp overflows f32 above 88.72
    span = float((-logda).reshape(b, s // chunk, chunk, h)[:, :, 1:].sum(dim=2).max())
    log(f"[9 ssd] ssd_mix vs plain: max_abs_err {checks.errs}, share of tolerance used "
        f"{by_case.used['mamba2-1.3b']:.4g}, failures {len(checks.failures)}; "
        f"largest exponent above the diagonal {span:.1f} (f32 exp overflows: {span > 88.72})")
    checks.stop_if_failed("phase 9, ssd_mix path")

    power, missed = ssd_power(torch, smod, fault_libs,
                              lambda: smod.ssd_scan_kernel(xbar, logda, bm, cm, chunk=chunk), ref)
    log("[9 power] mamba2-1.3b: share of tolerance used by "
        + ", ".join(f"{n_}: {x_:.4g}" for n_, x_ in power.items()))
    if missed:
        sys.exit(f"chip_smoke: the mamba2-1.3b SSD comparison does not reject {missed}")
    del y, ref

    # The work this data needs: the lower triangle with its diagonal, C B^T
    # once per (batch, group, chunk), the rest per head.
    flops = b * s * (g * (chunk + 1) * n + h * ((chunk + 1) * p + 4.0 * p * n))
    flops_kernel = ssd_kernel_flops(*MAMBA2)
    flops_per_head = b * s * h * ((chunk + 1) * (n + p) + 4.0 * p * n)  # C B^T again for every head
    flops_ref = b * s * h * (2.0 * chunk * n + 2.0 * chunk * p + 4.0 * p * n)  # variants.py's formula
    nbytes = 4 * (2 * xbar.numel() + logda.numel() + bm.numel() + cm.numel())  # y = xbar's size
    bound_ms, bound_by = bound(3 * flops, nbytes, peak["tf32_flops"], peak)  # 3xTF32
    flat = smod.heads_flat(xbar, logda, bm, cm)
    run = smod.pass_launcher(xbar, logda, bm, cm, chunk=chunk)
    run(smod.ALL_PASSES)  # fills the scratch that each pass then reads
    pass_ms = {name: device_ms(torch, functools.partial(run, 1 << k), 10)
               for k, name in enumerate(smod.PASSES)}
    row = {"config": "mamba2-1.3b", "dtype": "float32", "shape": list(MAMBA2), "flops": flops,
           "flops_kernel_does": flops_kernel, "flops_scores_per_head": flops_per_head,
           "flops_reference_formula": flops_ref, "bytes": nbytes,
           "bound_ms": bound_ms, "bound_by": bound_by,
           "bound_ms_ffma": bound(flops, nbytes, peak["f32_flops"], peak)[0],
           "mma_sync_ms": bound(3 * flops, nbytes, rates["tf32"], peak)[0],
           "bytes_ms": nbytes / peak["bytes_per_s"] * 1e3,
           "ms": cuda_ms(torch, lambda: smod.ssd_scan_kernel(xbar, logda, bm, cm, chunk=chunk), 10),
           "pass_ms": pass_ms, "kernels_per_scan": len(smod.PASSES),
           "plain_ms": cuda_ms(torch, lambda: ssd_scan_ref(*flat), 2, warmup=1),
           "library_ms": None, "library": "none: no single PyTorch call computes the SSD scan",
           "largest_exponent_above_diagonal": span}
    row["share_of_bound"] = bound_ms / row["ms"]
    row["kernel_tflops"] = flops_kernel / row["ms"] * 1e-9
    log(f"[9 time] mamba2-1.3b f32: scan {row['ms']:.4f} ms ({len(smod.PASSES)} kernels, each "
        f"queued behind a device sleep: " + ", ".join(f"{k_} {v:.4f}" for k_, v in pass_ms.items())
        + f"; sum {sum(pass_ms.values()):.4f}); bound {bound_ms:.4f} ms ({bound_by}, 3xTF32 at "
        f"494.7 TFLOP/s; {100 * row['share_of_bound']:.1f} % of it), FFMA at 67 "
        f"{row['bound_ms_ffma']:.4f}, at this card's mma.sync rate {row['mma_sync_ms']:.4f}, "
        f"bytes {row['bytes_ms']:.4f}; flops: data {flops:.4e}, kernel {flops_kernel:.4e} "
        f"({row['kernel_tflops']:.1f} TFLOP/s), with the scores per head {flops_per_head:.4e}, "
        f"the site's formula {flops_ref:.4e}; plain {row['plain_ms']:.4f} ms, library - ({row['library']})")
    guard = in_turns(torch, smod, smod.ssd_scan_kernel, unguarded,
                     lambda: smod.ssd_scan_kernel(xbar, logda, bm, cm, chunk=chunk), 10)
    row["guard_cost_ms"] = {"guarded": guard["own"], "unguarded": guard["other"]}
    log(f"[9 guard] mamba2-1.3b, in turns (guarded, unguarded, unguarded, guarded): guarded "
        + ", ".join(f"{x:.4f}" for x in guard["own"]) + " ms, without the guard "
        + ", ".join(f"{x:.4f}" for x in guard["other"]) + " ms")
    kernel = {
        "name": "ssd_scan", "route": "cuda", "source": "src/repro_torch/kernels/ssd/csrc/ssd.cu",
        "replaces": "src/repro/kernels/ssd/ssd.py:72",
        "launches": launches["ssd[ssd_mix]"], "max_abs_err": max(checks.errs.values()),
        "ms": row["ms"], "plain_ms": row["plain_ms"], "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": None, "bound_ms_ffma": row["bound_ms_ffma"], "mma_sync_ms": row["mma_sync_ms"],
        "bytes_ms": row["bytes_ms"], "pass_ms": pass_ms, "kernels_per_scan": len(smod.PASSES),
        "flops": flops, "flops_kernel_does": flops_kernel, "tolerance": SSD_TOL,
        "config": "mamba2-1.3b", "dtype": "float32", "shape": list(MAMBA2),
        "launches_by_path": {"ssd[ssd_mix]": launches["ssd[ssd_mix]"]},
    }
    return {"checks": checks.n, "max_abs_err": checks.errs, "tolerance_used": checks.used,
            "tolerance_used_by_case": by_case.used, "tolerance": SSD_TOL, "power": power,
            "nan_case": nan_case,
            "sass": sass, "timings": [row], "kernel": kernel}


def phase_sites(torch, rank_site, attention_site, ssd_chunk_site):
    """Phase 10: the attention_impl and ssd_chunk sites at the reference's
    defaults, each variant held against the oracle on the site's own seed-0
    inputs, then ranked."""
    from repro_torch.models.attention import attention_reference
    from repro_torch.models.mamba2 import ssd_reference

    checks = Checks(torch, "a site variant")
    att = attention_site()
    q, k, v = att.make_inputs(0)
    oracle = attention_reference(q, k, v)
    for variant in att.variants:  # 2e-4: blockwise against full scores, the reference's
        checks.hold(variant.name, variant.build(q, k, v)(), oracle, 2e-4, f"{att.name} {variant.name}")
    del q, k, v, oracle
    ssd = ssd_chunk_site()
    x, dt, a_log, bm, cm = ssd.make_inputs(0)
    oracle, _ = ssd_reference(x, dt, a_log, bm, cm)
    for variant in ssd.variants:
        checks.hold(variant.name, variant.build(x, dt, a_log, bm, cm)(), oracle, SSD_TOL,
                    f"{ssd.name} {variant.name}")
    del x, dt, a_log, bm, cm, oracle
    log(f"[10 autotune] {checks.n} site variants vs oracle: max_abs_err {checks.errs}, "
        f"share of tolerance used {checks.used}, failures {len(checks.failures)}")
    checks.stop_if_failed("phase 10")
    out = {"max_abs_err": checks.errs, "tolerance_used": checks.used}
    for site in (att, ssd):
        report = rank_site(site)
        log("[10 autotune] " + report.summary().replace("\n", "\n    "))
        out[site.name] = {
            "ranks": report.ranking.ranks, "mean_ranks": report.ranking.mean_ranks,
            "selected": report.selected,
            "single_run_ms": {k_: t * 1e3 for k_, t in report.single_run_times.items()},
            "dropped": list(report.dropped), "flops": site.flops_table(),
            "verdict": report.discriminant.reason if report.discriminant.is_anomaly else "valid",
        }
    return out


def main():
    import torch

    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device; the port's path runs only on the card")
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.autotune import attention_site, matmul_blocks_site, rank_site, ssd_chunk_site
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
    from repro_torch.kernels.build import build_library
    from repro_torch.kernels.flash_attention import flash_attention as fmod
    from repro_torch.kernels.matmul import matmul as kmod
    from repro_torch.kernels.ssd import ssd as smod
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
    # one nvcc per source, all started together: flash attention, SSD, the
    # mma.sync rate probe and the planted faults of phases 3, 8 and 9 beside
    # the GEMM
    builds = concurrent.futures.ThreadPoolExecutor(
        max_workers=5 + len(FLASH_FAULTS) + len(FLASH_F32_FAULTS) + len(GEMM_FAULTS) + len(SSD_FAULTS))
    t_builds = time.perf_counter()
    later_builds = {"flash_attention": builds.submit(fmod.build), "ssd": builds.submit(smod.build)}
    peak_build = builds.submit(build_library, kmod.SOURCE.parent / "mma_peak.cu", kmod.BUILD_DIR)
    fault_dir = tempfile.TemporaryDirectory(prefix="chip_smoke_faults_")
    fault_builds = {name: builds.submit(build_fault, fmod, build_library, fault_dir.name, i, old, new)
                    for i, (name, old, new, _) in enumerate(FLASH_FAULTS) if old is not None}
    f32_fault_builds = {name: builds.submit(build_fault, fmod, build_library, fault_dir.name, f"f32_{i}", old, new)
                        for i, (name, old, new, _) in enumerate(FLASH_F32_FAULTS)}
    unguarded_builds = {mod: builds.submit(build_fault, mod, build_library, fault_dir.name, "unguarded",
                                           TF32_GUARD, "") for mod in (kmod, smod)}
    gemm_fault_builds = {name: builds.submit(build_fault, kmod, build_library, fault_dir.name, i, old, new)
                         for i, (name, old, new) in enumerate(GEMM_FAULTS)}
    ssd_fault_builds = {name: builds.submit(build_fault, smod, build_library, fault_dir.name, i, old, new)
                        for i, (name, old, new, _) in enumerate(SSD_FAULTS)}
    t0 = time.perf_counter()
    lib_path = kmod.build()
    kmod._library()
    build_s = time.perf_counter() - t0
    used, spills = ptxas_report(lib_path)
    details["build"] = {"seconds": build_s, "library": str(lib_path.relative_to(ROOT)),
                        "ptxas_used": used, "ptxas_spills": spills}
    log(f"[2 build] {lib_path.name} in {build_s:.1f} s; {len(used)} kernels; "
        f"nonzero spill lines: {len(spills)}")
    for line in used:
        log(f"  ptxas: {line}")
    # Products on mma.sync (HMMA), loads by cp.async (LDGSTS), no spill.
    details["build"]["sass"] = gemm_sass_check(kmod, lib_path, spills)

    # ---------------------------------------------- 3. kernel vs plain ---
    gen = torch.Generator(device=dev).manual_seed(0)
    gemm_checks = Checks(torch, "the GEMM kernel")
    compare, fail_on = gemm_checks.hold, gemm_checks.stop_if_failed
    by_tile = Checks(torch, "the GEMM kernel")  # phase 3's comparisons, per (tile, dtype pair)

    def compare_tile(tile, pair, key, out, ref, tol, what):
        compare(key, out, ref, tol, what)
        by_tile.hold(f"{'x'.join(map(str, tile))} {pair}", out, ref, tol, what)

    reset_gemm_counts(kmod)
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
                out_kind = kind if out_dtype is None else str(out_dtype).split(".")[1]
                compare_tile(tile, f"{kind}->{out_kind}", kind if out_dtype is None else "bfloat16",
                             out, matmul_ref(a, b, out_dtype), tol,
                             f"tile {tile} {kind}->{out_kind} {(m, k, n)}")
    for inst_name in INSTANCES:
        inst = get_instance(inst_name, smoke=False)
        algs = inst.algorithms()
        mats = make_chain_inputs(inst.dims)
        verify_algorithms(algs, mats)  # torch.matmul route, the reference's 1e-4
        for alg, tile in itertools.product(algs, kmod.SUPPORTED_TILES):
            out = chain_matmul(alg, mats, block_m=tile[0], block_n=tile[1], block_k=tile[2])
            plain = chain_matmul(alg, mats, use_kernel=False)
            torch.cuda.synchronize()
            compare_tile(tile, "chain float32", "chain", out, plain, TOL["chain"],
                         f"chain {inst_name} {alg.name} tile {tile}")
    log(f"[3 kernel vs plain] {gemm_checks.n} checks, |kernel - plain| <= tol * (1 + |plain|) "
        f"with tol {TOL}: max_abs_err {gemm_checks.errs}, failures {len(gemm_checks.failures)}")
    log("[3 kernel vs plain] largest share of the tolerance per (tile, dtype pair): "
        + ", ".join(f"{k_} {x:.4g}" for k_, x in by_tile.used.items()))
    fail_on("phase 3")
    by_copy = dict(kmod.matmul_kernel.launches_by_copy)
    log(f"[3 kernel vs plain] GEMM launches by copy width (bytes): {by_copy}")
    if not all(by_copy.values()):
        sys.exit(f"chip_smoke: phase 3 did not launch every copy width: {by_copy}")

    # The power of the f32 comparison: builds with planted faults must fail it.
    gemm_fault_libs = {name: future.result() for name, future in gemm_fault_builds.items()}
    a = torch.randn(1000, 1000, generator=gen, device=dev) / math.sqrt(1000)
    b = torch.randn(1000, 1000, generator=gen, device=dev)
    gemm_shares, missed = gemm_power(torch, kmod, gemm_fault_libs, a, b, matmul_ref(a, b))
    log("[3 power] 1000^3 f32, tile 64^3: share of the f32 tolerance used by "
        + ", ".join(f"{n_}: {x:.4g}" for n_, x in gemm_shares.items()))
    if missed:
        sys.exit(f"chip_smoke: the 1000^3 f32 GEMM comparison does not reject {missed}")
    # A NaN made on the card in one element of A: row 137 of C, and only that
    # row, is NaN in the plain version, at every tile; the build without the
    # split's NaN guard is shown beside it.
    unguarded = {mod: mod.bind(future.result()) for mod, future in unguarded_builds.items()}
    nan, nan_bits = device_nan(torch, dev)
    a_nan = a.clone()
    a_nan[137, 421] = nan
    ref_nan = matmul_ref(a_nan, b)
    for bm, bn, bk in kmod.SUPPORTED_TILES:
        gemm_checks.hold_nans("float32", kmod.matmul_kernel(a_nan, b, block_m=bm, block_n=bn, block_k=bk),
                              ref_nan, TOL["float32"], f"NaN {nan_bits} in A[137, 421], tile {(bm, bn, bk)}")
    gemm_nan = {"bits": nan_bits, "plain_nan": int(ref_nan.isnan().sum()),
                "unguarded_nan": int(run_with(kmod, kmod.matmul_kernel, unguarded[kmod], lambda: kmod.matmul_kernel(
                    a_nan, b, block_m=64, block_n=64, block_k=64)).isnan().sum())}
    log(f"[3 NaN] 1000^3 f32, a NaN made on the card (bits {nan_bits}) in A[137, 421]: plain NaN at "
        f"{gemm_nan['plain_nan']} elements (row 137); every tile's NaN positions equal: "
        f"{not gemm_checks.failures}; the build without the guard, tile 64^3: NaN at {gemm_nan['unguarded_nan']}")
    fail_on("phase 3, NaN case")
    details["gemm_phase3"] = {"tolerance_used_by_tile": by_tile.used, "max_abs_err_by_tile": by_tile.errs,
                              "launches_by_copy": by_copy, "power": gemm_shares, "nan_case": gemm_nan}

    # ------------------------------------------------------------ 4. time --
    rates = mma_rates(torch, peak_build.result())
    log(f"[4 mma.sync] registers only: TF32 m16n8k8 {rates['tf32'] / 1e12:.1f} TFLOP/s "
        f"({100 * rates['tf32'] / peak['tf32_flops']:.1f} % of the {peak['tf32_flops'] / 1e12:.1f} "
        f"data-sheet peak), bf16 m16n8k16 {rates['bf16'] / 1e12:.1f} TFLOP/s "
        f"({100 * rates['bf16'] / peak['bf16_flops']:.1f} % of {peak['bf16_flops'] / 1e12:.0f})")
    details["mma_sync_flops"] = rates
    timings = []
    timed = [(shape, torch.float32) for shape in TIMED_SHAPES]
    timed += [(shape, torch.bfloat16) for shape in BF16_TIMED_SHAPES]
    for (m, k, n), dtype in timed:
        kind = str(dtype).split(".")[1]
        a = (torch.randn(m, k, generator=gen, device=dev) / math.sqrt(k)).to(dtype)
        b = torch.randn(k, n, generator=gen, device=dev).to(dtype)
        plain = matmul_ref(a, b)
        for bm, bn, bk in kmod.SUPPORTED_TILES:  # every timed tile, checked at this shape
            compare(kind, kmod.matmul_kernel(a, b, block_m=bm, block_n=bn, block_k=bk),
                    plain, TOL[kind], f"timed tile {(bm, bn, bk)} {kind} {(m, k, n)}")
        fail_on(f"phase 4, {m}x{k}x{n} {kind}")
        iters = 10 if m >= 4096 else 50
        size = a.element_size()
        if dtype == torch.float32:  # 3xTF32 on the tensor cores; FFMA as the old roof
            bound_ms, bound_by = gemm_bound(m, k, n, size, size, peak["tf32_flops"], peak, products=3)
            extra = {"bound_ms_ffma": gemm_bound(m, k, n, size, size, peak["f32_flops"], peak)[0],
                     "mma_sync_ms": gemm_bound(m, k, n, size, size, rates["tf32"], peak, products=3)[0]}
        else:
            bound_ms, bound_by = gemm_bound(m, k, n, size, size, peak["bf16_flops"], peak)
            extra = {"mma_sync_ms": gemm_bound(m, k, n, size, size, rates["bf16"], peak)[0]}
        row = {
            "shape": [m, k, n], "dtype": kind, "bound_ms": bound_ms, "bound_by": bound_by, **extra,
            "library_ms": cuda_ms(torch, lambda: torch.matmul(a, b), iters),
            "plain_ms": cuda_ms(torch, lambda: matmul_ref(a, b), iters),
            "kernel_ms": {}, "tflops": {}, "share_of_bound": {},
        }
        for bm, bn, bk in kmod.SUPPORTED_TILES:
            key = f"{bm}x{bn}x{bk}"
            row["kernel_ms"][key] = cuda_ms(
                torch, lambda: kmod.matmul_kernel(a, b, block_m=bm, block_n=bn, block_k=bk), iters)
            row["tflops"][key] = 2.0 * m * k * n / row["kernel_ms"][key] * 1e-9
            row["share_of_bound"][key] = bound_ms / row["kernel_ms"][key]
        timings.append(row)
        bounds = (f"bound {bound_ms:.4f} ms ({bound_by}, "
                  + ("3xTF32 at 494.7 TFLOP/s; FFMA at 67: "
                     f"{row['bound_ms_ffma']:.4f} ms" if dtype == torch.float32 else "bf16 at 989 TFLOP/s")
                  + f"; at this card's mma.sync rate {row['mma_sync_ms']:.4f} ms)")
        log(f"[4 time] {m}x{k}x{n} {kind}: {bounds}, torch.matmul {row['library_ms']:.4f} ms, "
            f"plain {row['plain_ms']:.4f} ms, kernel "
            + ", ".join(f"{t} {ms:.4f} ms ({row['tflops'][t]:.1f} TFLOP/s, "
                        f"{100 * row['share_of_bound'][t]:.1f} % of the bound)"
                        for t, ms in row["kernel_ms"].items()))
    details["timings"] = timings
    # What the split's NaN guard costs: the same build without it, in turns.
    a = torch.randn(1000, 1000, generator=gen, device=dev) / math.sqrt(1000)
    b = torch.randn(1000, 1000, generator=gen, device=dev)
    guard = in_turns(torch, kmod, kmod.matmul_kernel, unguarded[kmod],
                     lambda: kmod.matmul_kernel(a, b, block_m=64, block_n=64, block_k=64), 50)
    details["gemm_guard_cost_ms"] = {"guarded": guard["own"], "unguarded": guard["other"]}
    log(f"[4 guard] 1000^3 f32, tile 64^3, in turns (guarded, unguarded, unguarded, guarded): guarded "
        + ", ".join(f"{x:.4f}" for x in guard["own"]) + " ms, without the guard "
        + ", ".join(f"{x:.4f}" for x in guard["other"]) + " ms")
    host = host_cost(torch, kmod, dev)
    details["host_cost_us_per_launch"] = host
    log(f"[4 host] us per launch over {HOST_LAUNCHES} launches of a 64^3 GEMM, one synchronize: "
        + ", ".join(f"{k_} {v:.2f}" for k_, v in host.items()))

    # ------------------------------------------------- 5. quickstart path --
    default_tile = kmod.DEFAULT_TILE
    hand_gemm = functools.partial(matmul, block_m=default_tile[0], block_n=default_tile[1],
                                  block_k=default_tile[2])
    launches = {}
    quickstart = {}
    launches_by_copy = {}
    for route, gemm in (("torch_matmul", torch.matmul), ("hand_gemm", hand_gemm)):
        reset_gemm_counts(kmod)
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
        launches_by_copy[f"quickstart[{route}]"] = dict(kmod.matmul_kernel.launches_by_copy)
        log(f"[5 quickstart {route}] GEMM kernel launches: {kmod.matmul_kernel.launches} "
            f"(by copy width: {kmod.matmul_kernel.launches_by_copy})")
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
    reset_gemm_counts(kmod)
    report = rank_site(site)
    launches["autotune[matmul_blocks]"] = kmod.matmul_kernel.launches
    launches_by_copy["autotune[matmul_blocks]"] = dict(kmod.matmul_kernel.launches_by_copy)
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
    details["correctness"] = {"checks": gemm_checks.n, "max_abs_err": gemm_checks.errs,
                              "tolerance_used": gemm_checks.used, "tolerance": TOL}
    log(f"[checks] {gemm_checks.n} kernel-vs-plain checks in phases 3, 4 and 6: "
        f"max_abs_err {gemm_checks.errs}")
    gemm_launches = dict(launches)

    # ---------------------------------------------------------- 7. builds --
    built = {}
    for kname, future in later_builds.items():
        path = future.result()
        used, spills = ptxas_report(path)
        built[kname] = {"library": str(path.relative_to(ROOT)), "ptxas_used": used,
                        "ptxas_spills": spills}
        log(f"[7 build] {path.name}; {len(used)} kernels; nonzero spill lines: {len(spills)}")
        for line in used + spills:
            log(f"  ptxas: {line}")
    # The bf16 flash kernel runs its products on wgmma and loads by TMA: each
    # bf16 instantiation's SASS holds HGMMA and UTMALDG, and none spills.
    sass = sass_report(later_builds["flash_attention"].result())
    built["flash_attention"]["sass"] = sass
    bf16 = {k_: c for k_, c in sass.items() if "bf16" in k_}
    log("[7 sass] flash_attention: " + "; ".join(
        f"{k_} HGMMA {c['HGMMA']} UTMALDG {c['UTMALDG']}" for k_, c in sass.items()))
    missing = [k_ for k_, c in bf16.items() if not (c["HGMMA"] and c["UTMALDG"])]
    if len(bf16) != len(fmod.HEAD_DIMS) or missing:
        sys.exit(f"chip_smoke: bf16 flash instantiations {sorted(bf16)} without HGMMA and UTMALDG: "
                 f"{missing}")
    bf16_spills = [ln for ln in built["flash_attention"]["ptxas_spills"] if "bf16" in ln]
    if bf16_spills:
        sys.exit(f"chip_smoke: bf16 flash instantiations spill: {bf16_spills}")
    # The f32 flash kernel runs its products on mma.sync (3xTF32) and loads by
    # cp.async: each f32 instantiation's SASS holds HMMA and LDGSTS, touches no
    # local memory, and none spills.
    f32 = {k_: c for k_, c in sass.items() if "f32" in k_}
    log("[7 sass] flash_attention f32: " + "; ".join(
        f"{k_} HMMA {c['HMMA']} LDGSTS {c['LDGSTS']} LDL/STL {c['LDL'] + c['STL']}" for k_, c in f32.items()))
    missing = [k_ for k_, c in f32.items() if not (c["HMMA"] and c["LDGSTS"]) or c["LDL"] or c["STL"]]
    if len(f32) != len(fmod.HEAD_DIMS) or missing:
        sys.exit(f"chip_smoke: f32 flash instantiations {sorted(f32)} without HMMA and LDGSTS or with local "
                 f"memory: {missing}")
    f32_spills = [ln for ln in built["flash_attention"]["ptxas_spills"] if "f32" in ln]
    if f32_spills:
        sys.exit(f"chip_smoke: f32 flash instantiations spill: {f32_spills}")
    fault_libs = {name: future.result() for name, future in fault_builds.items()}
    f32_fault_libs = {name: future.result() for name, future in f32_fault_builds.items()}
    ssd_fault_libs = {name: future.result() for name, future in ssd_fault_builds.items()}
    builds.shutdown()
    fmod._library()
    smod._library()
    built["seconds_from_start_of_phase_2"] = time.perf_counter() - t_builds
    details["build_attention_ssd"] = built

    flash = phase_flash(torch, dev, peak, rates, fmod, fault_libs, f32_fault_libs, launches)
    details["flash_attention"] = flash
    ssd = phase_ssd(torch, dev, peak, smod, launches, ssd_fault_libs, rates, built["ssd"], unguarded[smod])
    fault_dir.cleanup()
    details["ssd"] = ssd
    details["sites"] = phase_sites(torch, rank_site, attention_site, ssd_chunk_site)
    details["launches"] = launches

    # ---------------------------------------------------------- results --
    main_row = timings[0]  # 1000^3, the chain GEMMs of instance_B
    tile_key = "x".join(map(str, default_tile))
    kernel = {
        "name": "gemm",
        "route": "cuda",
        "source": "src/repro_torch/kernels/matmul/csrc/gemm.cu",
        "replaces": "src/repro/kernels/matmul/matmul.py:45",
        "launches": launches["quickstart[hand_gemm]"] + launches["autotune[matmul_blocks]"],
        "max_abs_err": max(gemm_checks.errs.values()),
        "ms": main_row["kernel_ms"][tile_key],
        "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"],
        "bound_by": main_row["bound_by"],
        "library_ms": main_row["library_ms"],
        "bound_ms_3xtf32": main_row["bound_ms"],
        "bound_ms_ffma": main_row["bound_ms_ffma"],
        "mma_sync_ms": main_row["mma_sync_ms"],
        "launches_by_copy": {w: sum(c[w] for c in launches_by_copy.values() if c)
                             for w in kmod.COPY_WIDTHS},
        "tolerance": TOL, "shape": main_row["shape"], "tile": list(default_tile),
        "launches_by_path": gemm_launches, "launches_by_copy_by_path": launches_by_copy,
    }
    kernels = [kernel, *flash["kernels"], ssd["kernel"]]
    details["kernels"] = kernels
    OUT.parent.mkdir(parents=True, exist_ok=True)
    OUT.write_text(json.dumps(details, indent=1))
    log(card)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                           "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()

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
5. the quickstart path on the four paper instances, on both GEMM routes,
   each with ``jit=True`` (every algorithm captured once as a CUDA graph and
   replayed) and ``jit=False`` (eager launches): each graph's output held to
   eager launches at 1e-4, the GEMM's counter held to 3 x its steps over
   3 replays, single-run times and verdicts of both modes side by side;
6. the ``matmul_blocks`` site through ``rank_site``, on graph thunks (each
   variant's timed thunk one CUDA graph, the reference's jitted thunk) and
   again on eager thunks (``graphs.eager_thunks``): each route's selected
   variant, single-run ms and verdict side by side;
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
   against ``attention_reference`` / ``ssd_reference``, through ``rank_site``
   on graph thunks and again on eager thunks;
11. the census on the card, through ``python -m repro_torch``: the default
   grid (120 chains, gram/distributive/solve/bilinear at five sizes; 220
   instances) by ``census run`` on wall clock, and the GPU kernel lane
   (``kernel_variants`` with ``--kernel-native``, the hand GEMM's tiles
   first held against the exact product, ``matmul_ref``'s in f64) by
   ``census plan`` and ``queue work``, each merged and reported; then both
   grids again in this process through ``run_shard(..., device="cuda")``
   with the GEMM's launches counted, every store checked (checksums, one
   record per instance, the
   reference's metadata, inner repeats), a cost-model census on this host
   against the repo's golden store, and the verdicts of the two passes
   compared (recorded, not required to agree). The chain family's
   algorithms and the measured thunks of the generalized families and the
   kernel lane run as CUDA graphs: both kinds must be captured, none may
   outlive the in-process pass, and ``torch.cuda.memory_allocated()`` is
   recorded before and after it. The generalized families of the default
   grid and the kernel lane run once more in this process on eager thunks
   (``graphs.eager_thunks``), and the verdicts that change between graph
   and eager thunks are recorded by family and size, with each route's
   seconds;
12. explain on the card, through ``python -m repro_torch explain``:
   ``calibrate --backend wall_clock`` fits the card's dispatch and GEMM
   efficiency curve (base machine: the H100 SXM sheet), then both CLI
   census stores of phase 11 are explained against that machine file by
   ``explain run --workers 1``, run again (a no-op: the store's bytes
   unchanged), merged and reported. The explanations must be the census's
   anomalies in order, with every cause in ``CAUSES`` and every evidence in
   [0, 1]; the counts by cause and the unexplained rows are printed. The
   kernel lane is explained again in this process with the GEMM's launches
   counted (``explain[kernel_variants]``, which must be > 0);
13. the ranking oracle and the learned cost model, through ``python -m
   repro_torch oracle|predict`` once per verb and through the same entry
   point (``launch.cli.main``) in this process otherwise, where the step
   touches no device: caches warmed from both CLI censuses and
   their explanations answer every grid instance ``measured`` (by ``oracle
   query --batch``), with the census record's ranks and verdict and the
   explanation's cause; kernel-lane misses outside the warm buckets (the
   hand GEMM's tiles at the misses' sizes first held against the exact
   product, as in phase 11) answer ``model_only``, are enqueued and drained on those
   tiles by ``queue work --device cuda`` and, with the GEMM's launches counted
   (``oracle[kernel_variants]``), by the same entry point in this process,
   then answer ``measured`` with nothing pending; ``oracle serve --refresh``
   answers grid queries and misses (a chain among them, whose CUDA graph
   its refresher thread captures) from a FIFO, and the misses answer
   ``measured`` once its refresher has drained them; ``predict train|eval``
   on a cost-model census of the default grid, and an active cost-model
   census (``--predictor``) that must keep exactly the full census's
   anomaly set (both censuses planned by ``census plan`` and run by
   ``api.run_census`` in this process); an active wall-clock census on the
   card, gated by a model
   trained with ``--machine cpu-1core``, that must both predict (the
   distributive and solve instances) and measure (the GEMM's tiles), timed
   against the full census of its grid and run again in this process with
   the GEMM's launches counted (``active_census[kernel_variants]``); and a
   cache warmed with that model answering a kernel-lane miss
   ``learned_model`` and still enqueueing it;
14. the model stack and the serving engine (``repro_torch.models``,
   ``serve.engine``), which reach no hand kernel, as the reference's model
   path reaches no Pallas kernel: every arch's SMOKE config in f32 on the
   card against the same parameters on the CPU (forward logits, and decode
   consistency on the card), and every LM arch's greedy tokens from the
   serving engine on CUDA graphs held equal to its eager route's
   (``graphs=False``; a sliding-window config across its ring's wrap:
   prompt 130, max_len 160); qwen2-moe-a2.7b and mamba2-1.3b at full width
   in bf16, weights drawn on the card: decode consistency, ``moe_gather``
   against ``moe_dense`` on the first MoE sublayer's input with no token
   dropped, and ``ServingEngine.generate`` on both routes, graphs (the
   default: the decode step captured once per batch size, the prefill once
   per prompt length) and eager: twice each (batch 4, prompt 128, 32
   tokens, greedy; the last logits held to each other, and on graphs the
   tokens of the two runs equal) and for the prefill alone, the graph
   route's tokens held equal to the eager route's and its last logits
   within the bf16 tolerance; for each route the capture seconds, prefill
   and decode ms beside the decode step's weight-stream bound, tokens/s,
   peak memory, and one decode step's host cost and profiled kernels and
   idle share; ``moe_dispatch_site`` through ``rank_site`` at the
   reference's defaults and at qwen2-moe's expert widths, on graph and on
   eager thunks; the three hand kernels' counters over these steps, which
   must read 0; and ``python -m repro_torch.launch.serve`` once (on graphs),
   which must exit 0;
15. training (``repro_torch.train``, ``data``, ``checkpoint``), which reaches
   no hand kernel, as the reference's training path reaches no Pallas
   kernel: granite-moe-3b-a800m and mamba2-1.3b at full width in bf16, not
   cut (weights drawn on the card), through ``ElasticTrainer`` with AdamW on
   a cosine schedule and ``remat="full"``, batch 4 x 2048 tokens: one
   warm-up and five timed steps, whose losses must be finite and fall, the
   first near ln V; step ms, tokens/s, the model TFLOP a step and its share
   of the bf16 peak, the optimizer's ms beside its byte bound, peak memory
   against 14 bytes a parameter of state plus the bf16 grads, and one
   profiled step's kernels and idle share; every LM arch's SMOKE config
   (f32), one step on the card against the CPU from the same parameters and
   batch (loss and grad norm held); the reference's membership-change
   sequence on the card (12 steps, data width 4 -> 2 before step 6) held to
   an uninterrupted run; the hand kernels' counters (recorded, expected 0);
   and ``python -m repro_torch.launch.train --steps 8 --simulate-failure 4:1``,
   which must exit 0;
16. distributed and launch planning (``repro_torch.distributed``,
   ``launch.{compat,mesh,specs,dryrun}``, ``roofline.counts``), which
   reaches no hand kernel: (a) on a world of one on ``nccl`` (a (1, 1)
   ``data x model`` mesh), granite-moe-3b-a800m's SMOKE config (f32) trains
   two steps through a plan (``make_plan``, ``tree_shardings``, every
   sharding field of ``_sharding_opts`` set; params, state and batches
   DTensors), whose losses must equal the unsharded steps' within
   ``DIST_TOL``; ``compressed_psum`` must equal quantise-then-dequantise and
   ``pipeline_apply`` over one stage the stage function, exactly; the group
   is destroyed and the hand kernels' counters over (a) recorded (expected
   0); (b) ``python -m repro_torch.launch.dryrun`` for granite-moe-3b-a800m
   x train_4k on 16x16 and 2x16x16 and qwen2-moe-a2.7b x decode_32k on
   16x16, one process after another, each on a ``fake`` process group of its
   mesh's world size holding rank 0's shard at full width on the card:
   every cell must end ``ok`` or ``ok_overbudget`` with measured memory and
   FLOPs per device, the 2x16x16 cell with collective bytes; each row's
   memory, fit attempts, counts, dominant term and seconds are printed.

Each kernel's launch counter is set to 0 just before each path and read just
after it. The next-to-last line is a JSON object with the kernels' numbers,
the last is ``{"ok": true, "device": {...}}``. Details go to
``chiprun_out/chip_smoke.json``. Imports nothing of JAX or of ``repro``.
"""

import concurrent.futures
import dataclasses
import functools
import gc
import importlib.util
import itertools
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
import weakref
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
# Phase 11's kernel lane (the README's GPU lane): every other flag at its
# default; the default grid is `census run` with every grid flag at its default.
KERNEL_LANE = ("--chains", "0", "--families", "kernel_variants", "--kernel-native",
               "--kernel-sites", "matmul,attention,ssd", "--sizes", "256,512,1024",
               "--per-size", "4", "--shards", "8", "--backend", "wall_clock")
KERNEL_LANE_SIZES = (256, 512, 1024)
CENSUS_TIMEOUT = 420  # seconds for one census command
#: phase 12: the explain campaigns' flags (the reference's defaults, not cut)
#: and the calibration's base machine, the H100 SXM sheet of ``peaks()``
EXPLAIN_KNOBS = ()
CALIBRATE = ("--machine", "h100-sxm", "--peak-flops", "6.7e13", "--hbm-bw", "3.35e12")
#: phase 13: the kernel lane's misses (sizes outside its warm buckets), the
#: misses fed to `oracle serve --refresh` on the default cache (outside its
#: buckets; a chain among them), and the active wall-clock census's grid:
#: instances the gate skips (FLOPs 2x apart or more) and the hand GEMM's
#: tiles (equal FLOPs), which it must measure
ORACLE_MISS_SIZES = (2048, 128)
SERVE_MISSES = ({"family": "chain", "params": {"n_matrices": 3, "lo": 1024, "hi": 2048, "seed": 0}},
                {"family": "gram", "params": {"size": 1024, "seed": 0}})
ACTIVE_GRID = ("--chains", "0", "--families", "distributive,solve,kernel_variants", "--kernel-sites", "matmul",
               "--kernel-native", "--sizes", "256,512", "--per-size", "2", "--shards", "2")
ORACLE_SERVE_TIMEOUT = 300  # seconds for `oracle serve --refresh` to drain its misses
#: phase 14: the model stack and the serving engine. Logits of the card
#: against the CPU's are held to SMOKE_TOL * (1 + max|cpu|); decode against
#: the forward to the reference's 5e-2 relative bound; gather against dense
#: at full width to the bf16 tolerance elementwise
SMOKE_TOL = 2e-4
DECODE_REL = 5e-2
SMOKE_SHAPE = (2, 24)                  # batch, sequence (the reference's decode-consistency test)
FULL_ARCHS = ("qwen2-moe-a2.7b", "mamba2-1.3b")
CONSISTENCY_SHAPE = (2, 64)            # full width: batch, sequence
SERVE_SHAPE = (4, 128, 32)             # full width: batch, prompt, new tokens (greedy)
SMOKE_SERVE = (12, 10, 32)             # SMOKE graphs against eager: prompt, new tokens, max_len
SMOKE_RING_SERVE = (130, 8, 160)       # the same across a 128-slot ring's wrap (sliding-window configs)
MOE_SITE_SIZES = ({}, {"tokens": 1024, "d": 2048, "e": 60, "top_k": 4, "d_ff": 1408})
HBM_BYTES_PER_S = 3.35e12              # the H100 SXM sheet's memory rate
LAUNCHER = ("--arch", "qwen2-moe-a2.7b", "--device", "cuda", "--temperature", "0")
TRAIN_ARCHS = ("granite-moe-3b-a800m", "mamba2-1.3b")  # full width, bf16 (phase 15)
TRAIN_SHAPE = (4, 2048)                # global batch, sequence: 8192 tokens a step
TRAIN_STEPS = (1, 5)                   # warm-up steps, timed steps
TRAIN_SCHEDULE = (3e-4, 10, 100)       # cosine: peak lr and warm-up of the launcher's defaults, total steps
TRAIN_SMOKE_TOL = 1e-4                 # SMOKE f32 loss and grad norm, card against CPU: tol * (1 + |cpu|)
ELASTIC_TOL = 1e-5                     # resumed against uninterrupted losses: tol * (1 + |loss|)
TRAIN_LAUNCHER = ("--steps", "8", "--simulate-failure", "4:1")
ADAMW_BYTES_PER_PARAM = 28             # read master, m, v (f32) and the grad (bf16); write them and the param
DIST_ARCH = "granite-moe-3b-a800m"     # phase 16 (a): SMOKE, f32, through a plan on a (1, 1) mesh
DIST_SHAPE = (4, 64)                   # its global batch, sequence
DIST_TOL = 1e-5                        # planned against unsharded losses: tol * (1 + |loss|)
DRYRUN_CELLS = (                       # phase 16 (b): full width, rank 0's shard
    ("single", "granite-moe-3b-a800m", "train_4k"),
    ("single", "qwen2-moe-a2.7b", "decode_32k"),
    ("multi", "granite-moe-3b-a800m", "train_4k"),
)
DRYRUN_TIMEOUT = 600                   # seconds for one dry-run process
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


def eager_rank(rank_site, site, graph_report):
    """``rank_site`` again on the site's eager thunks (``graphs.eager_thunks``:
    one launch per operation, the yardstick of the graph thunks that the
    first ranking timed), in the same run; returns both routes' selected
    variant, single-run ms and verdict."""
    from repro_torch import graphs

    with graphs.eager_thunks():
        eager = rank_site(site)
    out = {}
    for route, report in (("graphs", graph_report), ("eager", eager)):
        out[route] = {"selected": report.selected,
                      "single_run_ms": {k_: t * 1e3 for k_, t in report.single_run_times.items()},
                      "verdict": report.discriminant.reason if report.discriminant.is_anomaly else "valid"}
    log(f"[routes] {site.name}: " + "; ".join(
        f"{route} selects {r['selected']} ({r['verdict']}), single-run ms "
        + ", ".join(f"{k_} {v:.4f}" for k_, v in r["single_run_ms"].items()) for route, r in out.items()))
    return out


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
            "routes": eager_rank(rank_site, site, report),
        }
    return out


def census_cli(args, device, timeout=CENSUS_TIMEOUT):
    """``python -m repro_torch <args> --device`` from the checkout, the way a
    user runs it; returns (seconds, stdout) and stops the script on a
    non-zero exit."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    extra = ["--device", device] if args[:2] in (["census", "run"], ["queue", "work"]) else []
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, "-m", "repro_torch", *args, *extra], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=timeout)
    seconds = time.perf_counter() - t0
    if out.returncode != 0:
        log(out.stdout[-4000:])
        log(out.stderr[-4000:])
        sys.exit(f"chip_smoke: `python -m repro_torch {' '.join(args + extra)}` exited {out.returncode}")
    return seconds, out.stdout


def cli_in_process(args, device):
    """The same command as :func:`census_cli` through
    ``repro_torch.launch.cli.main`` in this process (no interpreter or
    torch start-up); returns (seconds, stdout) and stops the script on a
    non-zero exit. For host-only verbs: ``census run`` would still spawn
    its workers."""
    import contextlib
    import io

    from repro_torch.launch import cli

    extra = ["--device", device] if args[:2] in (["census", "run"], ["queue", "work"]) else []
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = cli.main([*args, *extra])
    seconds = time.perf_counter() - t0
    if rc != 0:
        log(buf.getvalue()[-4000:])
        sys.exit(f"chip_smoke: `repro_torch {' '.join(args + extra)}` in process returned {rc}")
    return seconds, buf.getvalue()


def census_in_process(root, grid, device, predictor=None):
    """A host-only census planned by ``census plan`` and run to completion
    in this process by ``api.run_census`` (no worker processes); returns
    its seconds."""
    from repro_torch import api

    t0 = time.perf_counter()
    extra = ["--predictor", str(predictor)] if predictor else []
    cli_in_process(["census", "plan", "--out", str(root), "--backend", "cost_model", *extra, *grid], device)
    api.run_census(str(root), device=device)
    return time.perf_counter() - t0


def family_timer(sweep, family):
    """Per-family seconds of an in-process census: each family's workload
    builds and its timer's measurements (timed outside the measured region:
    ``WallClockTimer.measure_many`` is wrapped, the workloads are not). Returns
    the seconds by family and a function that undoes the wrapping."""
    secs = {}
    owner = {}
    patched = []
    for name in family.family_names():
        fam = family.get_family(name)

        def entry(inst, _orig=fam.entry, _name=name):
            flops, meta, build = _orig(inst)

            def timed_build(device):
                t0 = time.perf_counter()
                table = build(device)
                secs[_name] = secs.get(_name, 0.0) + time.perf_counter() - t0
                owner[id(table)] = _name
                return table

            return flops, meta, timed_build

        fam.entry = entry
        patched.append(fam)
    base = sweep.WallClockTimer

    class Timed(base):
        def __init__(self, workloads, *a, **kw):
            self.family = owner.pop(id(workloads), "?")
            super().__init__(workloads, *a, **kw)

        def measure_many(self, name, m):  # measure() calls it as well
            t0 = time.perf_counter()
            try:
                return super().measure_many(name, m)
            finally:
                secs[self.family] = secs.get(self.family, 0.0) + time.perf_counter() - t0

    sweep.WallClockTimer = Timed

    def undo():
        sweep.WallClockTimer = base
        for fam in patched:
            del fam.entry

    return secs, undo


def check_store(sweep, spec, root, what):
    """The merged store of a census on the card, by the repo's own means:
    every line passes its checksum, one record per instance of the grid,
    each record's metadata (FLOPs, kernels, size, dims, params) is the
    instance's own, every algorithm carries its timer's inner repeats, and
    every mean rank is finite. Returns the records."""
    lines = (Path(root) / "merged.jsonl").read_bytes().splitlines(keepends=True)
    records = []
    for line in lines:
        rec, status = sweep.parse_record_line(line)
        if status != sweep.LINE_OK:
            sys.exit(f"chip_smoke: {what}: a merged line is {status}")
        records.append(rec)
    grid = spec.expand()
    if [r["uid"] for r in records] != [i.uid for i in grid]:
        sys.exit(f"chip_smoke: {what}: {len(records)} records for {len(grid)} instances")
    for rec, inst in zip(records, grid):
        flops, meta, _ = sweep.instance_entry(inst)
        want = {"flops": {k: float(v) for k, v in flops.items()}, "kernels": meta["kernels"],
                "size": meta["size"], "dims": meta["dims"], "params": inst.params,
                "backend": "wall_clock", "family": inst.family}
        bad = [k for k, v in want.items() if rec[k] != v]
        if bad:
            sys.exit(f"chip_smoke: {what}: {inst.uid} differs from its instance in {bad}")
        if set(rec.get("inner_repeats", {})) != set(flops):
            sys.exit(f"chip_smoke: {what}: {inst.uid} lacks inner repeats for some algorithms")
        if not all(math.isfinite(v) for v in rec["mean_ranks"].values()):
            sys.exit(f"chip_smoke: {what}: {inst.uid} has a mean rank that is not finite")
    return records


def by_family(records, seconds):
    out = {}
    for rec in records:
        row = out.setdefault(rec["family"], {"instances": 0, "anomalies": 0})
        row["instances"] += 1
        row["anomalies"] += int(rec["is_anomaly"])
    for fam, row in out.items():
        row["anomaly_rate"] = row["anomalies"] / row["instances"]
        if seconds is not None:
            row["seconds"] = seconds.get(fam)
    return out


def verdict_changes(first, second):
    """Instances whose verdict (anomaly or not, and its reason) differs
    between two passes of one grid, with both verdicts."""
    two = {r["uid"]: r for r in second}
    out = []
    for rec in first:
        other = two[rec["uid"]]
        a, b = (rec["is_anomaly"], rec["reason"]), (other["is_anomaly"], other["reason"])
        if a != b:
            out.append({"uid": rec["uid"], "first": rec["reason"], "second": other["reason"]})
    return out


def track_graphs(algorithms, graphs):
    """Weak references to every CUDA graph captured from now on by the chain
    algorithms (``algorithms.capture``) and by the measured thunks of the
    generalized families and the sites (``graphs.capture``); both are
    wrapped, the replays are not. Returns the two lists of references and
    a function that undoes the wrapping."""
    live = {"chain": [], "thunks": []}
    originals = {"chain": (algorithms, algorithms.capture), "thunks": (graphs, graphs.capture)}
    for key, (mod, capture) in originals.items():
        def tracked(fn, device, _capture=capture, _live=live[key]):
            replay = _capture(fn, device)
            _live.append(weakref.ref(replay))
            return replay

        mod.capture = tracked

    def undo():
        for mod, capture in originals.values():
            mod.capture = capture

    return live, undo


def hold_matmul_variants(torch, matmul_ref, sizes, device, phase):
    """Every variant of the ``kernel_variants`` matmul site at each of
    ``sizes``, on the inputs of seed 0 that a census instance of that size
    and seed gets. The hand GEMM's tiles are held at the f32 tolerance
    against the exact product (``matmul_ref``'s product taken in f64, then
    rounded once to f32): at K = 2048 ``matmul_ref``'s own f32 sum misses
    that tolerance against it, so a comparison with ``matmul_ref`` would
    count the plain version's rounding as the kernel's. The library
    baseline ``xla_dot`` is ``matmul_ref``'s own call and is held against
    it. The tiles' errors against ``matmul_ref`` and ``matmul_ref``'s
    against the exact product are recorded, not required. A disagreement
    ends the run. These launches are no path's: a path's count is reset
    before it runs. Returns the required checks and the recorded ones."""
    from repro_torch.core import family

    checks = Checks(torch, "a census matmul variant")
    recorded = Checks(torch, "recorded only")
    kv = family.get_family("kernel_variants")
    for size in sizes:
        site = kv._build_site("matmul", family._kernel_site_config("matmul", size), False, device)
        a, b = site.make_inputs(0)
        plain = matmul_ref(a, b)
        exact = (a.double() @ b.double()).float()
        recorded.hold(f"matmul_ref at {size}", plain, exact, TOL["float32"], f"matmul_ref {size}^3")
        for variant in site.variants:
            out = variant.build(a, b)()
            if variant.name == "xla_dot":
                checks.hold(variant.name, out, plain, TOL["float32"], f"census matmul {size}^3 xla_dot")
                continue
            checks.hold(variant.name, out, exact, TOL["float32"], f"census matmul {size}^3 {variant.name}")
            recorded.hold(f"{variant.name} against matmul_ref at {size}", out, plain, TOL["float32"],
                          f"census matmul {size}^3 {variant.name} against matmul_ref")
        del a, b, plain, exact, out
    checks.stop_if_failed(phase)
    return checks, recorded


def phase_census(torch, kmod, matmul_ref, launches, work, device="cuda", default_grid=(), lane=KERNEL_LANE,
                 lane_sizes=KERNEL_LANE_SIZES):
    """Phase 11: the census on the card, both grids, two passes each (see
    the module docstring). ``default_grid`` and ``lane`` are the grid flags
    of the two censuses (the default grid: none); the stores go under
    ``work``. Returns the phase's record and the roots of the two CLI
    stores; the hand GEMM's launches in the in-process lane join
    ``launches`` as ``census[kernel_variants]``."""
    from repro_torch import graphs
    from repro_torch.core import family, sweep
    from repro_torch.expressions import algorithms
    from repro_torch.launch.report_md import census_tables

    work = Path(work)
    keep = OUT.parent / "census"
    keep.mkdir(parents=True, exist_ok=True)
    out = {"device_tf32": {"allow_tf32_matmul": torch.backends.cuda.matmul.allow_tf32,
                           "float32_matmul_precision": torch.get_float32_matmul_precision()}}

    # the port's cost-model census on this host against the golden store
    golden = ROOT / "tests" / "golden" / "census_small.jsonl"
    spec = sweep.SweepSpec(name="census", n_shards=4, backend="cost_model", max_measurements=12, families={
        "chain": {"count": 8, "n_matrices": [3, 4], "lo": 24, "hi": 96},
        **{f: {"sizes": [24, 40], "per_size": 2} for f in ("gram", "distributive", "solve", "bilinear")}})
    for shard in range(spec.n_shards):
        sweep.run_shard(spec, str(work / "golden"), shard, device=device)
    out["golden_store_identical"] = Path(sweep.write_merged(spec, str(work / "golden"))).read_bytes() \
        == golden.read_bytes()
    log(f"[11 census] cost-model census against {golden.relative_to(ROOT)}: identical "
        f"{out['golden_store_identical']}")
    if not out["golden_store_identical"]:
        sys.exit("chip_smoke: the port's cost-model census differs from the golden store")

    # pass 1 through the CLI: (a) the default grid, (b) the kernel lane
    passes = {"default": {}, "kernel_lane": {}}
    d1, d2 = work / "default_cli", work / "lane_cli"
    secs, _ = census_cli(["census", "run", "--out", str(d1), "--workers", "1", "--backend", "wall_clock",
                          *default_grid], device)
    census_cli(["census", "merge", "--out", str(d1)], device)
    _, report = census_cli(["census", "report", "--out", str(d1)], device)
    spec_a = sweep.SweepSpec.load(str(d1 / "spec.json"))
    rec_a1 = check_store(sweep, spec_a, d1, "the default census (CLI)")
    passes["default"]["cli"] = {"seconds": secs, "by_family": by_family(rec_a1, None),
                                "anomalies": sum(r["is_anomaly"] for r in rec_a1), "instances": len(rec_a1)}
    shutil.copy(d1 / "merged.jsonl", keep / "default_cli.jsonl")
    log(f"[11 census] default grid by `census run` on wall clock: {len(rec_a1)} instances in {secs:.1f} s, "
        f"{passes['default']['cli']['anomalies']} anomalies; by family {passes['default']['cli']['by_family']}")
    log("    " + report.strip().replace("\n", "\n    "))

    # the hand GEMM's census variants against matmul_ref before the lane runs
    checks, recorded = hold_matmul_variants(torch, matmul_ref, lane_sizes, device, "phase 11")
    log(f"[11 census] kernel lane's matmul variants at {lane_sizes} (tiles against the exact product, xla_dot "
        f"against matmul_ref): {checks.n} checks, max_abs_err {checks.errs}, share of the f32 tolerance "
        f"{checks.used}; recorded: share {recorded.used}")
    out["matmul_variants"] = {"max_abs_err": checks.errs, "tolerance_used": checks.used,
                              "recorded_tolerance_used": recorded.used}

    census_cli(["census", "plan", "--out", str(d2), *lane], device)
    secs, _ = census_cli(["queue", "work", "--out", str(d2)], device)
    census_cli(["census", "merge", "--out", str(d2)], device)
    _, report = census_cli(["census", "report", "--out", str(d2)], device)
    spec_b = sweep.SweepSpec.load(str(d2 / "spec.json"))
    rec_b1 = check_store(sweep, spec_b, d2, "the kernel lane (CLI)")
    passes["kernel_lane"]["cli"] = {"seconds": secs, "by_family": by_family(rec_b1, {"kernel_variants": secs}),
                                    "anomalies": sum(r["is_anomaly"] for r in rec_b1), "instances": len(rec_b1)}
    shutil.copy(d2 / "merged.jsonl", keep / "kernel_lane_cli.jsonl")
    log(f"[11 census] kernel lane by `census plan` + `queue work`: {len(rec_b1)} instances in {secs:.1f} s, "
        f"{passes['kernel_lane']['cli']['anomalies']} anomalies")
    log("    " + report.strip().replace("\n", "\n    "))

    # pass 2 in this process, eager: the generalized families of the default
    # grid and the kernel lane on eager thunks (graphs.eager_thunks), the
    # yardstick of the graph thunks that every other pass times
    eager = {}
    eager_specs = (("default", dataclasses.replace(
        spec_a, families={f: g for f, g in spec_a.families.items() if f != "chain"})), ("kernel_lane", spec_b))
    for key, spec_ in eager_specs:
        root = work / f"{key}_eager"
        fam_secs, undo = family_timer(sweep, family)
        before = kmod.matmul_kernel.launches
        t0 = time.perf_counter()
        try:
            with graphs.eager_thunks():
                for shard in range(spec_.n_shards):
                    sweep.run_shard(spec_, str(root), shard, device=device)
        finally:
            undo()
        if key == "kernel_lane":
            launches["census[kernel_variants, eager]"] = kmod.matmul_kernel.launches - before
        sweep.write_merged(spec_, str(root))
        eager[key] = {"records": check_store(sweep, spec_, root, f"the {key} census on eager thunks"),
                      "seconds": time.perf_counter() - t0, "family_seconds": fam_secs}
        log(f"[11 census] {key} on eager thunks in process: {len(eager[key]['records'])} instances in "
            f"{eager[key]['seconds']:.1f} s; by family {by_family(eager[key]['records'], fam_secs)}")

    # pass 3 in this process: the same specs through run_shard, fresh stores
    in_process = {}
    for key, spec_, first in (("default", spec_a, rec_a1), ("kernel_lane", spec_b, rec_b1)):
        root = work / f"{key}_in_process"
        fam_secs, undo = family_timer(sweep, family)
        if key == "kernel_lane":
            reset_gemm_counts(kmod)
        graphs_live, untrack = track_graphs(algorithms, graphs)
        allocated = torch.cuda.memory_allocated() if device == "cuda" else 0
        t0 = time.perf_counter()
        try:
            for shard in range(spec_.n_shards):
                sweep.run_shard(spec_, str(root), shard, device=device)
        finally:
            undo()
            untrack()
        secs = time.perf_counter() - t0
        # The graphs go with their instances: none may outlive the pass.
        refs = graphs_live["chain"] + graphs_live["thunks"]
        alive = sum(ref() is not None for ref in refs)
        gc.collect()
        alive_after_gc = sum(ref() is not None for ref in refs)
        memory = {"captured_graphs": {k_: len(v) for k_, v in graphs_live.items()}, "alive_after_pass": alive,
                  "alive_after_gc": alive_after_gc, "allocated_before": allocated,
                  "allocated_after": torch.cuda.memory_allocated() if device == "cuda" else 0}
        passes[key]["graphs"] = memory
        log(f"[11 census] {key} in process: CUDA graphs captured {memory['captured_graphs']}, alive after the "
            f"pass {alive}, after gc {alive_after_gc}; torch.cuda.memory_allocated() {memory['allocated_before']} "
            f"B before, {memory['allocated_after']} B after")
        if alive_after_gc:
            sys.exit(f"chip_smoke: {alive_after_gc} CUDA graphs of the {key} census outlived their instances")
        if key == "default" and device == "cuda" and not graphs_live["chain"]:
            sys.exit("chip_smoke: the default census's chain family captured no CUDA graph")
        if device == "cuda" and not graphs_live["thunks"]:
            sys.exit(f"chip_smoke: the {key} census's measured thunks captured no CUDA graph")
        if key == "kernel_lane":
            launches["census[kernel_variants]"] = kmod.matmul_kernel.launches
        sweep.write_merged(spec_, str(root))
        second = check_store(sweep, spec_, root, f"the {key} census (in process)")
        census_tables(second, name=spec_.name)
        changed = verdict_changes(first, second)
        in_process[key] = second
        passes[key]["in_process"] = {
            "seconds": secs, "by_family": by_family(second, fam_secs),
            "anomalies": sum(r["is_anomaly"] for r in second), "instances": len(second)}
        passes[key]["verdict_changes"] = {"count": len(changed), "instances": changed}
        shutil.copy(root / "merged.jsonl", keep / f"{key}_in_process.jsonl")
        log(f"[11 census] {key} in process: {len(second)} instances in {secs:.1f} s, "
            f"{passes[key]['in_process']['anomalies']} anomalies; by family "
            f"{passes[key]['in_process']['by_family']}; verdicts that differ from the CLI pass: {len(changed)}")
    # graphs against eager thunks: the verdicts that change, by family and size
    for key, run in eager.items():
        graph_recs = [r for r in in_process[key] if r["family"] != "chain"]
        graph_secs = passes[key]["in_process"]["by_family"]
        changed = verdict_changes(graph_recs, run["records"])
        sizes = {r["uid"]: (r["family"], r["size"]) for r in graph_recs}
        by_size = {}
        for c in changed:
            fam, size = sizes[c["uid"]]
            by_size.setdefault(f"{fam} {size}", []).append(c)
        passes[key]["graphs_against_eager"] = {
            "instances": len(graph_recs), "verdict_changes": len(changed), "by_family_and_size": by_size,
            "anomalies": {"graphs": sum(r["is_anomaly"] for r in graph_recs),
                          "eager": sum(r["is_anomaly"] for r in run["records"])},
            "seconds": {"graphs": {f: v.get("seconds") for f, v in graph_secs.items() if f != "chain"},
                        "eager": dict(run["family_seconds"])}}
        log(f"[11 census] {key}, graph thunks against eager thunks: {len(changed)} of {len(graph_recs)} verdicts "
            f"change ({ {k_: len(v) for k_, v in by_size.items()} }); anomalies "
            f"{passes[key]['graphs_against_eager']['anomalies']}; seconds by family "
            f"{passes[key]['graphs_against_eager']['seconds']}")
    if not launches.get("census[kernel_variants]"):
        sys.exit("chip_smoke: the census's kernel lane launched no GEMM kernel")
    log(f"[11 census] GEMM kernel launches in the in-process kernel lane: {launches['census[kernel_variants]']}")
    out.update(passes)
    summary = {grid: {p_: {k_: v[k_] for k_ in ("instances", "anomalies", "seconds")}
                      for p_, v in rows.items() if p_ not in ("verdict_changes", "graphs", "graphs_against_eager")}
               | {"verdict_changes": rows["verdict_changes"]["count"]} for grid, rows in passes.items()}
    log("[11 census] summary " + json.dumps(summary))
    return out, {"default": d1, "kernel_lane": d2}


def explain_store_bytes(root):
    """An explain store's files, the timing sidecars (wall seconds) left out."""
    return {f.name: f.read_bytes() for f in sorted(Path(root).iterdir())
            if f.is_file() and not f.name.endswith("timings.json")}


def phase_explain(torch, kmod, launches, stores, work, device="cuda", knobs=EXPLAIN_KNOBS,
                  calibrate=CALIBRATE):
    """Phase 12: explain on the card (see the module docstring). ``stores``
    are the CLI census roots of phase 11, ``knobs`` the explain campaign's
    flags, ``calibrate`` the calibration's. Returns the phase's record; the
    hand GEMM's launches in the in-process explanation of the kernel lane
    join ``launches`` as ``explain[kernel_variants]``."""
    from collections import Counter

    from repro_torch.explain import CAUSES, runner

    work = Path(work)
    keep = OUT.parent / "explain"
    keep.mkdir(parents=True, exist_ok=True)
    out = {"knobs": list(knobs)}

    cal = work / "machine.json"
    secs, _ = census_cli(["explain", "calibrate", "--backend", "wall_clock", "--out-file", str(cal),
                          "--device", device, *calibrate], device)
    doc = json.loads(cal.read_text())
    out["calibration"] = {"seconds": secs, "dispatch_s": doc["fit"]["dispatch_s"], "r2": doc["fit"]["r2"],
                          "median_s_by_size": {p_["n"]: p_["t_median"] for p_ in doc["points"]},
                          "efficiency_by_size": {p_["n"]: p_["efficiency"] for p_ in doc["points"]},
                          "machine": doc["machine"]}
    shutil.copy(cal, keep / "machine.json")
    log(f"[12 explain] calibrate --backend wall_clock ({' '.join(calibrate)}) in {secs:.1f} s: dispatch "
        f"{doc['fit']['dispatch_s'] * 1e6:.3f} us, r2 {doc['fit']['r2']:.4f}; median us by ladder size "
        + ", ".join(f"{p_['n']}: {p_['t_median'] * 1e6:.2f}" for p_ in doc["points"]))

    roots = {}
    for key, census in stores.items():
        root = work / f"explain_{key}"
        args = ["explain", "run", "--census", str(census), "--out", str(root), "--workers", "1",
                "--machine-file", str(cal), "--device", device, *knobs]
        secs, _ = census_cli(args, device)
        first = explain_store_bytes(root)
        again, _ = census_cli(args, device)
        if explain_store_bytes(root) != first:
            sys.exit(f"chip_smoke: a second `explain run` of the {key} census changed its store")
        census_cli(["explain", "merge", "--out", str(root)], device)
        _, report = census_cli(["explain", "report", "--out", str(root)], device)
        rows = [json.loads(line) for line in (root / "merged.jsonl").read_text().splitlines()]
        census_rows = [json.loads(line) for line in (Path(census) / "merged.jsonl").read_text().splitlines()]
        anomalies = [r["uid"] for r in census_rows if r["is_anomaly"]]
        if [r["uid"] for r in rows] != anomalies:
            sys.exit(f"chip_smoke: the {key} explanations are not the census's {len(anomalies)} anomalies "
                     f"in order ({len(rows)} rows)")
        bad = [r["uid"] for r in rows if r["cause"] not in CAUSES or not 0.0 <= float(r["evidence"]) <= 1.0]
        if bad:
            sys.exit(f"chip_smoke: {key} explanations with a cause outside CAUSES or evidence outside "
                     f"[0, 1]: {bad}")
        unexplained = [{k_: r[k_] for k_ in ("uid", "reason", "winner", "loser", "gap_rel", "evidence",
                                              "components")}
                       for r in rows if r["cause"] == "unexplained"]
        out[key] = {"seconds": secs, "rerun_seconds": again, "anomalies": len(rows),
                    "by_cause": dict(Counter(r["cause"] for r in rows)), "unexplained": unexplained,
                    "by_family_cause": dict(Counter(f"{r['family']}/{r['cause']}" for r in rows))}
        shutil.copy(root / "merged.jsonl", keep / f"{key}.jsonl")
        roots[key] = root
        log(f"[12 explain] {key}: {len(rows)} anomalies explained by `explain run` in {secs:.1f} s (the "
            f"rerun, a no-op, {again:.1f} s); by cause {out[key]['by_cause']}; unexplained "
            f"{len(unexplained)}")
        for row in unexplained:
            log(f"    unexplained {row['uid']} ({row['reason']}): {row['winner']} vs {row['loser']}, gap "
                f"{100 * row['gap_rel']:.1f} %, components {row['components']}")
        log("    " + report.strip().replace("\n", "\n    "))

    # The kernel lane again, in this process, with the GEMM's launches counted.
    espec = runner.ExplainSpec.load(str(roots["kernel_lane"] / runner.SPEC_FILE))
    root = work / "explain_lane_in_process"
    root.mkdir()
    espec.save(str(root / runner.SPEC_FILE))
    census = runner.explain_targets(espec)
    reset_gemm_counts(kmod)
    t0 = time.perf_counter()
    for shard in range(espec.n_shards):
        runner.run_explain_shard(espec, str(root), shard, census=census, device=device)
    secs = time.perf_counter() - t0
    launches["explain[kernel_variants]"] = kmod.matmul_kernel.launches
    runner.write_merged_explained(espec, str(root))
    first = {r["uid"]: r["cause"] for r in runner.merge_explained(espec, str(roots["kernel_lane"]))}
    second = {r["uid"]: r["cause"] for r in runner.merge_explained(espec, str(root))}
    changed = sorted(u for u in first if first[u] != second.get(u))
    out["kernel_lane_in_process"] = {"seconds": secs, "gemm_launches": launches["explain[kernel_variants]"],
                                     "by_cause": dict(Counter(second.values())), "causes_that_differ": changed}
    log(f"[12 explain] kernel lane in process: {len(second)} anomalies in {secs:.1f} s, by cause "
        f"{out['kernel_lane_in_process']['by_cause']}; GEMM kernel launches {launches['explain[kernel_variants]']}; "
        f"causes that differ from the CLI pass: {len(changed)}")
    if not launches["explain[kernel_variants]"]:
        sys.exit("chip_smoke: the kernel lane's explanation launched no GEMM kernel")
    return out



def read_jsonl(path):
    return [json.loads(line) for line in Path(path).read_text().splitlines() if line.strip()]


def write_jsonl(path, rows):
    Path(path).write_text("".join(json.dumps(r, sort_keys=True) + "\n" for r in rows))


def oracle_query(cache, queries, path, device, run=cli_in_process):
    """``oracle query --batch`` (by ``run``: in this process, or
    ``census_cli``): the verdicts of ``queries`` (written to ``path``.jsonl
    first) in order, and the command's seconds."""
    batch = Path(f"{path}.queries.jsonl")
    write_jsonl(batch, queries)
    secs, _ = run(["oracle", "query", "--out", str(cache), "--batch", str(batch),
                   "--json", f"{path}.verdicts.jsonl"], device)
    verdicts = read_jsonl(f"{path}.verdicts.jsonl")
    if len(verdicts) != len(queries):
        sys.exit(f"chip_smoke: {len(queries)} oracle queries gave {len(verdicts)} verdicts")
    return verdicts, secs


def require_confidence(verdicts, confidence, what, enqueued=None):
    bad = [v["uid"] for v in verdicts if v["confidence"] != confidence
           or (enqueued is not None and v["enqueued"] != enqueued)]
    if bad:
        sys.exit(f"chip_smoke: {what}: {len(bad)} verdicts are not {confidence}"
                 f"{'' if enqueued is None else f' with enqueued {enqueued}'}: {bad[:8]}")


def pending_misses(cache):
    """(enqueued, still pending) misses of an oracle cache, read from its files."""
    from repro_torch.serve.cache import OracleCache

    totals, pendings = OracleCache.open(str(cache)).miss_totals()
    return sum(totals), sum(pendings)


def serve_refresh(cache, first, second, misses, work, device, timeout=ORACLE_SERVE_TIMEOUT):
    """``oracle serve --refresh`` with its queries on a FIFO (``--queries``):
    ``first`` goes in, then the script waits until the refresher (a thread
    of the serve process, draining on ``device``) has measured the
    ``misses`` enqueued misses, then ``second`` goes in and the FIFO is
    closed. Returns the verdicts, the hit rate the server printed and its
    seconds; a refresh pass that failed, or a drain that does not end within
    ``timeout`` seconds, stops the script."""
    import errno

    fifo = Path(work) / "serve_queries.fifo"
    os.mkfifo(fifo)
    stdout, stderr = Path(work) / "serve.stdout", Path(work) / "serve.stderr"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    cmd = [sys.executable, "-m", "repro_torch", "oracle", "serve", "--out", str(cache), "--queries", str(fifo),
           "--refresh", "--poll", "0.5", "--reload-every", "1", "--device", device]
    t0 = time.perf_counter()
    with open(stdout, "w") as out, open(stderr, "w") as err:
        proc = subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=out, stderr=err)
    try:
        deadline = time.time() + timeout
        while True:  # the writer's end opens once the server has opened the reader's
            try:
                fd = os.open(fifo, os.O_WRONLY | os.O_NONBLOCK)
                break
            except OSError as e:
                if e.errno != errno.ENXIO or proc.poll() is not None or time.time() > deadline:
                    raise
                time.sleep(0.05)
        os.set_blocking(fd, True)
        with os.fdopen(fd, "w") as feed:
            feed.write("".join(json.dumps(q) + "\n" for q in first))
            feed.flush()
            while True:
                total, pending = pending_misses(cache)
                if total >= misses and not pending:
                    break
                if proc.poll() is not None or time.time() > deadline:
                    log(stderr.read_text()[-4000:])
                    sys.exit(f"chip_smoke: `oracle serve --refresh` measured {total - pending} of {misses} "
                             f"misses before {'it exited' if proc.poll() is not None else 'the deadline'}")
                time.sleep(0.25)
            feed.write("".join(json.dumps(q) + "\n" for q in second))
        rc = proc.wait(timeout=timeout)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    seconds = time.perf_counter() - t0
    errors = stderr.read_text()
    if rc != 0 or "refresh pass failed" in errors:
        log(errors[-4000:])
        sys.exit(f"chip_smoke: `oracle serve --refresh` exited {rc} or a refresh pass failed")
    verdicts = read_jsonl(stdout)
    served = re.search(r"# served (\d+) verdicts: hit rate ([0-9.]+)", errors)
    if len(verdicts) != len(first) + len(second) or served is None:
        sys.exit(f"chip_smoke: `oracle serve` answered {len(verdicts)} of {len(first) + len(second)} queries")
    return verdicts, float(served.group(2)), seconds


def phase_oracle(torch, kmod, matmul_ref, launches, stores, explains, work, card, device="cuda", default_grid=(),
                 active_grid=ACTIVE_GRID, miss_sizes=ORACLE_MISS_SIZES, serve_misses=SERVE_MISSES):
    """Phase 13: the ranking oracle and the learned cost model on the card
    (see the module docstring). ``stores`` and ``explains`` are the CLI
    census and explain roots of phases 11 and 12, ``default_grid`` the
    default census's grid flags (none), ``active_grid`` the active
    wall-clock census's, ``miss_sizes`` the kernel lane's miss sizes and
    ``serve_misses`` the misses fed to ``oracle serve``. Returns the phase's
    record; the hand GEMM's launches in the in-process miss drain and in the
    active census's measured branch join ``launches`` as
    ``oracle[kernel_variants]`` and ``active_census[kernel_variants]``, and
    their counts by copy width are the record's ``launches_by_copy``."""
    from collections import Counter

    from repro_torch import api
    from repro_torch.core.sweep import SweepSpec
    from repro_torch.launch import queue as qmod
    from repro_torch.serve.oracle import hit_rate

    work = Path(work)
    keep = OUT.parent / "oracle"
    keep.mkdir(parents=True, exist_ok=True)
    out = {"launches_by_copy": {}}

    def say(msg):
        log(f"[13 oracle] {msg} [{card}]")

    # 1. warm from both CLI censuses and their explanations; every grid
    #    instance answers `measured`, equal to its census record
    caches = {}
    for key, census in stores.items():
        # one CLI call per verb (the default grid's); the rest in this process
        run = census_cli if key == "default" else cli_in_process
        cache = work / f"oracle_{key}"
        secs, warm = run(["oracle", "warm", "--out", str(cache), "--census", str(census),
                          "--explain", str(explains[key])], device)
        records = read_jsonl(Path(census) / "merged.jsonl")
        causes = {r["uid"]: r["cause"] for r in read_jsonl(Path(explains[key]) / "merged.jsonl")}
        verdicts, qsecs = oracle_query(cache, [{"family": r["family"], "params": r["params"]} for r in records],
                                       work / f"grid_{key}", device, run)
        require_confidence(verdicts, "measured", f"the {key} grid")
        bad = [r["uid"] for v, r in zip(verdicts, records)
               if v["uid"] != r["uid"] or v["ranks"] != r["ranks"] or v["is_anomaly"] != r["is_anomaly"]
               or (r["is_anomaly"] and v["cause"] != causes.get(r["uid"]))]
        if bad:
            sys.exit(f"chip_smoke: {key} verdicts that differ from the census record or its cause: {bad[:8]}")
        caches[key] = cache
        out[f"warm_{key}"] = {"how": run.__name__, "warm_seconds": secs, "query_seconds": qsecs,
                              "queries": len(verdicts),
                              "hit_rate": hit_rate(verdicts), "anomalies": sum(v["is_anomaly"] for v in verdicts),
                              "entries": warm.strip()}
        say(f"{key} ({run.__name__}): {warm.strip()[2:]} in {secs:.1f} s; {len(verdicts)} grid queries by "
            f"`oracle query --batch` in {qsecs:.1f} s, all measured and equal to the census (ranks, verdict, "
            f"cause), hit rate {hit_rate(verdicts):.2f}, {out[f'warm_{key}']['anomalies']} anomalies")

    # 2. kernel-lane misses on the hand GEMM: model_only and enqueued, drained
    #    by `queue work`, then measured; the same misses on a second cache
    #    warmed from the same stores, drained by the same entry point in this
    #    process with the GEMM's launches counted
    misses = [{"family": "kernel_variants", "params": {"site": "matmul", "size": size, "seed": 0, "interpret": False}}
              for size in miss_sizes]
    checks, recorded = hold_matmul_variants(torch, matmul_ref, miss_sizes, device, "phase 13")
    out["miss_matmul_variants"] = {"max_abs_err": checks.errs, "tolerance_used": checks.used,
                                   "recorded_tolerance_used": recorded.used}
    say(f"kernel-lane miss sizes' matmul variants at {list(miss_sizes)} (tiles against the exact product, "
        f"xla_dot against matmul_ref): {checks.n} checks, max_abs_err {checks.errs}, share of the f32 "
        f"tolerance {checks.used}; recorded: share {recorded.used}")
    drains = {}
    for how in ("cli", "in_process"):
        lane = caches["kernel_lane"]
        if how == "in_process":
            lane = work / "oracle_kernel_lane_in_process"
            cli_in_process(["oracle", "warm", "--out", str(lane), "--census", str(stores["kernel_lane"]),
                            "--explain", str(explains["kernel_lane"])], device)
        first, _ = oracle_query(lane, misses, work / f"miss_{how}", device)
        require_confidence(first, "model_only", f"kernel-lane misses ({how})", enqueued=True)
        if how == "cli":
            secs, _ = census_cli(["queue", "work", "--out", str(lane)], device)
        else:
            reset_gemm_counts(kmod)
            t0 = time.perf_counter()
            if qmod.main(["work", "--out", str(lane), "--device", device]) != 0:
                sys.exit("chip_smoke: the in-process `queue work` of the oracle's misses failed")
            secs = time.perf_counter() - t0
            launches["oracle[kernel_variants]"] = kmod.matmul_kernel.launches
            out["launches_by_copy"]["oracle[kernel_variants]"] = dict(kmod.matmul_kernel.launches_by_copy)
        again, _ = oracle_query(lane, misses, work / f"miss_{how}_again", device)
        require_confidence(again, "measured", f"kernel-lane misses after `queue work` ({how})", enqueued=False)
        total, pending = pending_misses(lane)
        _, status = (census_cli if how == "cli" else cli_in_process)(["oracle", "status", "--out", str(lane)],
                                                                     device)
        if pending or total != len(misses) or f"{total} misses enqueued, 0 pending" not in status:
            sys.exit(f"chip_smoke: the kernel lane's cache has pending misses after `queue work`:\n{status}")
        drains[how] = {"seconds": secs, "ranks": {str(m["params"]["size"]): v["ranks"] for m, v in zip(misses, again)},
                       "is_anomaly": [v["is_anomaly"] for v in again]}
        say(f"kernel-lane misses {list(miss_sizes)} (matmul, seed 0): model_only and enqueued, drained by "
            f"{'`queue work`' if how == 'cli' else 'queue.main([work]) in this process'} in {secs:.1f} s, then "
            f"measured with nothing pending; ranks {drains[how]['ranks']}")
    drains["misses"] = [m["params"] for m in misses]
    out["kernel_lane_misses"] = drains
    if not launches.get("oracle[kernel_variants]"):
        sys.exit("chip_smoke: the oracle's miss drain launched no GEMM kernel")
    say(f"GEMM kernel launches in the in-process miss drain: {launches['oracle[kernel_variants]']}")

    # 3. `oracle serve --refresh` on the default cache: grid queries and
    #    misses (a chain miss among them: a CUDA graph captured in the
    #    refresher's thread), the misses asked again once refreshed
    records = read_jsonl(Path(stores["default"]) / "merged.jsonl")
    grid = [{"family": r["family"], "params": r["params"]} for r in records[::20]]
    first = grid[: len(grid) // 2] + list(serve_misses) + grid[len(grid) // 2:]
    second = grid[:1] + list(serve_misses)  # the first query makes the server reload its cache
    verdicts, rate, secs = serve_refresh(caches["default"], first, second, len(serve_misses), work, device)
    require_confidence(verdicts[len(first) + 1:], "measured", "the misses refreshed by `oracle serve`")
    missed = [v for v in verdicts[: len(first)] if v["enqueued"]]
    if len(missed) != len(serve_misses):
        sys.exit(f"chip_smoke: `oracle serve` enqueued {len(missed)} of {len(serve_misses)} misses")
    out["serve"] = {"seconds": secs, "queries": len(verdicts), "hit_rate_printed": rate,
                    "first_pass": [v["confidence"] for v in verdicts[: len(first)]],
                    "misses": [m["params"] for m in serve_misses]}
    say(f"`oracle serve --refresh` on the default cache: {len(verdicts)} queries in {secs:.1f} s, hit rate "
        f"printed {rate:.2f}; {len(serve_misses)} misses ({', '.join(m['family'] for m in serve_misses)}) refreshed "
        f"by its refresher thread on the card and answered measured afterwards")

    # 4. predict on the default grid: a cost_model census on this host, the
    #    model trained and evaluated on it, and an active census that keeps
    #    exactly the full census's anomaly set
    full, active, model = work / "predict_full", work / "predict_active", work / "model.json"
    secs_full = census_in_process(full, default_grid, device)
    _, trained = census_cli(["predict", "train", "--census", str(full), "--out", str(model)], device)
    _, table = cli_in_process(["predict", "eval", "--census", str(full), "--model", str(model)], device)
    secs_active = census_in_process(active, default_grid, device, predictor=model)
    doc = json.loads(model.read_text())
    full_rows, active_rows = read_jsonl(full / "merged.jsonl"), read_jsonl(active / "merged.jsonl")
    anomalies = sorted(r["uid"] for r in full_rows if r["is_anomaly"])
    if [r["uid"] for r in active_rows] != [r["uid"] for r in full_rows] \
            or sorted(r["uid"] for r in active_rows if r["is_anomaly"]) != anomalies:
        sys.exit("chip_smoke: the active cost_model census does not keep the full census's anomaly set")
    n_pred = sum(r.get("provenance") == "predicted" for r in active_rows)
    out["predict_cost_model"] = {"rows": doc["n_train"], "residual_sigma": doc["residual_sigma"],
                                 "digest": doc["train_digest"], "instances": len(full_rows),
                                 "anomalies": len(anomalies), "predicted": n_pred,
                                 "measured": len(active_rows) - n_pred, "full_seconds": secs_full,
                                 "active_seconds": secs_active}
    shutil.copy(model, keep / "model_cost_model.json")
    say(f"predict train on the default grid's cost_model census: {trained.strip()[2:]}")
    log("    " + table.strip().replace("\n", "\n    "))
    say(f"active cost_model census of the default grid: {n_pred} predicted, {len(active_rows) - n_pred} measured "
        f"of {len(active_rows)}; the full census's {len(anomalies)} anomalies kept exactly; {secs_active:.1f} s "
        f"against {secs_full:.1f} s for the full census (both planned and run in this process)")

    # 5. an active wall-clock census on the card, gated by a model trained
    #    with --machine cpu-1core on a cost_model census of the same grid
    cm, cpu_model = work / "active_grid_cost_model", work / "model_cpu_1core.json"
    census_in_process(cm, active_grid, device)
    _, trained = cli_in_process(["predict", "train", "--census", str(cm), "--out", str(cpu_model),
                                 "--machine", "cpu-1core"], device)
    runs = {}
    for key, extra in (("active", ["--predictor", str(cpu_model)]), ("full", [])):
        root = work / f"wall_clock_{key}"
        secs, _ = census_cli(["census", "run", "--out", str(root), "--workers", "1", "--backend", "wall_clock",
                              *extra, *active_grid], device)
        rows = read_jsonl(root / "merged.jsonl")
        predicted = [r for r in rows if r.get("provenance") == "predicted"]
        runs[key] = {"seconds": secs, "instances": len(rows), "predicted": len(predicted),
                     "measured": len(rows) - len(predicted),
                     "predicted_by_family": dict(Counter(r["family"] for r in predicted)),
                     "anomalies": sum(r["is_anomaly"] for r in rows)}
    act = runs["active"]
    kv_predicted = act["predicted_by_family"].get("kernel_variants", 0)
    if not act["predicted"] or not act["measured"] or kv_predicted:
        sys.exit(f"chip_smoke: the active wall-clock census predicted {act['predicted']} and measured "
                 f"{act['measured']} ({kv_predicted} kernel_variants predicted); both branches must run and "
                 "the GEMM's tiles be measured")
    spec = SweepSpec.load(str(work / "wall_clock_active" / "spec.json"))
    reset_gemm_counts(kmod)
    t0 = time.perf_counter()
    api.run_census(str(work / "wall_clock_active_in_process"), spec, device=device)
    secs = time.perf_counter() - t0
    launches["active_census[kernel_variants]"] = kmod.matmul_kernel.launches
    out["launches_by_copy"]["active_census[kernel_variants]"] = dict(kmod.matmul_kernel.launches_by_copy)
    rows = read_jsonl(work / "wall_clock_active_in_process" / "merged.jsonl")
    n_pred = sum(r.get("provenance") == "predicted" for r in rows)
    if n_pred != act["predicted"] or not launches["active_census[kernel_variants]"]:
        sys.exit(f"chip_smoke: the in-process active census predicted {n_pred} (the CLI's {act['predicted']}) "
                 f"and launched {launches['active_census[kernel_variants]']} GEMM kernels")
    runs["active_in_process"] = {"seconds": secs, "predicted": n_pred, "measured": len(rows) - n_pred,
                                 "gemm_launches": launches["active_census[kernel_variants]"]}
    out["active_wall_clock"] = {"grid": list(active_grid), "model": trained.strip(), **runs}
    say(f"model for the gate: {trained.strip()[2:]}")
    say(f"active wall-clock census ({' '.join(active_grid)}): {act['predicted']} predicted "
        f"({act['predicted_by_family']}), {act['measured']} measured on the card in {act['seconds']:.1f} s; the "
        f"full wall-clock census of the same grid {runs['full']['seconds']:.1f} s; in process (api.run_census) "
        f"{secs:.1f} s with {launches['active_census[kernel_variants]']} GEMM kernel launches in the measured branch")

    # 6. the learned tier: a cache warmed with the cpu-1core model answers a
    #    kernel-lane miss `learned_model` and still enqueues it
    learned = work / "oracle_learned"
    cli_in_process(["oracle", "warm", "--out", str(learned), "--census", str(stores["kernel_lane"]),
                    "--model", str(cpu_model)], device)
    miss = {"family": "kernel_variants",
            "params": {"site": "matmul", "size": miss_sizes[0], "seed": 2, "interpret": False}}
    (verdict,), _ = oracle_query(learned, [miss], work / "learned", device)
    require_confidence([verdict], "learned_model", "the learned tier's miss", enqueued=True)
    if not {"flip_prob", "model_confidence"} <= set(verdict) or pending_misses(learned) != (1, 1):
        sys.exit(f"chip_smoke: the learned tier's verdict lacks flip_prob/model_confidence or was not enqueued: "
                 f"{verdict}")
    out["learned"] = {k_: verdict[k_] for k_ in ("flip_prob", "model_confidence", "ranks", "is_anomaly")}
    say(f"learned tier: kernel-lane miss {miss['params']} answered learned_model, flip_prob "
        f"{verdict['flip_prob']}, model_confidence {verdict['model_confidence']}, enqueued")
    return out


def smoke_on_card(torch, T, cfg, dev):
    """One SMOKE config (f32) on the card against the same parameters on
    the CPU: the forward's logits (held), decode consistency on the card
    (the reference's test: prefill s-1 tokens and decode one, or whisper's
    four decode steps, against the forward's logits; held), and the decoded
    logits of the card against the CPU's (recorded). Returns the record."""
    b, s = SMOKE_SHAPE
    rng = np.random.default_rng(1)
    to_dev = functools.partial(T.layers.tree_map, lambda x: x.to(dev))
    steps = {}
    if cfg.is_encoder_decoder:
        cpu, _ = T.init_encdec_params(cfg, seed=0, device="cpu")
        card = to_dev(cpu)
        enc = torch.from_numpy(0.02 * rng.standard_normal((b, cfg.encoder_seq, cfg.d_model)).astype(np.float32))
        dec = torch.from_numpy(rng.integers(0, cfg.vocab_size, (b, 8)))
        ref, _ = T.encdec_forward(cfg, cpu, enc, dec)
        out, _ = T.encdec_forward(cfg, card, enc.to(dev), dec.to(dev))
        for where, params in (("cpu", cpu), ("card", card)):
            d_ = torch.device(where if where == "cpu" else dev)
            st = T.encdec_prefill(cfg, params, T.init_encdec_state(cfg, b, 16, cfg.encoder_seq, device=d_),
                                  enc.to(d_))
            for t_ in range(4):
                steps[where], st = T.encdec_decode_step(cfg, params, st, dec[:, t_: t_ + 1].to(d_), t_)
        full = out[:, 3]
    else:
        cpu, _ = T.init_lm_params(cfg, seed=0, device="cpu")
        card = to_dev(cpu)
        tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (b, s)))
        if cfg.frontend == "vision_stub":
            patches = torch.from_numpy(0.02 * rng.standard_normal((b, 8, cfg.d_model)).astype(np.float32))
            merged = T.merge_vision_embeds(cfg, T.layers.embed_tokens(cfg, cpu["embed"], tokens), patches)
            ref, _ = T.lm_forward(cfg, cpu, embeds=merged)
            out, _ = T.lm_forward(cfg, card, embeds=merged.to(dev))
            # the reference's test decodes after a prefill of the plain embeddings
            plain = T.layers.embed_tokens(cfg, card["embed"], tokens.to(dev))
            full = T.lm_forward(cfg, card, embeds=plain)[0][:, s - 1]
        else:
            ref, _ = T.lm_forward(cfg, cpu, tokens=tokens)
            out, _ = T.lm_forward(cfg, card, tokens=tokens.to(dev))
            full = out[:, s - 1]
        for where, params in (("cpu", cpu), ("card", card)):
            d_ = torch.device(where if where == "cpu" else dev)
            prompt = {"tokens": tokens[:, : s - 1].to(d_)}
            if cfg.frontend == "vision_stub":
                prompt = {"embeds": T.layers.embed_tokens(cfg, params["embed"], tokens.to(d_))[:, : s - 1]}
            _, st = T.lm_prefill(cfg, params, T.init_lm_state(cfg, b, s + 8, device=d_), **prompt)
            steps[where], _ = T.lm_decode_step(cfg, params, st, tokens[:, s - 1: s].to(d_), s - 1)
    err = float((out.cpu() - ref).abs().max())
    rel = float((steps["card"] - full).abs().max() / (full.abs().max() + 1e-9))
    rec = {"max_abs_err": err, "share_of_tolerance": err / (SMOKE_TOL * (1 + float(ref.abs().max()))),
           "decode_rel_err": rel, "decode_share_of_bound": rel / DECODE_REL,
           "decode_max_abs_err_vs_cpu": float((steps["card"].cpu() - steps["cpu"]).abs().max())}
    if not cfg.is_encoder_decoder:
        rec["graph_tokens"] = smoke_graph_tokens(torch, cfg, card, dev)
    return rec


def smoke_graph_tokens(torch, cfg, params, dev):
    """The serving engine's greedy tokens on CUDA graphs against its eager
    route (``graphs=False``), one SMOKE config on the card: batch 2, a
    12-token prompt and 10 new tokens, or, for a config with a sliding
    window, a 130-token prompt that fills its 128-slot ring in two segments
    and 8 new tokens written across the wrap (max_len 160). Returns the
    record; ``equal`` is held by the caller."""
    from repro_torch.serve import ServingEngine

    s, n, max_len = SMOKE_RING_SERVE if cfg.sliding_window else SMOKE_SERVE
    prompts = torch.from_numpy(np.random.default_rng(2).integers(0, cfg.vocab_size, (2, s))).to(dev)
    out = {route: ServingEngine(cfg, params, max_len=max_len, device=dev, graphs=route == "graphs")
           .generate(prompts, n) for route in ("graphs", "eager")}
    return {"prompt": s, "new_tokens": n, "max_len": max_len,
            "equal": bool(torch.equal(out["graphs"], out["eager"]))}


def decode_weight_bytes(cfg, params, batch):
    """Bytes of the weights one decode step reads: every parameter once,
    except an untied embedding table, of which the step gathers ``batch``
    rows. Every expert is counted: at decode each group holds one token, so
    each expert has 4 slots and its GEMMs run whether or not a slot is
    filled (the gather dispatch's capacity)."""
    from repro_torch.models.layers import tree_leaves

    total = sum(x.numel() * x.element_size() for x in tree_leaves(params))
    if not cfg.tie_embeddings:
        table = params["embed"]["table"]
        total -= (table.shape[0] - batch) * table.shape[1] * table.element_size()
    return total


def profile_step(torch, call, top=0):
    """``call()`` once under ``torch.profiler``: the kernels it launched,
    their summed device time and the span from the first kernel's start to
    the last one's end (device ms), the host's ms for the call, and the
    ``top`` kernel names by summed device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        call()
        host_ms = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not kernels:
        return {"kernels": 0, "device_busy_ms": "not measured (no device events traced)", "host_ms": host_ms}
    busy = sum(e.time_range.elapsed_us() for e in kernels) / 1e3
    span = (max(e.time_range.end for e in kernels) - min(e.time_range.start for e in kernels)) / 1e3
    by_name = {}
    for e in kernels:
        ms, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (ms + e.time_range.elapsed_us() / 1e3, n + 1)
    heaviest = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top]
    return {"kernels": len(kernels), "device_busy_ms": busy, "device_span_ms": span,
            "device_idle_share_of_span": 1 - busy / span if span else 0.0, "host_ms_profiled": host_ms,
            **({"top_kernels_ms_count": [[name[:90], ms, n] for name, (ms, n) in heaviest]} if top else {})}


def serve_full_width(torch, T, engine_cls, cfg, dev, say):
    """One arch at full width in bf16, weights drawn on the card from seed 0:
    decode consistency, gather against dense on the first MoE sublayer's
    input (MoE archs), ``ServingEngine.generate`` twice (greedy) and once
    more for the prefill alone, the decode step's host and device cost.
    Returns the record."""
    from repro_torch.models import moe as moe_mod

    rec = {}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params, _ = T.init_lm_params(cfg, seed=0, device=dev)
    torch.cuda.synchronize()
    rec["init_seconds"] = time.perf_counter() - t0
    rec["param_bytes"] = sum(x.numel() * x.element_size() for x in T.layers.tree_leaves(params))
    gen = torch.Generator(device=dev).manual_seed(1)

    # decode consistency; the first MoE sublayer's input is kept for gather =
    # dense. With the config's capacity factor the forward at t = s may drop
    # the last token's assignments, which decode (t = 1: 4 slots an expert)
    # keeps, so the held check runs with no assignment dropped anywhere
    # (capacity factor E / top_k) and the config's own factor is recorded
    # (the reference computes the same function; ROADMAP Queue 3)
    b, s = CONSISTENCY_SHAPE
    tokens = torch.randint(0, cfg.vocab_size, (b, s), generator=gen, device=dev)
    first_moe, real = [], moe_mod._gather_groups

    def spy(cfg_, params_, x):
        if not first_moe:
            first_moe.append((params_, x.clone()))
        return real(cfg_, params_, x)

    no_drops = cfg.replace(moe_capacity_factor=cfg.n_experts / cfg.top_k) if cfg.is_moe else cfg
    rec["decode_consistency"] = {"shape": [b, s]}
    for key, cfg_ in (("held", no_drops), ("recorded", cfg))[: 2 if cfg.is_moe else 1]:
        moe_mod._gather_groups = spy
        try:
            logits, _ = T.lm_forward(cfg_, params, tokens=tokens)
        finally:
            moe_mod._gather_groups = real
        _, st = T.lm_prefill(cfg_, params, T.init_lm_state(cfg_, b, s + 8, device=dev), tokens=tokens[:, : s - 1])
        step, _ = T.lm_decode_step(cfg_, params, st, tokens[:, s - 1:], s - 1)
        full = logits[:, s - 1]
        rel = float((step - full).abs().max() / (full.abs().max() + 1e-9))
        rec["decode_consistency"][key] = {"capacity_factor": cfg_.moe_capacity_factor if cfg.is_moe else None,
                                          "rel_err": rel, "share_of_bound": rel / DECODE_REL}
        del logits, st, step, full
        say(f"decode consistency at b {b}, s {s}"
            + (f", capacity factor {cfg_.moe_capacity_factor:g} ({key})" if cfg.is_moe else "")
            + f": rel err {rel:.3e} ({rel / DECODE_REL:.3f} of {DECODE_REL})")
        if key == "held" and rel >= DECODE_REL:
            sys.exit(f"chip_smoke: {cfg.name} at full width: decode relerr {rel} >= {DECODE_REL}")
    if cfg.is_moe:
        mp, x = first_moe[0]
        x2d = x.reshape(-1, cfg.d_model)
        gathered, _ = T.moe_gather(no_drops, mp, x2d)  # capacity = T: nothing dropped
        dense, _ = T.moe_dense(no_drops, mp, x2d)
        checks = Checks(torch, "moe_gather against moe_dense")
        checks.hold("gather", gathered, dense, TOL["bfloat16"], f"{cfg.name} first MoE sublayer")
        rec["gather_vs_dense"] = {"tokens": x2d.shape[0], "capacity_factor": no_drops.moe_capacity_factor,
                                  "max_abs_err": checks.errs["gather"], "share_of_tolerance": checks.used["gather"],
                                  "tolerance": TOL["bfloat16"]}
        say(f"moe_gather = moe_dense on the first MoE sublayer's input ({x2d.shape[0]} tokens, capacity factor "
            f"{no_drops.moe_capacity_factor:g}): max_abs_err {checks.errs['gather']:.3e}, "
            f"{checks.used['gather']:.3f} of the bf16 tolerance")
        checks.stop_if_failed("phase 14, gather against dense")
        del first_moe, mp, x, x2d, gathered, dense

    # serving: batch, prompt, new tokens (greedy), on CUDA graphs (the
    # engine's default on the card) and on eager launches, in this run
    b, sp, n = SERVE_SHAPE
    prompts = torch.randint(0, cfg.vocab_size, (b, sp), generator=gen, device=dev)
    weight_bytes = decode_weight_bytes(cfg, params, b)
    bound_ms = weight_bytes / HBM_BYTES_PER_S * 1e3
    routes, outputs = {}, {}
    for route in ("graphs", "eager"):
        routes[route], outputs[route] = serve_route(torch, engine_cls, cfg, params, prompts, n, dev, route,
                                                    bound_ms)
        r = routes[route]
        say(f"{route}: generate b {b}, prompt {sp}, {n} new (greedy): "
            + " / ".join(f"{x:.1f}" for x in r["generate_ms"]) + f" ms; prefill {r['prefill_ms'][1]:.2f} ms; "
            f"decode {r['decode_ms_per_step']:.3f} ms a step against a {bound_ms:.3f} ms weight-stream bound "
            f"({weight_bytes / 1e9:.3f} GB at {HBM_BYTES_PER_S / 1e12:.2f} TB/s; {r['decode_share_of_bound']:.3f}); "
            f"{r['tokens_per_s']:.1f} tokens/s end to end, {r['decode_tokens_per_s']:.1f} in decode; capture "
            f"{r['capture_seconds']:.2f} s; peak memory {r['max_memory_allocated_bytes'] / 2**30:.2f} GiB "
            f"({r['peak_above_params_bytes'] / 2**30:.2f} above the weights); tokens equal across the two runs: "
            f"{r['tokens_equal_across_runs']}; last logits {r['last_logits_share_of_tolerance']:.3f} of the bf16 "
            f"tolerance")
        say(f"{route}: decode step alone: host {r['step_host_ms']:.3f} ms to issue, device "
            f"{r['step_device_ms']:.3f} ms; profiled: {r['step_profile']}")
    (tok_g, last_g), (tok_e, last_e) = outputs["graphs"], outputs["eager"]
    checks = Checks(torch, "the graph route's last logits against the eager route's")
    checks.hold("last_logits", last_g, last_e, TOL["bfloat16"], f"{cfg.name} graphs against eager")
    same = bool(torch.equal(tok_g, tok_e))
    rec["serve"] = {
        "batch": b, "prompt": sp, "new_tokens": n, "greedy": True, "decode_weight_bytes": weight_bytes,
        "decode_bound_ms": bound_ms, "bound_by": "bytes", "head_f32_transient_bytes": cfg.vocab_size * cfg.d_model * 4,
        **routes,
        "graphs_against_eager": {"tokens_equal": same, "last_logits_max_abs_err": checks.errs["last_logits"],
                                 "last_logits_share_of_tolerance": checks.used["last_logits"],
                                 "decode_speedup": routes["eager"]["decode_ms_per_step"]
                                 / routes["graphs"]["decode_ms_per_step"]},
    }
    say(f"graphs against eager: tokens equal {same}; last logits max_abs_err {checks.errs['last_logits']:.3e} "
        f"({checks.used['last_logits']:.3f} of the bf16 tolerance); decode "
        f"{rec['serve']['graphs_against_eager']['decode_speedup']:.2f}x faster on graphs")
    checks.stop_if_failed("phase 14, graphs against eager")
    if not same:
        sys.exit(f"chip_smoke: {cfg.name}: the graph route's greedy tokens differ from the eager route's")
    if not routes["graphs"]["tokens_equal_across_runs"]:
        sys.exit(f"chip_smoke: {cfg.name}: a second graph generation gave other tokens")
    return rec


def serve_route(torch, engine_cls, cfg, params, prompts, n, dev, route, bound_ms):
    """``ServingEngine.generate`` on one route (``graphs``: the decode step
    and the prefill captured as CUDA graphs; ``eager``: ``graphs=False``):
    the buffers and captures (timed), two generations and two prefills alone
    (CUDA events; the two generations' last logits held to each other), then
    the decode step alone after a fresh prefill: host ms to issue it, device
    ms, a profiled step. Returns (record, (tokens, last logits))."""
    b, sp = prompts.shape
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    engine = engine_cls(cfg, params, max_len=sp + n + 8, device=dev, graphs=route == "graphs")
    t0 = time.perf_counter()
    slot = engine.slot(b)
    prompt_buf, prefill = engine.prefill(slot, sp)
    torch.cuda.synchronize()
    capture_s = time.perf_counter() - t0

    def timed(n_new):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        start.record()
        out = engine.generate(prompts, n_new)
        end.record()
        torch.cuda.synchronize()
        return out, start.elapsed_time(end), (time.perf_counter() - t0) * 1e3, engine.last_logits.clone()

    runs = [timed(n), timed(n)]
    prefill_runs = [timed(1), timed(1)]
    (out_a, ms_a, _, last_a), (out_b, ms_b, wall_b, last_b) = runs
    checks = Checks(torch, "two generations' last logits")
    checks.hold("last_logits", last_b, last_a, TOL["bfloat16"], f"{cfg.name} {route}: generate twice")
    checks.stop_if_failed(f"phase 14, {route}: generate twice")
    if out_b.shape != (b, sp + n) or int(out_b.min()) < 0 or int(out_b.max()) >= cfg.vocab_size:
        sys.exit(f"chip_smoke: {cfg.name} generated {tuple(out_b.shape)} tokens outside the vocabulary")
    prefill_ms = prefill_runs[1][1]
    decode_ms = (ms_b - prefill_ms) / (n - 1)

    # the decode step alone, after a fresh prefill (positions sp .. sp + 5)
    prompt_buf.copy_(prompts)
    prefill()
    host, device = [], []
    for _ in range(5):
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        slot.decode()
        end.record()
        host.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
        device.append(start.elapsed_time(end))
    profiled = profile_step(torch, slot.decode, top=8 if route == "graphs" else 0)
    rec = {
        "capture_seconds": capture_s if route == "graphs" else 0.0,
        "generate_ms": [ms_a, ms_b], "generate_wall_ms": wall_b, "prefill_ms": [p_[1] for p_ in prefill_runs],
        "decode_ms_per_step": decode_ms, "tokens_per_s": b * n / (ms_b / 1e3),
        "decode_tokens_per_s": b / (decode_ms / 1e3), "decode_share_of_bound": bound_ms / decode_ms,
        "tokens_equal_across_runs": bool(torch.equal(out_a, out_b)),
        "last_logits_max_abs_err": checks.errs["last_logits"],
        "last_logits_share_of_tolerance": checks.used["last_logits"],
        "step_host_ms": sorted(host)[2], "step_device_ms": sorted(device)[2], "step_profile": profiled,
        "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
        "peak_above_params_bytes": torch.cuda.max_memory_allocated() - base,
    }
    return rec, (out_a, last_a)


def phase_models(torch, kmod, fmod, smod, card, device="cuda", archs=None, full_archs=FULL_ARCHS,
                 site_sizes=MOE_SITE_SIZES, launcher=LAUNCHER):
    """Phase 14: the model stack and the serving engine on the card (see the
    module docstring). Returns the record; the three hand kernels' launch
    counters over the phase are its ``kernel_launches`` and must read 0."""
    import repro_torch.models as T
    from repro_torch.autotune import moe_dispatch_site, rank_site
    from repro_torch.configs import ARCH_NAMES, get_config
    from repro_torch.serve import ServingEngine

    def say(msg):
        log(f"[14 models] {msg} [{card}]")

    dev = torch.device(device)
    reset_gemm_counts(kmod)
    fmod.reset_counts()
    smod.ssd_scan_kernel.launches = 0
    out = {"smoke": {}, "full": {}, "moe_dispatch_site": {}, "seconds": {}}

    # 1. every SMOKE config, f32, on the card against the CPU
    t0 = time.perf_counter()
    for arch in archs or ARCH_NAMES:
        rec = smoke_on_card(torch, T, get_config(arch, smoke=True), dev)
        out["smoke"][arch] = rec
        say(f"{arch} SMOKE f32: logits max|cuda - cpu| {rec['max_abs_err']:.3e} ({rec['share_of_tolerance']:.3f} "
            f"of {SMOKE_TOL} x (1 + max|cpu|)); decode consistency on the card {rec['decode_rel_err']:.3e} "
            f"({rec['decode_share_of_bound']:.3f} of {DECODE_REL}); decoded logits max|cuda - cpu| "
            f"{rec['decode_max_abs_err_vs_cpu']:.3e} (recorded)")
    bad = [a for a, r in out["smoke"].items() if r["share_of_tolerance"] > 1 or r["decode_share_of_bound"] >= 1]
    if bad:
        sys.exit(f"chip_smoke: SMOKE configs whose card logits or decode disagree: {bad}")
    graph_tokens = {a: r["graph_tokens"] for a, r in out["smoke"].items() if "graph_tokens" in r}
    say(f"SMOKE f32 serving engine, greedy tokens on CUDA graphs against eager launches: {graph_tokens}")
    bad = [a for a, r in graph_tokens.items() if not r["equal"]]
    if bad:
        sys.exit(f"chip_smoke: SMOKE configs whose graph tokens differ from the eager tokens: {bad}")
    out["seconds"]["smoke"] = time.perf_counter() - t0

    # 2-3. full width, bf16
    for arch in full_archs:
        t0 = time.perf_counter()
        out["full"][arch] = serve_full_width(torch, T, ServingEngine, get_config(arch), dev,
                                             lambda msg, a=arch: say(f"{a} FULL bf16: {msg}"))
        gc.collect()
        torch.cuda.empty_cache()
        out["seconds"][arch] = time.perf_counter() - t0

    # 4. the MoE-dispatch site through rank_site
    t0 = time.perf_counter()
    for kwargs in site_sizes:
        site = moe_dispatch_site(**kwargs, device=device)
        report = rank_site(site)
        log("[14 models] " + report.summary().replace("\n", "\n    "))
        out["moe_dispatch_site"][site.name] = {
            "kwargs": kwargs, "ranks": report.ranking.ranks, "selected": report.selected,
            "single_run_ms": {k_: t_ * 1e3 for k_, t_ in report.single_run_times.items()},
            "dropped": list(report.dropped), "flops": site.flops_table(),
            "verdict": report.discriminant.reason if report.discriminant.is_anomaly else "valid",
            "routes": eager_rank(rank_site, site, report),
        }
        del site
    out["seconds"]["moe_dispatch_site"] = time.perf_counter() - t0

    # the three hand kernels were launched by none of the above
    out["kernel_launches"] = {"gemm": kmod.matmul_kernel.launches,
                              "flash_attention": fmod.flash_attention_kernel.launches,
                              "ssd": smod.ssd_scan_kernel.launches}
    say(f"hand-kernel launches over the phase's in-process steps: {out['kernel_launches']}")
    if any(out["kernel_launches"].values()):
        sys.exit(f"chip_smoke: the model path launched a hand kernel: {out['kernel_launches']}")

    # 5. the serving launcher, as a user runs it
    if launcher:
        env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
        t0 = time.perf_counter()
        run = subprocess.run([sys.executable, "-m", "repro_torch.launch.serve", *launcher], cwd=ROOT, env=env,
                             capture_output=True, text=True, timeout=300)
        out["launcher"] = {"argv": list(launcher), "rc": run.returncode, "stdout": run.stdout.strip(),
                           "seconds": time.perf_counter() - t0}
        say(f"python -m repro_torch.launch.serve {' '.join(launcher)}: exit {run.returncode} in "
            f"{out['launcher']['seconds']:.1f} s; " + run.stdout.strip().replace("\n", "; "))
        if run.returncode != 0:
            log(run.stderr[-4000:])
            sys.exit(f"chip_smoke: the serving launcher exited {run.returncode}")
    return out


def train_full_width(torch, T, cfg, dev, peak, say, work):
    """One arch at full width in bf16 (not cut), weights drawn on the card
    from seed 0, trained through ``ElasticTrainer`` with AdamW on a cosine
    schedule, ``remat="full"`` and the launcher's attention: the warm-up and
    timed steps (each step's loss), the optimizer's device time beside its
    byte bound, peak memory against 14 bytes a parameter and one profiled
    step. No checkpoint is written (the state is tens of GB). Returns the
    record."""
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.train import AdamW, ElasticConfig, ElasticTrainer, HostMesh, cosine_schedule

    optimizer_events = []

    class TimedAdamW(AdamW):
        """AdamW whose updates are bracketed by CUDA events."""

        def update(self, *args, **kwargs):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            out = super().update(*args, **kwargs)
            end.record()
            optimizer_events.append((start, end))
            return out

    b, s = TRAIN_SHAPE
    warm, timed = TRAIN_STEPS
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    trainer = ElasticTrainer(
        cfg, TimedAdamW(schedule=cosine_schedule(*TRAIN_SCHEDULE)),
        SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=s, global_batch=b)),
        CheckpointManager(str(work / cfg.name)), HostMesh,
        opts=T.ForwardOptions(attn_impl="reference", remat="full"),
        elastic_cfg=ElasticConfig(checkpoint_every=10 ** 9), device=dev)
    t0 = time.perf_counter()
    trainer.start(n_hosts=1, init_params_fn=lambda: T.init_lm_params(cfg, seed=0, device=dev)[0])
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    state = trainer.state
    n_params = sum(x.numel() for x in T.layers.tree_leaves(state.params))
    state_bytes = sum(x.numel() * x.element_size() for tree in (state.params, *state.opt[1:])
                      for x in T.layers.tree_leaves(tree))
    del state
    history, step_ms = [], []
    for _ in range(warm + timed):
        t0 = time.perf_counter()
        history += trainer.run(1)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
    optimizer_ms = [start.elapsed_time(end) for start, end in optimizer_events]
    peak_bytes = torch.cuda.max_memory_allocated()
    profiled = profile_step(torch, lambda: trainer.run(1), top=8)
    del trainer
    gc.collect()
    torch.cuda.empty_cache()

    losses = [h["loss"] for h in history]
    tokens = b * s
    median_ms = sorted(step_ms[warm:])[timed // 2]
    model_flops = T.training_flops(cfg, b, s)
    dense_flops = 6.0 * T.param_counts(cfg).active * tokens
    opt_median = sorted(optimizer_ms[warm:])[timed // 2]
    opt_bound_ms = ADAMW_BYTES_PER_PARAM * n_params / peak["bytes_per_s"] * 1e3
    rec = {
        "batch": b, "seq": s, "tokens_per_step": tokens, "remat": "full", "attn_impl": "reference",
        "schedule": list(TRAIN_SCHEDULE), "params": n_params, "state_bytes": state_bytes,
        "init_seconds": init_s, "losses": losses, "grad_norms": [h["grad_norm"] for h in history],
        "ln_vocab": math.log(cfg.vocab_size), "step_ms": step_ms, "step_ms_median": median_ms,
        "tokens_per_s": tokens / (median_ms / 1e3),
        "model_tflop_per_step": model_flops / 1e12, "six_n_active_t_tflop": dense_flops / 1e12,
        "bf16_peak_share": model_flops / (median_ms / 1e3) / peak["bf16_flops"],
        "optimizer_ms": optimizer_ms, "optimizer_ms_median": opt_median,
        "optimizer_bound_ms": opt_bound_ms, "optimizer_bound_by": "bytes",
        "max_memory_allocated_bytes": peak_bytes,
        "predicted_bytes_14_per_param_plus_bf16_grads": 16 * n_params, "step_profile": profiled,
    }
    say(f"{n_params / 1e9:.3f} B parameters, state {state_bytes / 1e9:.2f} GB (init {init_s:.1f} s); "
        f"b {b} x s {s}, remat full, attention reference; losses {['%.4f' % x for x in losses]} "
        f"(ln V = {rec['ln_vocab']:.3f}), grad norms {['%.3f' % x for x in rec['grad_norms']]}")
    say(f"step {median_ms:.1f} ms (median of {timed}; all {['%.1f' % x for x in step_ms]}), "
        f"{rec['tokens_per_s']:.0f} tokens/s; {model_flops / 1e12:.2f} model TFLOP a step "
        f"(6 N_active T {dense_flops / 1e12:.2f}), {rec['bf16_peak_share']:.3f} of the bf16 peak; optimizer "
        f"{opt_median:.2f} ms against a {opt_bound_ms:.2f} ms byte bound ({ADAMW_BYTES_PER_PARAM} B a parameter); "
        f"peak memory {peak_bytes / 1e9:.2f} GB against {16 * n_params / 1e9:.2f} GB predicted "
        f"(14 B a parameter of state + bf16 grads); profiled step: "
        f"{ {k: v for k, v in profiled.items() if k != 'top_kernels_ms_count'} }")
    for name, ms, n in profiled.get("top_kernels_ms_count", []):
        say(f"  {ms:9.2f} ms in {n:5d} launches: {name}")
    if not all(math.isfinite(x) for x in losses) or not losses[-1] < losses[0]:
        sys.exit(f"chip_smoke: {cfg.name} at full width: losses not finite and decreasing: {losses}")
    if abs(losses[0] - rec["ln_vocab"]) > 0.15 * rec["ln_vocab"]:
        sys.exit(f"chip_smoke: {cfg.name}: first loss {losses[0]} is not near ln V = {rec['ln_vocab']}")
    return rec


def train_smoke_on_card(torch, T, train, data, cfg, dev):
    """One train step of a SMOKE config (f32) on the card and on the CPU from
    the same parameters and batch; returns both steps' loss and grad norm."""
    params_cpu, _ = T.init_lm_params(cfg, seed=0, device="cpu")
    params_card = T.layers.tree_map(lambda x: x.to(dev, copy=True), params_cpu)  # each step updates its own
    batch = data.SyntheticLM(data.DataConfig(vocab_size=cfg.vocab_size, seq_len=32, global_batch=4)).global_batch(0)
    opt = train.AdamW(schedule=train.cosine_schedule(*TRAIN_SCHEDULE))
    out = {}
    for where, params in (("cpu", params_cpu), ("card", params_card)):
        step = train.make_train_step(cfg, opt, T.ForwardOptions(attn_impl="reference"))
        _, metrics = step(train.init_train_state(cfg, opt, params), batch)
        out[where] = {k: float(metrics[k]) for k in ("loss", "grad_norm")}
    out["share_of_tolerance"] = max(abs(out["card"][k] - out["cpu"][k]) / (TRAIN_SMOKE_TOL * (1 + abs(out["cpu"][k])))
                                    for k in ("loss", "grad_norm"))
    return out


def elastic_on_card(torch, T, train, data, ckpt, dev, work):
    """The reference's membership-change sequence on the card (its system
    test's config, f32): 12 steps, a checkpoint every 4, the data width 4 ->
    2 before step 6; and the same 12 steps uninterrupted. Returns the record."""
    cfg = T.ModelConfig(name="sys-test", n_layers=4, d_model=64, n_heads=8, n_kv_heads=4,
                        d_ff=128, vocab_size=512, dtype="float32", param_dtype="float32")

    def run(name, events):
        trainer = train.ElasticTrainer(
            cfg, train.AdamW(schedule=train.cosine_schedule(1e-3, 2, 50)),
            data.SyntheticLM(data.DataConfig(vocab_size=512, seq_len=32, global_batch=8)),
            ckpt.CheckpointManager(str(work / name), keep=3), lambda n: train.HostMesh(data=n, model=2),
            opts=T.ForwardOptions(attn_impl="reference"), elastic_cfg=train.ElasticConfig(checkpoint_every=4),
            device=dev)
        trainer.start(n_hosts=4, init_params_fn=lambda: T.init_lm_params(cfg, seed=0, device=dev)[0])
        history = trainer.run(12, membership_events=events)
        return trainer, history

    trainer, history = run("elastic", {6: 2})
    _, straight = run("straight", {})
    losses, ref = [h["loss"] for h in history], [h["loss"] for h in straight]
    rec = {"steps": [h["step"] for h in history], "losses": losses, "uninterrupted_losses": ref,
           "data_width_after": trainer.mesh.shape["data"], "checkpoints": ckpt.all_steps(str(work / "elastic")),
           "bit_equal": losses == ref,
           "max_share_of_tolerance": max(abs(a - r) / (ELASTIC_TOL * (1 + abs(r))) for a, r in zip(losses, ref))}
    return rec


def phase_train(torch, kmod, fmod, smod, card, device="cuda", full_archs=TRAIN_ARCHS, archs=None,
                launcher=TRAIN_LAUNCHER):
    """Phase 15: training on the card (see the module docstring). Returns the
    record; the three hand kernels' launch counters over the phase are its
    ``kernel_launches``, recorded (the training path reaches no hand kernel)."""
    import repro_torch.checkpoint as ckpt
    import repro_torch.data as data
    import repro_torch.models as T
    import repro_torch.train as train
    from repro_torch.configs import ARCH_NAMES, get_config

    def say(msg):
        log(f"[15 train] {msg} [{card}]")

    dev = torch.device(device)
    peak = peaks(torch.cuda.get_device_name(0))
    reset_gemm_counts(kmod)
    fmod.reset_counts()
    smod.ssd_scan_kernel.launches = 0
    out = {"full": {}, "smoke": {}, "seconds": {}}
    work = Path(tempfile.mkdtemp(prefix="chip_smoke_train_"))

    # 1-2. full width, bf16
    for arch in full_archs:
        t0 = time.perf_counter()
        out["full"][arch] = train_full_width(torch, T, get_config(arch), dev, peak,
                                             lambda msg, a=arch: say(f"{a} FULL bf16: {msg}"), work)
        out["seconds"][arch] = time.perf_counter() - t0

    # 3. every LM arch's SMOKE config, f32, one step on the card against the CPU
    t0 = time.perf_counter()
    for arch in archs or ARCH_NAMES:
        cfg = get_config(arch, smoke=True)
        if cfg.is_encoder_decoder:
            continue
        rec = out["smoke"][arch] = train_smoke_on_card(torch, T, train, data, cfg, dev)
        say(f"{arch} SMOKE f32, one step: loss card {rec['card']['loss']:.7f} cpu {rec['cpu']['loss']:.7f}, "
            f"grad norm card {rec['card']['grad_norm']:.7f} cpu {rec['cpu']['grad_norm']:.7f} "
            f"({rec['share_of_tolerance']:.3f} of {TRAIN_SMOKE_TOL} x (1 + |cpu|))")
    bad = [a for a, r in out["smoke"].items() if r["share_of_tolerance"] > 1]
    if bad:
        sys.exit(f"chip_smoke: SMOKE train steps whose card loss or grad norm disagree with the CPU's: {bad}")
    out["seconds"]["smoke"] = time.perf_counter() - t0

    # 4. elastic: a membership change on the card, against an uninterrupted run
    t0 = time.perf_counter()
    rec = out["elastic"] = elastic_on_card(torch, T, train, data, ckpt, dev, work)
    say(f"elastic, 12 steps, data width 4 -> {rec['data_width_after']} before step 6: steps {rec['steps']}, "
        f"losses {['%.4f' % x for x in rec['losses']]}, checkpoints {rec['checkpoints']}; against the "
        f"uninterrupted run: bit-equal {rec['bit_equal']}, {rec['max_share_of_tolerance']:.3f} of {ELASTIC_TOL}")
    losses = rec["losses"]
    if (rec["steps"] != list(range(12)) or not all(math.isfinite(x) for x in losses)
            or not losses[-1] < losses[0] or rec["data_width_after"] != 2 or rec["max_share_of_tolerance"] > 1):
        sys.exit(f"chip_smoke: the elastic run on the card failed its checks: {rec}")
    out["seconds"]["elastic"] = time.perf_counter() - t0

    # 5. the hand kernels' counters over the in-process steps (recorded)
    out["kernel_launches"] = {"gemm": kmod.matmul_kernel.launches,
                              "flash_attention": fmod.flash_attention_kernel.launches,
                              "ssd": smod.ssd_scan_kernel.launches}
    say(f"hand-kernel launches over the phase's in-process steps: {out['kernel_launches']} (expected 0, 0, 0)")

    # 6. the training launcher, as a user runs it
    if launcher:
        env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
        argv = [*launcher, "--ckpt-dir", str(work / "launcher")]
        t0 = time.perf_counter()
        run = subprocess.run([sys.executable, "-m", "repro_torch.launch.train", *argv], cwd=ROOT, env=env,
                             capture_output=True, text=True, timeout=300)
        out["launcher"] = {"argv": argv, "rc": run.returncode, "stdout": run.stdout.strip(),
                           "seconds": time.perf_counter() - t0}
        say(f"python -m repro_torch.launch.train {' '.join(argv)}: exit {run.returncode} in "
            f"{out['launcher']['seconds']:.1f} s; " + run.stdout.strip().replace("\n", "; "))
        if run.returncode != 0:
            log(run.stderr[-4000:])
            sys.exit(f"chip_smoke: the training launcher exited {run.returncode}")
    shutil.rmtree(work)
    return out


def dist_train_on_card(torch, T, train, data, dist_mod, specs, compat, dev):
    """Phase 16 (a), the training half: the SMOKE config's two train steps
    unsharded and through a plan on the (1, 1) mesh (``make_plan``,
    ``tree_shardings``, the sharding fields of ``_sharding_opts`` set), from
    the same parameters and batches; returns both runs' losses."""
    from repro_torch.configs import get_config
    from repro_torch.configs.shapes import ShapeSpec

    cfg = get_config(DIST_ARCH, smoke=True)
    b, s = DIST_SHAPE
    mesh = compat.make_mesh((1, 1), ("data", "model"), dev.type)
    plan = dist_mod.make_plan(cfg, mesh, mode="train")
    shape = ShapeSpec("dist", s, b, "train")
    boundary, interior, attn_q, attn_kv, q_block, gqa_mode, notes = specs._sharding_opts(
        cfg, shape, mesh, plan, {}, training=True)
    planned = T.ForwardOptions(attn_impl="reference", remat="full", gqa_mode=gqa_mode,
                               boundary_sharding=boundary, interior_sharding=interior,
                               attn_q_sharding=attn_q, attn_kv_sharding=attn_kv, attn_q_block=q_block)
    if None in (boundary, interior, attn_q, attn_kv):
        sys.exit(f"chip_smoke: phase 16 expected every sharding field set on (1, 1), got {planned}")
    batches = [data.SyntheticLM(data.DataConfig(vocab_size=cfg.vocab_size, seq_len=s, global_batch=b)).global_batch(i)
               for i in range(2)]
    bsh = dist_mod.NamedSharding(mesh, dist_mod.batch_spec(mesh, b, 1))
    out = {"notes": notes, "fallbacks": list(plan.fallbacks)}
    for route in ("unsharded", "planned"):
        params, axes = T.init_lm_params(cfg, seed=0, device=dev)
        opts = T.ForwardOptions(attn_impl="reference", remat="full")
        if route == "planned":
            params = dist_mod.shard_tree(params, dist_mod.tree_shardings(plan, axes, params))
            opts = planned
        opt = train.AdamW(schedule=train.cosine_schedule(*TRAIN_SCHEDULE))
        state = train.init_train_state(cfg, opt, params)
        step = train.make_train_step(cfg, opt, opts)
        losses = []
        with compat.implicit_replication():
            for batch in batches:
                if route == "planned":
                    batch = {k: dist_mod.shard_tensor(torch.as_tensor(v, device=dev), bsh) for k, v in batch.items()}
                state, metrics = step(state, batch)
                loss = metrics["loss"]
                losses.append(float(loss.full_tensor() if hasattr(loss, "full_tensor") else loss))
        out[route] = losses
    out["share_of_tolerance"] = max(abs(p - u) / (DIST_TOL * (1 + abs(u)))
                                    for p, u in zip(out["planned"], out["unsharded"]))
    return out


def dryrun_cells(cells, work, device="cuda", extra=(), timeout=DRYRUN_TIMEOUT):
    """Phase 16 (b): each cell by ``python -m repro_torch.launch.dryrun`` in
    its own process, one after another (processes sharing the card would
    share its memory, and the fit loop would read another's use as its
    cell's); returns {cell: (row, seconds)}."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    rows = {}
    for mesh, arch, shape in cells:
        out = Path(work) / f"dryrun_{mesh}_{arch}_{shape}.json".replace(":", "_")
        argv = [sys.executable, "-m", "repro_torch.launch.dryrun", "--mesh", mesh, "--arch", arch,
                "--shape", shape, "--out", str(out), "--device", device, *extra]
        t0 = time.perf_counter()
        try:
            run = subprocess.run(argv, cwd=ROOT, env=env, capture_output=True, text=True, timeout=timeout)
        except subprocess.TimeoutExpired:
            sys.exit(f"chip_smoke: the dry run of {(mesh, arch, shape)} did not end in {timeout} s")
        log(run.stdout.strip())
        if run.returncode != 0 or not out.exists():
            log(run.stderr[-4000:])
            sys.exit(f"chip_smoke: the dry run of {(mesh, arch, shape)} exited {run.returncode}")
        (row,) = json.loads(out.read_text())
        rows[(mesh, arch, shape)] = (row, time.perf_counter() - t0)
    return rows


def phase_distributed(torch, kmod, fmod, smod, card, device="cuda", backend="nccl", cells=DRYRUN_CELLS,
                      dryrun_extra=()):
    """Phase 16: distributed and launch planning (see the module docstring).
    Returns the record; the three hand kernels' launch counters over part
    (a) are its ``kernel_launches``, recorded (the path reaches no hand
    kernel)."""
    import repro_torch.data as data
    import repro_torch.distributed as dist_mod
    import repro_torch.launch.compat as compat
    import repro_torch.launch.specs as specs
    import repro_torch.models as T
    import repro_torch.train as train

    def say(msg):
        log(f"[16 distributed] {msg} [{card}]")

    dev = torch.device(device)
    reset_gemm_counts(kmod)
    fmod.reset_counts()
    smod.ssd_scan_kernel.launches = 0
    out = {"seconds": {}}

    # (a) a world of one on the card's own backend
    t0 = time.perf_counter()
    compat.init_process_group(backend)
    try:
        rec = out["train"] = dist_train_on_card(torch, T, train, data, dist_mod, specs, compat, dev)
        say(f"{DIST_ARCH} SMOKE f32, two steps on (1, 1) {backend}: planned losses {rec['planned']}, "
            f"unsharded {rec['unsharded']} ({rec['share_of_tolerance']:.3f} of {DIST_TOL} x (1 + |loss|)); "
            f"notes {rec['notes']}")
        if rec["share_of_tolerance"] > 1:
            sys.exit(f"chip_smoke: planned training on (1, 1) disagrees with the unsharded steps: {rec}")
        gen = torch.Generator(device=dev).manual_seed(0)
        mesh1 = compat.make_mesh((1,), ("data",), dev.type)
        grads = {"w": torch.randn(256, 96, device=dev, generator=gen), "b": torch.randn(96, device=dev, generator=gen)}
        psum = dist_mod.compressed_psum(grads, "data", mesh1)
        exact = {k: dist_mod.dequantize_int8(dist_mod.quantize_int8(g)) for k, g in grads.items()}
        out["compressed_psum_equal"] = all(torch.equal(psum[k], exact[k]) for k in grads)
        stage = compat.make_mesh((1,), ("stage",), dev.type)
        w = torch.randn(1, 32, 32, device=dev, generator=gen) / math.sqrt(32)
        bias = torch.randn(1, 32, device=dev, generator=gen) * 0.1
        micro = torch.randn(6, 4, 32, device=dev, generator=gen)
        stage_fn = lambda p, x: torch.tanh(x @ p["w"] + p["b"])  # noqa: E731
        piped = dist_mod.pipeline_apply(stage_fn, {"w": w, "b": bias}, micro, stage)
        # the stage function on each microbatch in turn (one product over all
        # of them takes another GEMM kernel, which rounds otherwise)
        sequential = torch.stack([stage_fn({"w": w[0], "b": bias[0]}, x) for x in micro])
        out["pipeline_equal"] = bool(torch.equal(piped, sequential))
        say(f"compressed_psum = quantise-then-dequantise: {out['compressed_psum_equal']}; "
            f"pipeline_apply over one stage = the stage function: {out['pipeline_equal']}")
        if not (out["compressed_psum_equal"] and out["pipeline_equal"]):
            sys.exit("chip_smoke: compressed_psum or pipeline_apply disagrees on a world of one")
    finally:
        compat.destroy_process_group()
    out["kernel_launches"] = {"gemm": kmod.matmul_kernel.launches,
                              "flash_attention": fmod.flash_attention_kernel.launches,
                              "ssd": smod.ssd_scan_kernel.launches}
    say(f"hand-kernel launches over part (a): {out['kernel_launches']} (expected 0, 0, 0)")
    out["seconds"]["a"] = time.perf_counter() - t0

    # (b) the dry run at full width: rank 0's shard of each cell, one step
    t0 = time.perf_counter()
    work = Path(tempfile.mkdtemp(prefix="chip_smoke_dryrun_"))
    rows = dryrun_cells(cells, work, device=device, extra=dryrun_extra)
    out["dryrun"] = {}
    for (mesh, arch, shape), (row, seconds) in rows.items():
        keep = {k: row.get(k) for k in (
            "status", "mesh", "mem_per_dev_gb", "args_gb", "temp_gb", "hbm_budget_gb", "fit_attempts",
            "num_microbatches", "attention_strategy", "notes", "hlo_flops_per_dev", "model_flops",
            "collectives", "t_compute_s", "t_memory_s", "t_collective_s", "dominant", "roofline_fraction",
            "step_s", "error")}
        keep["seconds"] = seconds
        out["dryrun"][f"{arch} x {shape} x {row.get('mesh')}"] = keep
        say(f"dry run {arch} x {shape} x {row.get('mesh')}: {row['status']}, mem {row.get('mem_per_dev_gb')} GB "
            f"(args {row.get('args_gb')}, temp {row.get('temp_gb')}, budget {row.get('hbm_budget_gb')}), "
            f"fit attempts {row.get('fit_attempts')}, microbatches {row.get('num_microbatches')}, "
            f"FLOPs/dev {row.get('hlo_flops_per_dev')}, collective GB {row.get('collectives')}, "
            f"dominant {row.get('dominant')} (tc {row.get('t_compute_s')} tm {row.get('t_memory_s')} "
            f"tx {row.get('t_collective_s')}), {seconds:.1f} s")
        if not str(row["status"]).startswith("ok"):
            sys.exit(f"chip_smoke: the dry run of {arch} x {shape} x {mesh} ended {row['status']}: "
                     f"{row.get('error', '')}")
        if device == "cuda" and row.get("mem_per_dev_gb") is None:
            sys.exit(f"chip_smoke: the dry run of {arch} x {shape} x {mesh} measured no memory")
        if not float(row["hlo_flops_per_dev"]) > 0:
            sys.exit(f"chip_smoke: the dry run of {arch} x {shape} x {mesh} counted no FLOPs")
        if mesh == "multi" and not sum(row["collectives"].values()) > 0:
            sys.exit(f"chip_smoke: the 2x16x16 dry run of {arch} x {shape} moved no collective bytes")
    shutil.rmtree(work)
    out["seconds"]["b"] = time.perf_counter() - t0
    return out


def main():
    import torch

    marks = [("start", time.perf_counter())]  # phase boundaries: the script's seconds by phase

    def mark(phase):
        marks.append((phase, time.perf_counter()))

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
        build_algorithm_fn,
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

    mark("1 setup")
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

    mark("2 build")
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

    mark("3 kernel vs plain")
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

    mark("4 time")
    # ------------------------------------------------- 5. quickstart path --
    # Both GEMM routes, each with jit=True (the algorithm captured once as a
    # CUDA graph and replayed) and jit=False (eager launches), in one run.
    default_tile = kmod.DEFAULT_TILE
    hand_gemm = functools.partial(matmul, block_m=default_tile[0], block_n=default_tile[1],
                                  block_k=default_tile[2])
    launches = {}
    quickstart = {}
    launches_by_copy = {}
    replay_checks = Checks(torch, "a graph replay")
    for route, gemm in (("torch_matmul", torch.matmul), ("hand_gemm", hand_gemm)):
        for mode in ("graph", "eager"):
            path = f"quickstart[{route}]" if mode == "graph" else f"quickstart[{route}, eager]"
            path_launches = {"total": 0, **{w: 0 for w in kmod.COPY_WIDTHS}}
            for inst_name in INSTANCES:
                inst = get_instance(inst_name, smoke=False)
                algs = inst.algorithms()
                flops = flops_table(algs)
                rf = relative_flops(flops)
                mats = make_chain_inputs(inst.dims)
                t_start = time.perf_counter()
                workloads = build_workloads(algs, mats, jit=mode == "graph", gemm=gemm)
                if mode == "graph":
                    # Each graph against eager launches of the same steps
                    # (verify_algorithms' 1e-4), and the GEMM's counter against
                    # the launches each replay holds: 3 replays, 3 x steps.
                    # These calls do not count as the path's.
                    for alg in algs:
                        eager = build_algorithm_fn(alg, mats, jit=False, gemm=gemm)()
                        before = kmod.matmul_kernel.launches
                        for _ in range(3):
                            out = workloads[alg.name]()
                        counted = kmod.matmul_kernel.launches - before
                        want = 3 * len(alg.steps) if route == "hand_gemm" else 0
                        if counted != want:
                            sys.exit(f"chip_smoke: 3 replays of {inst_name} {alg.name} ({route}) counted "
                                     f"{counted} GEMM launches, not {want}")
                        replay_checks.hold(route, out, eager, 1e-4,
                                           f"{route} {inst_name} {alg.name} replay vs eager")
                    replay_checks.stop_if_failed(f"phase 5, {route} replays")
                # The path's launches are those of timing and ranking: the
                # build's warm-up (and capture) and the checks above are not.
                reset_gemm_counts(kmod)
                timer = WallClockTimer(workloads)
                single = {a.name: timer.measure(a.name) for a in algs}
                result = measure_and_rank(initial_hypothesis_by_time(single), timer,
                                          m_per_iteration=3, eps=0.03, max_measurements=30)
                report = flops_discriminant_test(result, flops)
                verdict = "ANOMALY: " + report.reason if report.is_anomaly else "valid discriminant"
                labels = {a.name: a.label for a in algs}
                entry = {
                    "dims": list(inst.dims), "mode": mode, "converged": result.converged,
                    "measurements_per_alg": result.measurements_per_alg,
                    "ranks": result.ranks, "mean_ranks": result.mean_ranks, "rf": rf,
                    "single_run_ms": {k: v * 1e3 for k, v in single.items()},
                    "inner_repeats": timer.inner_repeats, "verdict": verdict,
                    "min_flops_algs": list(report.min_flops_algs),
                    "seconds": time.perf_counter() - t_start,
                }
                quickstart[f"{route}/{inst_name}" + ("" if mode == "graph" else "/eager")] = entry
                log(f"[5 quickstart {route} {mode}] {inst_name} dims={inst.dims} converged="
                    f"{result.converged} N={result.measurements_per_alg} -> {verdict} "
                    f"(S_F = {', '.join(report.min_flops_algs)})")
                for alg in result.sequence:
                    log(f"    rank {alg.rank}  {alg.name:11s} {labels[alg.name]:18s} "
                        f"mr={alg.mean_rank:.2f} RF={rf[alg.name]:.2f} "
                        f"t1={single[alg.name] * 1e3:.4f} ms r={timer.inner_repeats[alg.name]}")
                del workloads, timer
                path_launches["total"] += kmod.matmul_kernel.launches
                for w in kmod.COPY_WIDTHS:
                    path_launches[w] += kmod.matmul_kernel.launches_by_copy[w]
            launches[path] = path_launches["total"]
            launches_by_copy[path] = {w: path_launches[w] for w in kmod.COPY_WIDTHS}
            log(f"[5 quickstart {route} {mode}] GEMM kernel launches in timing and ranking: {launches[path]} "
                f"(by copy width: {launches_by_copy[path]})")
    for route in ("torch_matmul", "hand_gemm"):
        for inst_name in INSTANCES:
            g, e = quickstart[f"{route}/{inst_name}"], quickstart[f"{route}/{inst_name}/eager"]
            log(f"[5 replay vs eager] {route} {inst_name}: single-run ms graph/eager "
                + ", ".join(f"{a} {g['single_run_ms'][a]:.4f}/{e['single_run_ms'][a]:.4f}"
                            for a in sorted(g["single_run_ms"]))
                + f"; verdict graph: {g['verdict']}; eager: {e['verdict']}")
    log(f"[5 replay vs eager] {replay_checks.n} graph outputs held to eager launches at 1e-4: "
        f"max_abs_err {replay_checks.errs}")
    details["quickstart"] = quickstart
    details["replay_vs_eager"] = {"checks": replay_checks.n, "max_abs_err": replay_checks.errs,
                                  "tolerance_used": replay_checks.used}
    if launches["quickstart[hand_gemm]"] == 0 or launches["quickstart[hand_gemm, eager]"] == 0:
        sys.exit("chip_smoke: the hand-GEMM quickstart path launched no GEMM kernel")

    mark("5 quickstart")
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
    reset_gemm_counts(kmod)
    autotune_routes = eager_rank(rank_site, site, report)
    launches["autotune[matmul_blocks, eager]"] = kmod.matmul_kernel.launches
    launches_by_copy["autotune[matmul_blocks, eager]"] = dict(kmod.matmul_kernel.launches_by_copy)
    log("[6 autotune] " + report.summary().replace("\n", "\n    "))
    log(f"[6 autotune] GEMM kernel launches: {launches['autotune[matmul_blocks]']}")
    details["autotune"] = {
        "site": report.site, "ranks": report.ranking.ranks,
        "mean_ranks": report.ranking.mean_ranks, "selected": report.selected,
        "single_run_ms": {k: v * 1e3 for k, v in report.single_run_times.items()},
        "dropped": list(report.dropped),
        "verdict": report.discriminant.reason if report.discriminant.is_anomaly else "valid",
        "routes": autotune_routes,
    }
    if launches["autotune[matmul_blocks]"] == 0:
        sys.exit("chip_smoke: the autotune path launched no GEMM kernel")
    details["launches"] = launches
    details["correctness"] = {"checks": gemm_checks.n, "max_abs_err": gemm_checks.errs,
                              "tolerance_used": gemm_checks.used, "tolerance": TOL}
    log(f"[checks] {gemm_checks.n} kernel-vs-plain checks in phases 3, 4 and 6: "
        f"max_abs_err {gemm_checks.errs}")
    gemm_launches = dict(launches)

    mark("6 autotune")
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

    mark("7 builds")
    flash = phase_flash(torch, dev, peak, rates, fmod, fault_libs, f32_fault_libs, launches)
    details["flash_attention"] = flash
    mark("8 flash attention")
    ssd = phase_ssd(torch, dev, peak, smod, launches, ssd_fault_libs, rates, built["ssd"], unguarded[smod])
    fault_dir.cleanup()
    details["ssd"] = ssd
    mark("9 ssd")
    details["sites"] = phase_sites(torch, rank_site, attention_site, ssd_chunk_site)
    mark("10 sites")
    t_census = time.perf_counter()
    census_work = tempfile.mkdtemp(prefix="chip_smoke_census_")
    details["census"], stores = phase_census(torch, kmod, matmul_ref, launches, census_work)
    details["census"]["seconds"] = time.perf_counter() - t_census
    mark("11 census")
    gemm_launches["census[kernel_variants]"] = launches["census[kernel_variants]"]
    gemm_launches["census[kernel_variants, eager]"] = launches["census[kernel_variants, eager]"]
    launches_by_copy["census[kernel_variants]"] = dict(kmod.matmul_kernel.launches_by_copy)
    t_explain = time.perf_counter()
    details["explain"] = phase_explain(torch, kmod, launches, stores, census_work)
    details["explain"]["seconds"] = time.perf_counter() - t_explain
    log(f"[12 explain] phase 12 took {details['explain']['seconds']:.1f} s")
    mark("12 explain")
    gemm_launches["explain[kernel_variants]"] = launches["explain[kernel_variants]"]
    launches_by_copy["explain[kernel_variants]"] = dict(kmod.matmul_kernel.launches_by_copy)
    t_oracle = time.perf_counter()
    explains = {key: Path(census_work) / f"explain_{key}" for key in stores}
    details["oracle"] = phase_oracle(torch, kmod, matmul_ref, launches, stores, explains, census_work, card)
    details["oracle"]["seconds"] = time.perf_counter() - t_oracle
    shutil.rmtree(census_work)
    mark("13 oracle")
    log(f"[13 oracle] phase 13 took {details['oracle']['seconds']:.1f} s [{card}]")
    for path_ in ("oracle[kernel_variants]", "active_census[kernel_variants]"):
        gemm_launches[path_] = launches[path_]
        launches_by_copy[path_] = details["oracle"]["launches_by_copy"][path_]
    t_models = time.perf_counter()
    details["models"] = phase_models(torch, kmod, fmod, smod, card)
    details["models"]["seconds"]["phase"] = time.perf_counter() - t_models
    mark("14 models")
    log(f"[14 models] phase 14 took {details['models']['seconds']['phase']:.1f} s [{card}]")
    t_train = time.perf_counter()
    details["train"] = phase_train(torch, kmod, fmod, smod, card)
    details["train"]["seconds"]["phase"] = time.perf_counter() - t_train
    mark("15 train")
    log(f"[15 train] phase 15 took {details['train']['seconds']['phase']:.1f} s [{card}]")
    t_dist = time.perf_counter()
    details["distributed"] = phase_distributed(torch, kmod, fmod, smod, card)
    details["distributed"]["seconds"]["phase"] = time.perf_counter() - t_dist
    mark("16 distributed")
    log(f"[16 distributed] phase 16 took {details['distributed']['seconds']['phase']:.1f} s [{card}]")
    for path_, phase_ in (("models[serve]", "models"), ("models[train]", "train"),
                          ("distributed[a]", "distributed")):
        counts = details[phase_]["kernel_launches"]
        gemm_launches[path_] = launches[path_] = counts["gemm"]
        for entry in flash["kernels"]:
            entry["launches_by_path"][path_] = counts["flash_attention"]
        ssd["kernel"]["launches_by_path"][path_] = counts["ssd"]
    details["launches"] = launches
    details["phase_seconds"] = {name: t1 - t0 for (_, t0), (name, t1) in zip(marks, marks[1:])}
    log("[phases] seconds from main's start, by phase: " + json.dumps(
        {k_: round(v, 1) for k_, v in details["phase_seconds"].items()}))

    # ---------------------------------------------------------- results --
    main_row = timings[0]  # 1000^3, the chain GEMMs of instance_B
    tile_key = "x".join(map(str, default_tile))
    kernel = {
        "name": "gemm",
        "route": "cuda",
        "source": "src/repro_torch/kernels/matmul/csrc/gemm.cu",
        "replaces": "src/repro/kernels/matmul/matmul.py:45",
        "launches": sum(gemm_launches.values()),
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

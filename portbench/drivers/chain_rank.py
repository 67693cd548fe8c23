"""One chain instance at a time, ranked on the hand GEMM, one caller waiting.

Each unit is one verdict by the port's one-instance path (as
``examples/torch_quickstart.py`` takes it): the instance's algorithms built
as CUDA graphs of ``repro_torch.kernels.matmul.ops.matmul``, a
``WallClockTimer`` over them, single runs, ``initial_hypothesis_by_time``,
Procedure 4 (``measure_and_rank``) and ``flops_discriminant_test``. The
benchmark draws the matrices on the device and wraps each timed callable
to count it and, in a traced run, to mark it. Dimensions come from a pool
drawn once from the traffic file; every seed ranks the same pool, round
after round, in its own order and with its own matrices. After the window
every verdict's FLOP table and verdict are recomputed, and the products of
a sample of verdicts (what their timed callables last returned) are held
to the float64 product.
"""

from __future__ import annotations

import time
from typing import Dict, List

import torch

from .. import formulas, generators as gen, reference
from ..harness import Verdict


class Driver:
    unit_size = 1
    kernel_build_s = 0.0

    def __init__(self, config, traffic, *, seed, device, tracer, calls):
        from repro_torch import core, expressions
        from repro_torch.kernels.matmul import ops

        self.core, self.expressions, self.gemm = core, expressions, ops.matmul
        self.t = traffic
        self.seed, self.device, self.tracer, self.calls = seed, device, tracer, calls
        n, lo, hi = int(config["n_matrices"]), int(traffic["lo"]), int(traffic["hi"])
        self.pool = [gen.chain_dims(n, lo, hi, int(traffic["pool_first"]) + i)
                     for i in range(int(traffic["pool"]))]
        self.order = gen.rounds(seed, 1, len(self.pool))
        self.every = int(traffic["check_every"])
        self.pick = gen.derive(seed, 3) % self.every
        self.j = 0
        self.seen: List[Dict] = []     # per verdict: dims, the port's FLOP table, its report
        self.kept: List[Dict] = []     # sampled verdicts: inputs and last outputs

    def setup(self) -> None:
        """Build the GEMM (timed apart: ``nvcc`` on a checkout's first run)
        and load it at both copy widths (rows of 4-byte multiples and not),
        then rank one instance of the pool untimed."""
        if self.device.type == "cuda":
            from repro_torch.kernels.matmul import matmul

            t0 = time.perf_counter()
            matmul.build()
            self.kernel_build_s = time.perf_counter() - t0
        for cols in (1024, 1022):
            a = torch.ones((1024, 1024), device=self.device)
            b = torch.ones((1024, cols), device=self.device)
            self.gemm(a, b)
        self._verdict(self.pool[0], gen.derive(self.seed, 4), keep=None)

    def unit(self) -> List[Verdict]:
        j = self.j
        self.j += 1
        t0 = time.perf_counter()
        dims = self.pool[next(self.order)]
        keep = {} if j == 0 or j % self.every == self.pick else None
        mats, result, flops, report, build_s = self._verdict(dims, gen.derive(self.seed, 2, j), keep)
        latency = time.perf_counter() - t0
        self.seen.append({"dims": dims, "flops": flops, "report": report})
        if keep is not None:
            self.kept.append({"mats": mats, "outs": keep})
        return [Verdict(latency_s=latency, build_s=build_s,
                        measurements=result.measurements_per_alg * len(result.sequence))]

    def _verdict(self, dims, input_seed: int, keep):
        core, ex = self.core, self.expressions
        with self.tracer.mark("pb.inputs"):
            mats = gen.chain_inputs(dims, input_seed, self.device)
        algs = ex.generate_chain_algorithms(dims)
        frozen = {name: (flops, gemms) for name, flops, gemms in formulas.chain_algorithms(dims)}
        with self.tracer.mark("pb.build"):
            tb = time.perf_counter()
            built = ex.build_workloads(algs, mats, jit=True, gemm=self.gemm)
            timer = core.WallClockTimer({
                name: self.calls.wrap(fn, frozen[name][0],
                                      sum(formulas.gemm_bound_s(*g) for g in frozen[name][1]),
                                      keep, name)
                for name, fn in built.items()})
            single = {name: timer.measure(name) for name in built}
            build_s = time.perf_counter() - tb
        with self.tracer.mark("pb.rank"):
            h0 = core.initial_hypothesis_by_time(single)
            result = core.measure_and_rank(h0, timer, m_per_iteration=3, eps=0.03,
                                           max_measurements=30)
            flops = ex.flops_table(algs)
            report = core.flops_discriminant_test(result, flops)
        return mats, result, flops, report, build_s

    def release(self) -> None:
        pass

    def check(self, control: bool = False) -> Dict[str, Dict]:
        faults = 0
        for v in self.seen:
            frozen = {name: float(f) for name, f, _ in formulas.chain_algorithms(v["dims"])}
            r = v["report"]
            port = {"min_flops_algs": list(r.min_flops_algs), "best_rank_in_sf": r.best_rank_in_sf,
                    "best_rank_overall": r.best_rank_overall, "is_anomaly": r.is_anomaly,
                    "reason": r.reason}
            faults += reference.verdict_faults(frozen, v["flops"], r.ranks, port)
        worst = 0.0 if self.kept else float("inf")
        while self.kept:
            k = self.kept.pop()
            ref = reference.chain_product(k["mats"])
            outs = {"tf32": reference.chain_tf32(k["mats"])} if control else k["outs"]
            worst = max([worst] + [reference.rel_max_err(o, ref) for o in outs.values()])
            del k, ref, outs
        return {
            "verdict_mismatches": {"value": faults, "limit": 0},
            "product_err": {"value": worst, "limit": self.t["limits"]["product_err"]},
        }

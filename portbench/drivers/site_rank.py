"""One autotune site at a time, ranked by ``rank_site``: the SSD chunk site.

Each unit is one verdict of ``repro_torch.autotune.tuner.rank_site`` with
its defaults on ``autotune.variants.ssd_chunk_site`` at the configuration's
widths: the model path's ``models/mamba2.ssd_chunked`` at each chunk length
of the traffic, every variant one CUDA graph. Every call holds ``tokens``
tokens, split as (tokens / s) sequences of length s; the benchmark makes
the inputs on the device in the site's layout and hands them to the site.
Each variant's thunk is wrapped to count every call made to it, whichever
part of the program makes it, and the site's preparation
(``tuner.prepare_site``: workloads built and warmed, single runs) is
spanned by the driver for the window. Every seed ranks the same set of
shapes, round after round, in its own order and with its own inputs.
After the window every verdict's FLOP table and verdict are recomputed,
and what the variants of a sample of verdicts last returned is held to the
float64 sequential scan.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List

import torch

from .. import formulas, generators as gen, reference
from ..harness import Verdict


class Driver:
    unit_size = 1

    def __init__(self, config, traffic, *, seed, device, tracer, calls):
        from repro_torch.autotune import tuner, variants

        self.tuner, self.variants = tuner, variants
        self.t = traffic
        self.seed, self.device, self.tracer, self.calls = seed, device, tracer, calls
        self.h = int(config["expand"]) * int(config["d_model"]) // int(config["headdim"])
        self.p, self.n = int(config["headdim"]), int(config["d_state"])
        tokens = int(traffic["tokens"])
        self.shapes = [(tokens // s, int(s)) for s in traffic["seq_lens"]]
        self.chunks = tuple(int(q) for q in traffic["chunks"])
        self.order = gen.rounds(seed, 1, len(self.shapes))
        self.every = int(traffic["check_every"])
        self.pick = gen.derive(seed, 3) % self.every
        self.j = 0
        self.seen: List[Dict] = []
        self.kept: List[Dict] = []
        self.real_prepare = tuner.prepare_site
        self.prepare_s = None  # the unit's seconds in prepare_site; None until it is called

    def _inputs(self, b: int, s: int, seed: int):
        return gen.ssd_inputs(b, s, self.h, self.p, self.n, seed, self.device)

    def _site(self, b: int, s: int, tensors, keep):
        """The port's site at (b, s), given the benchmark's inputs and with
        each variant's thunk counted (and, for a sampled verdict, keeping
        its last output)."""
        site = self.variants.ssd_chunk_site(b=b, s=s, h=self.h, p=self.p, n=self.n,
                                            chunks=self.chunks, dtype=torch.float32,
                                            device=self.device)

        def wrapped(v):
            flops = formulas.ssd_chunk_flops(b, s, self.h, self.p, self.n, v.meta["chunk"])

            def build(*ts):
                return self.calls.wrap(v.build(*ts), flops, None, keep, v.name)

            return dataclasses.replace(v, build=build)

        return dataclasses.replace(site, make_inputs=lambda _seed: tensors,
                                   variants=tuple(wrapped(v) for v in site.variants))

    def _prepare(self, *args, **kwargs):
        """``tuner.prepare_site`` spanned: the verdict's set-up."""
        t0 = time.perf_counter()
        try:
            with self.tracer.mark("pb.prepare"):
                return self.real_prepare(*args, **kwargs)
        finally:
            self.prepare_s = (self.prepare_s or 0.0) + time.perf_counter() - t0

    def setup(self) -> None:
        """Capture and run every variant at every shape once, then rank one
        shape untimed."""
        for k, (b, s) in enumerate(self.shapes):
            tensors = self._inputs(b, s, gen.derive(self.seed, 4, k))
            site = self._site(b, s, tensors, None)
            for v in site.variants:
                v.build(*tensors)()
            del site, tensors
        b, s = self.shapes[0]
        self.tuner.rank_site(self._site(b, s, self._inputs(b, s, gen.derive(self.seed, 4)), None))
        self.tuner.prepare_site = self._prepare

    def unit(self) -> List[Verdict]:
        j = self.j
        self.j += 1
        t0 = time.perf_counter()
        b, s = self.shapes[next(self.order)]
        with self.tracer.mark("pb.inputs"):
            tensors = self._inputs(b, s, gen.derive(self.seed, 2, j))
        keep = {} if j == 0 or j % self.every == self.pick else None
        site = self._site(b, s, tensors, keep)
        self.prepare_s = None
        with self.tracer.mark("pb.rank"):
            report = self.tuner.rank_site(site)
        latency = time.perf_counter() - t0
        self.seen.append({"shape": (b, s), "flops": site.flops_table(), "report": report})
        if keep is not None:
            self.kept.append({"inputs": tensors, "outs": keep})
        ranking = report.ranking
        return [Verdict(latency_s=latency, build_s=self.prepare_s,
                        measurements=ranking.measurements_per_alg * len(ranking.sequence))]

    def release(self) -> None:
        self.tuner.prepare_site = self.real_prepare

    def check(self, control: bool = False) -> Dict[str, Dict]:
        faults = 0
        for v in self.seen:
            b, s = v["shape"]
            frozen = {f"chunk_{q}": formulas.ssd_chunk_flops(b, s, self.h, self.p, self.n, q)
                      for q in self.chunks}
            d = v["report"].discriminant
            port = {"min_flops_algs": list(d.min_flops_algs), "best_rank_in_sf": d.best_rank_in_sf,
                    "best_rank_overall": d.best_rank_overall, "is_anomaly": d.is_anomaly,
                    "reason": d.reason}
            faults += reference.verdict_faults(frozen, v["flops"], v["report"].ranking.ranks, port)
        worst = 0.0 if self.kept else float("inf")
        while self.kept:
            k = self.kept.pop()
            ref = reference.ssd_scan(*k["inputs"])
            outs = {"tf32": reference.ssd_scan_tf32(*k["inputs"])} if control else k["outs"]
            worst = max([worst] + [reference.rel_max_err(o, ref) for o in outs.values()])
            del k, ref, outs
        return {
            "verdict_mismatches": {"value": faults, "limit": 0},
            "y_err": {"value": worst, "limit": self.t["limits"]["y_err"]},
        }

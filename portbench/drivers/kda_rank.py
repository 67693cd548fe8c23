"""Kimi Delta Attention's chunk length ranked by ``rank_site``: prefill
segments of 16384 new tokens.

Each unit is one verdict of ``repro_torch.autotune.tuner.rank_site`` with
its defaults on ``autotune.variants.kda_chunk_site`` at the configuration's
widths (32 heads of 128): the model path's chunked KDA core
(``models/kda.kda_chunked``) at each chunk length of the traffic, every
variant one CUDA graph. Every call holds ``tokens`` new tokens, split as
(tokens / s) sequences of s, each continuing from its own incoming state.
The benchmark draws the inputs on the device from the seed, as the mixer's
projections give them: q and k normal then L2-normalised (q scaled by
d_k^-1/2), v normal, g = -A softplus(z + dt_bias) with the layer's
initialisation (A = U[1, 16] per head, softplus(dt_bias) log-uniform in
[1e-3, 1e-1] per channel; z the decay projection's output, normal with the
std a unit-RMS hidden state gives through two factors of std 0.02), β =
sigmoid(normal), the state normal. Each variant's thunk is wrapped to count
its calls with their frozen FLOPs and, in a traced run, to mark each with
the least time the chip could take for it; the site's preparation is
spanned for the window. Every seed ranks the same set of shapes, round
after round, in its own order and with its own inputs. After the window
every verdict's FLOP table and verdict are recomputed, and what the
variants of a sample of verdicts last returned, the output and the final
state, are held to the float64 recurrence.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Dict, List

import torch

from .. import formulas_kda, generators as gen, reference, reference_kda
from ..harness import Verdict


def inputs(b: int, s: int, w: Dict[str, int], z_std: float, seed: int, device: torch.device):
    """q, k, v, g [b, s, h, d], beta [b, s, h], state [b, h, d_k, d_v]."""
    h, dk, dv = w["h"], w["dk"], w["dv"]
    g_ = torch.Generator(device=device).manual_seed(seed)

    def normal(*shape):
        return torch.randn(shape, generator=g_, device=device)

    def l2(x):
        return x * torch.rsqrt(x.square().sum(dim=-1, keepdim=True) + 1e-6)

    q = l2(normal(b, s, h, dk)) * dk ** -0.5
    k = l2(normal(b, s, h, dk))
    v = normal(b, s, h, dv)
    a = torch.rand((h, 1), generator=g_, device=device) * 15.0 + 1.0
    rate = torch.exp(torch.rand((h, dk), generator=g_, device=device) * math.log(100.0) + math.log(1e-3))
    dt_bias = rate + torch.log(-torch.expm1(-rate))
    g = -a * torch.nn.functional.softplus(normal(b, s, h, dk) * z_std + dt_bias)
    beta = torch.sigmoid(normal(b, s, h))
    return [q, k, v, g, beta, normal(b, h, dk, dv)]


class Driver:
    unit_size = 1

    def __init__(self, config, traffic, *, seed, device, tracer, calls):
        from repro_torch.autotune import tuner, variants

        self.tuner, self.variants = tuner, variants
        self.t = traffic
        self.seed, self.device, self.tracer, self.calls = seed, device, tracer, calls
        self.w = formulas_kda.widths(config)
        # z = x W_f_down W_f_up: std 0.02² · sqrt(hidden · rank) for a unit-RMS x
        self.z_std = 0.02 ** 2 * math.sqrt(int(config["hidden_size"]) * self.w["dv"])
        tokens = int(traffic["tokens"])
        self.shapes = [(tokens // s, int(s)) for s in traffic["seq_lens"]]
        self.chunks = tuple(int(c) for c in traffic["chunks"])
        self.order = gen.rounds(seed, 1, len(self.shapes))
        self.every = int(traffic["check_every"])
        self.pick = gen.derive(seed, 3) % self.every
        self.j = 0
        self.seen: List[Dict] = []
        self.kept: List[Dict] = []
        self.real_prepare = tuner.prepare_site
        self.prepare_s = None  # the unit's seconds in prepare_site; None until it is called

    def _inputs(self, b: int, s: int, seed: int):
        return inputs(b, s, self.w, self.z_std, seed, self.device)

    def _site(self, b: int, s: int, tensors, keep):
        """The port's site at (b, s), given the benchmark's inputs, each
        variant's thunk counted and marked (and, for a sampled verdict,
        keeping its last output)."""
        site = self.variants.kda_chunk_site(b=b, s=s, h=self.w["h"], dk=self.w["dk"], dv=self.w["dv"],
                                            chunks=self.chunks, dtype=torch.float32, device=self.device)
        nbytes = formulas_kda.kda_bytes(b, s, self.w["h"], self.w["dk"], self.w["dv"])

        def wrapped(v):
            flops = formulas_kda.kda_flops(b, s, self.w["h"], self.w["dk"], self.w["dv"], v.meta["chunk"])

            def build(*ts):
                return self.calls.wrap(v.build(*ts), flops, formulas_kda.kda_bound_s(flops, nbytes),
                                       keep, v.name)

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
            frozen = {f"chunk_{c}": formulas_kda.kda_flops(b, s, self.w["h"], self.w["dk"], self.w["dv"], c)
                      for c in self.chunks}
            d = v["report"].discriminant
            port = {"min_flops_algs": list(d.min_flops_algs), "best_rank_in_sf": d.best_rank_in_sf,
                    "best_rank_overall": d.best_rank_overall, "is_anomaly": d.is_anomaly,
                    "reason": d.reason}
            faults += reference.verdict_faults(frozen, v["flops"], v["report"].ranking.ranks, port)
        worst = 0.0 if self.kept else math.inf
        while self.kept:
            k = self.kept.pop()
            ref_o, ref_s = reference_kda.recurrence(*k["inputs"])
            if control:
                outs = [reference_kda.recurrence(*k["inputs"], control=True)]
            else:
                outs = list(k["outs"].values())
                if len(outs) != len(self.chunks):
                    outs.append((ref_o.new_empty(0), ref_s.new_empty(0)))  # a variant timed nothing
            for o, state in outs:
                worst = max(worst, reference.rel_max_err(o, ref_o), reference.rel_max_err(state, ref_s))
            del k, ref_o, ref_s, outs
        return {
            "verdict_mismatches": {"value": faults, "limit": 0},
            "out_err": {"value": worst, "limit": self.t["limits"]["out_err"]},
        }

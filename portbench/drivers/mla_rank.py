"""Latent attention's algorithms ranked by ``rank_site``: an extend step
against a long latent cache.

Each unit is one verdict of ``repro_torch.autotune.tuner.rank_site`` with
its defaults on ``autotune.variants.mla_site``: the model path's
latent-attention sublayer (``models/mla.mla_attention``) for ``q`` new
tokens of one sequence against a latent cache of ``cache_len`` positions
whose last ``q`` rows the call writes, in its four algorithms (absorbed or
decompressed, scores materialised or blockwise), each one CUDA graph. The
benchmark draws the layer's weights once and each verdict's inputs (the
new tokens' hidden states, the cached latents and rope keys) on the
device from the seed. Every seed ranks the same set of ``q`` round after
round, in its own order and with its own inputs. Each variant's thunk is
wrapped to count its calls with their frozen FLOPs and, in a traced run,
to mark each with the least time the chip could take for it. After the
window every verdict's FLOP table and verdict are recomputed, and what
the variants of a sample of verdicts last returned, and the latent rows
they wrote, are held to the float64 plain reference.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Dict, List

import torch

from .. import formulas_mla, generators as gen, reference, reference_mla
from ..harness import Verdict


def weights(w: Dict[str, int], seed: int, device: torch.device) -> Dict[str, torch.Tensor]:
    """One layer's attention weights in the program's layout, drawn on
    ``device``: normal with std 0.02, the latent norm's weight 1 + 0.1
    normal."""
    d, h, r, dn, dr, dv = (w[k] for k in ("d", "h", "r", "dn", "dr", "dv"))
    g = torch.Generator(device=device).manual_seed(seed)

    def normal(*shape, std=0.02):
        return torch.randn(shape, generator=g, device=device) * std

    return {"wq": normal(d, h, dn + dr), "wkv_a": normal(d, r + dr), "kv_norm": 1.0 + normal(r, std=0.1),
            "wuk": normal(r, h, dn), "wuv": normal(r, h, dv), "wo": normal(h, dv, d)}


def inputs(w: Dict[str, int], b: int, q: int, L: int, seed: int, device: torch.device):
    """x [b, q, d], c [b, L, r], kr [b, L, dr], standard normal."""
    g = torch.Generator(device=device).manual_seed(seed)
    return [torch.randn((b, q, w["d"]), generator=g, device=device),
            torch.randn((b, L, w["r"]), generator=g, device=device),
            torch.randn((b, L, w["dr"]), generator=g, device=device)]


def model_config(config):
    """The program's configuration of the layer, from the file's published keys."""
    from repro_torch.models.config import ModelConfig

    rs = config["rope_scaling"]
    return ModelConfig(
        name=config["name"], n_layers=int(config["num_hidden_layers"]),
        d_model=int(config["hidden_size"]), n_heads=int(config["num_attention_heads"]),
        n_kv_heads=int(config["num_key_value_heads"]), kv_lora_rank=int(config["kv_lora_rank"]),
        qk_nope_head_dim=int(config["qk_nope_head_dim"]), qk_rope_head_dim=int(config["qk_rope_head_dim"]),
        v_head_dim=int(config["v_head_dim"]), rope_theta=float(config["rope_theta"]),
        rope_factor=float(rs["factor"]), rope_original_max_position=int(rs["original_max_position_embeddings"]),
        rope_beta_fast=float(rs["beta_fast"]), rope_beta_slow=float(rs["beta_slow"]),
        rope_mscale=float(rs["mscale"]), rope_mscale_all_dim=float(rs["mscale_all_dim"]),
        norm_eps=float(config["rms_norm_eps"]), dtype=config["dtype"], param_dtype=config["dtype"])


class Driver:
    unit_size = 1

    def __init__(self, config, traffic, *, seed, device, tracer, calls):
        from repro_torch.autotune import tuner, variants

        self.tuner, self.variants = tuner, variants
        self.config, self.t = config, traffic
        self.seed, self.device, self.tracer, self.calls = seed, device, tracer, calls
        self.cfg = model_config(config)
        self.w = formulas_mla.widths(config)
        self.b, self.L = int(traffic["batch"]), int(traffic["cache_len"])
        self.q_lens = [int(q) for q in traffic["q_lens"]]
        self.params = weights(self.w, gen.derive(seed, 5), device)
        self.order = gen.rounds(seed, 1, len(self.q_lens))
        self.every = int(traffic["check_every"])
        self.pick = gen.derive(seed, 3) % self.every
        self.j = 0
        self.seen: List[Dict] = []
        self.kept: List[Dict] = []

    def _site(self, q: int, tensors, keep):
        """The port's site at ``q``, given the benchmark's weights and
        inputs, each variant's thunk counted and marked (and, for a sampled
        verdict, keeping its last output)."""
        site = self.variants.mla_site(q=q, L=self.L, b=self.b, cfg=self.cfg, params=self.params,
                                      device=self.device)
        flops = formulas_mla.mla_flops(self.w, q, self.L, self.b)
        nbytes = formulas_mla.mla_bytes(self.w, q, self.L, self.b)

        def wrapped(v):
            def build(*ts):
                return self.calls.wrap(v.build(*ts), flops[v.name],
                                       formulas_mla.mla_bound_s(flops[v.name], nbytes), keep, v.name)

            return dataclasses.replace(v, build=build)

        return dataclasses.replace(site, make_inputs=lambda _seed: tensors,
                                   variants=tuple(wrapped(v) for v in site.variants))

    def _inputs(self, q: int, seed: int):
        return inputs(self.w, self.b, q, self.L, seed, self.device)

    def setup(self) -> None:
        """Capture and run every variant at every ``q`` once, then rank one
        ``q`` untimed."""
        for k, q in enumerate(self.q_lens):
            tensors = self._inputs(q, gen.derive(self.seed, 4, k))
            for v in self._site(q, tensors, None).variants:
                v.build(*tensors)()
            del tensors
        q = self.q_lens[0]
        self.tuner.rank_site(self._site(q, self._inputs(q, gen.derive(self.seed, 4)), None))

    def unit(self) -> List[Verdict]:
        j = self.j
        self.j += 1
        t0 = time.perf_counter()
        q = self.q_lens[next(self.order)]
        with self.tracer.mark("pb.inputs"):
            tensors = self._inputs(q, gen.derive(self.seed, 2, j))
        keep = {} if j == 0 or j % self.every == self.pick else None
        site = self._site(q, tensors, keep)
        with self.tracer.mark("pb.rank"):
            report = self.tuner.rank_site(site)
        latency = time.perf_counter() - t0
        self.seen.append({"q": q, "flops": site.flops_table(), "report": report})
        if keep is not None:
            self.kept.append({"inputs": tensors, "outs": keep, "seed": gen.derive(self.seed, 2, j)})
        ranking = report.ranking
        return [Verdict(latency_s=latency, build_s=None,
                        measurements=ranking.measurements_per_alg * len(ranking.sequence))]

    def release(self) -> None:
        pass

    def check(self, control: bool = False) -> Dict[str, Dict]:
        faults = 0
        for v in self.seen:
            frozen = formulas_mla.mla_flops(self.w, v["q"], self.L, self.b)
            d = v["report"].discriminant
            port = {"min_flops_algs": list(d.min_flops_algs), "best_rank_in_sf": d.best_rank_in_sf,
                    "best_rank_overall": d.best_rank_overall, "is_anomaly": d.is_anomaly,
                    "reason": d.reason}
            faults += reference.verdict_faults(frozen, v["flops"], v["report"].ranking.ranks, port)
        worst = 0.0 if self.kept else math.inf
        while self.kept:
            k = self.kept.pop()
            x, c, kr = k["inputs"]
            q = x.shape[1]
            # the cached rows as drawn (the calls wrote rows L - q on)
            drawn = self._inputs(q, k["seed"])
            ref_o, ref_c, ref_kr = reference_mla.extend(self.config, self.params, x, drawn[1], drawn[2])
            if control:
                outs = [reference_mla.extend(self.config, self.params, x, drawn[1], drawn[2], control=True)]
            else:
                outs = [(o, c[:, -q:], kr[:, -q:]) for o in k["outs"].values()]
                if len(k["outs"]) != len(formulas_mla.VARIANTS):
                    outs.append((x.new_empty(0), c[:, -q:], kr[:, -q:]))  # a variant timed nothing
            for o, c_new, kr_new in outs:
                worst = max(worst, reference.rel_max_err(o, ref_o), reference.rel_max_err(c_new, ref_c),
                            reference.rel_max_err(kr_new, ref_kr))
            del k, x, c, kr, drawn, ref_o, ref_c, ref_kr, outs
        return {
            "verdict_mismatches": {"value": faults, "limit": 0},
            "out_err": {"value": worst, "limit": self.t["limits"]["out_err"]},
        }

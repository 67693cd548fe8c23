"""Variant sites: sets of mathematically equivalent implementations.

A :class:`VariantSite` is the framework's unit of algorithm choice — the
exact object the paper's methodology ranks. Every variant carries an
analytic FLOP count, so the FLOPs-discriminant test applies directly.

* ``attention_impl`` — reference (grouped / broadcast GQA) and chunked
  attention (``models/attention.py``): equal math; chunked computes the
  masked blocks too, reference materialises the score matrix. Neither FLOPs
  nor bytes alone predicts the winner across shapes.
* ``moe_dispatch`` — gather vs dense (``models/moe.py``): identical
  outputs when no token is dropped, dense costs ~E/top_k x the FLOPs but has
  no scatter/gather — FLOPs *should* discriminate; when they do not, that
  is a textbook anomaly.
* ``ssd_chunk`` — Mamba-2 chunk length (``models/mamba2.py``): equal
  leading-order FLOPs.
* ``mla`` — latent attention's absorbed and decompressed orders, each with
  materialised or blockwise scores (``models/mla.py``), for an extend
  step against a latent cache: FLOPs cross over with the new tokens
  against the cache's length, and are equal inside an order.
* ``kda_chunk`` — Kimi Delta Attention's chunk length (``models/kda.py``):
  the intra-chunk work grows with the chunk, the sequential state pass
  shortens with it, so the fewest FLOPs come with the longest loop.
* ``matmul_blocks`` — the hand-written Hopper GEMM's tile shapes plus the
  library baseline ``torch_matmul`` (cuBLAS; the reference's ``xla_dot``):
  equal FLOPs exactly.

Like the reference's, the attention, MoE and SSD sites time the plain
model code; none has a kernel variant. The MLA and KDA sites are the port's own. Each variant's timed thunk is the
reference's jitted thunk as one CUDA graph on the card
(:func:`~repro_torch.graphs.measured_thunk`), eager on the CPU.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, List, Optional, Sequence

import torch

from ..device import DeviceLike, resolve_device
from ..graphs import measured_thunk
from ..kernels.matmul.matmul import check_tile
from ..kernels.matmul.ops import matmul
from ..models.attention import attention_chunked, attention_reference
from ..models.config import ModelConfig
from ..models.flops import kda_chunk_flops, mla_algorithm_flops
from ..models.kda import kda_chunked, l2_normalize
from ..models.layers import split_params
from ..models.mamba2 import ssd_chunked
from ..models.mla import ALGORITHMS, init_mla, mla_attention
from ..models.moe import init_moe, moe_dense, moe_gather
from ..spans import span

Thunk = Callable[[], Any]


@dataclasses.dataclass(frozen=True)
class Variant:
    name: str
    flops: float                     # analytic, per workload execution
    build: Callable[..., Thunk]      # (*tensors) -> zero-arg timed thunk
    meta: Dict[str, Any] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass(frozen=True)
class VariantSite:
    name: str
    variants: tuple
    make_inputs: Callable[[int], List[torch.Tensor]]   # seed -> tensors

    def flops_table(self) -> Dict[str, float]:
        return {v.name: v.flops for v in self.variants}

    def workloads(self, seed: int = 0, warmup: bool = True) -> Dict[str, Thunk]:
        """name -> timed thunk on inputs drawn from ``seed``, each run once
        when ``warmup``; the whole build is the span ``rt.build``."""
        table: Dict[str, Thunk] = {}
        with span("rt.build"):
            tensors = self.make_inputs(seed)
            for v in self.variants:
                thunk = v.build(*tensors)
                if warmup:
                    thunk()
                table[v.name] = thunk
        return table


# ------------------------------------------------------- attention site ----

def attention_site(
    b: int = 2, s: int = 1024, h: int = 8, kv: int = 2, d: int = 64,
    dtype: torch.dtype = torch.float32,
    device: DeviceLike = "cuda",
) -> VariantSite:
    dev = resolve_device(device)

    def inputs(seed: int):
        gen = torch.Generator(device=dev).manual_seed(seed)
        q = torch.randn((b, s, h, d), generator=gen, device=dev).to(dtype)
        k = torch.randn((b, s, kv, d), generator=gen, device=dev).to(dtype)
        v = torch.randn((b, s, kv, d), generator=gen, device=dev).to(dtype)
        return [q, k, v]

    # score FLOPs: rectangle for both impls (masked blocks computed)
    f_scores = 2.0 * b * h * s * s * d * 2
    f_ref = f_scores
    f_chunk = f_scores

    def ref_grouped(q, k, v):
        return measured_thunk(lambda q, k, v: attention_reference(q, k, v, gqa="grouped"), q, k, v)

    def ref_broadcast(q, k, v):
        return measured_thunk(lambda q, k, v: attention_reference(q, k, v, gqa="broadcast"), q, k, v)

    def chunked(q, k, v):
        return measured_thunk(
            lambda q, k, v: attention_chunked(
                q, k, v, q_block=min(256, s), kv_block=min(512, s)
            ),
            q, k, v,
        )

    return VariantSite(
        name=f"attention[b{b} s{s} h{h}kv{kv} d{d}]",
        variants=(
            Variant("reference_grouped", f_ref, ref_grouped),
            Variant("reference_broadcast", f_ref, ref_broadcast,
                    {"extra_traffic": "K/V repeated to H heads"}),
            Variant("chunked_flash", f_chunk, chunked,
                    {"memory": "O(s*block) not O(s^2)"}),
        ),
        make_inputs=inputs,
    )


# ------------------------------------------------------------- MoE site ----

def moe_dispatch_site(
    tokens: int = 2048, d: int = 256, e: int = 8, top_k: int = 2, d_ff: int = 128,
    dtype: torch.dtype = torch.float32,
    device: DeviceLike = "cuda",
) -> VariantSite:
    dev = resolve_device(device)
    cfg = ModelConfig(
        name="site-moe", n_layers=2, d_model=d, n_heads=4, n_kv_heads=4,
        d_ff=d_ff, vocab_size=128, n_experts=e, top_k=top_k, moe_d_ff=d_ff,
        dtype="float32", param_dtype="float32",
    )
    params, _ = split_params(init_moe(cfg, torch.Generator(device=dev).manual_seed(7)))

    def inputs(seed: int):
        gen = torch.Generator(device=dev).manual_seed(seed)
        return [torch.randn((tokens, d), generator=gen, device=dev).to(dtype)]

    f_expert = 6.0 * tokens * d * d_ff  # 3 gemms x 2
    f_gather = f_expert * top_k * cfg.moe_capacity_factor + 2.0 * tokens * d * e
    f_dense = f_expert * e + 2.0 * tokens * d * e

    def gather(x):
        return measured_thunk(lambda x: moe_gather(cfg, params, x)[0], x)

    def dense(x):
        return measured_thunk(lambda x: moe_dense(cfg, params, x)[0], x)

    return VariantSite(
        name=f"moe_dispatch[T{tokens} E{e} k{top_k}]",
        variants=(
            Variant("gather", f_gather, gather, {"traffic": "scatter/gather"}),
            Variant("dense", f_dense, dense, {"flops": f"{e/top_k:.0f}x active"}),
        ),
        make_inputs=inputs,
    )


# ------------------------------------------------------------- SSD site ----

def ssd_chunk_site(
    b: int = 2, s: int = 2048, h: int = 8, p: int = 32, n: int = 32,
    chunks: Sequence[int] = (64, 128, 256, 512),
    dtype: torch.dtype = torch.float32,
    device: DeviceLike = "cuda",
) -> VariantSite:
    dev = resolve_device(device)

    def inputs(seed: int):
        gen = torch.Generator(device=dev).manual_seed(seed)
        x = torch.randn((b, s, h, p), generator=gen, device=dev).to(dtype)
        dt = torch.nn.functional.softplus(torch.randn((b, s, h), generator=gen, device=dev))
        a_log = torch.randn((h,), generator=gen, device=dev) * 0.5
        bm = torch.randn((b, s, 1, n), generator=gen, device=dev)
        cm = torch.randn((b, s, 1, n), generator=gen, device=dev)
        return [x, dt, a_log, bm, cm]

    def make(chunk):
        def build(x, dt, a_log, bm, cm):
            return measured_thunk(
                lambda x, dt, a_log, bm, cm: ssd_chunked(x, dt, a_log, bm, cm, chunk)[0],
                x, dt, a_log, bm, cm,
            )
        return build

    def flops(q):
        return b * s * h * (2.0 * q * n + 2.0 * q * p + 4.0 * p * n)

    return VariantSite(
        name=f"ssd_chunk[s{s} h{h} p{p} n{n}]",
        variants=tuple(
            Variant(f"chunk_{q}", flops(q), make(q), {"chunk": q}) for q in chunks
        ),
        make_inputs=inputs,
    )


# ------------------------------------------------------------- MLA site ----

def mla_site(
    q: int = 256, L: int = 16384, b: int = 1,
    cfg: Optional[ModelConfig] = None,
    params: Optional[Dict[str, torch.Tensor]] = None,
    dtype: torch.dtype = torch.float32,
    device: DeviceLike = "cuda",
) -> VariantSite:
    """One extend step of the model path's latent-attention sublayer
    (:func:`~repro_torch.models.mla.mla_attention`): ``q`` new tokens'
    normed hidden states [b, q, d] in, the sublayer's output out, their
    latents written into rows L − q … L − 1 of a latent cache of ``L``
    rows ({c: [b, L, r], kr: [b, L, dr]}) and attended to with the rows
    before them. ``cfg`` defaults to deepseek-v2-lite's widths; ``params``
    (:func:`~repro_torch.models.mla.init_mla`'s tree) to weights drawn
    from seed 7. Inputs: (x, c, kr)."""
    if cfg is None:
        from ..configs import get_config

        cfg = get_config("deepseek-v2-lite")
    dev = resolve_device(device)
    if params is None:
        drawn, _ = split_params(init_mla(cfg, torch.Generator(device=dev).manual_seed(7)))
        params = {k: v.to(dtype) for k, v in drawn.items()}
    r, dr = cfg.kv_lora_rank, cfg.qk_rope_head_dim

    def inputs(seed: int):
        gen = torch.Generator(device=dev).manual_seed(seed)
        x = torch.randn((b, q, cfg.d_model), generator=gen, device=dev).to(dtype)
        c = torch.randn((b, L, r), generator=gen, device=dev).to(dtype)
        kr = torch.randn((b, L, dr), generator=gen, device=dev).to(dtype)
        return [x, c, kr]

    def make(name):
        def build(x, c, kr):
            return measured_thunk(
                lambda x, c, kr: mla_attention(cfg, params, x, L - q, {"c": c, "kr": kr}, impl=name),
                x, c, kr,
            )
        return build

    flops = mla_algorithm_flops(cfg, q, L, b)
    return VariantSite(
        name=f"mla[q{q} L{L} b{b}]",
        variants=tuple(Variant(name, flops[name], make(name), {"algorithm": name}) for name in ALGORITHMS),
        make_inputs=inputs,
    )


# ------------------------------------------------------------- KDA site ----

def kda_chunk_site(
    b: int = 1, s: int = 16384, h: int = 32, dk: int = 128, dv: int = 128,
    chunks: Sequence[int] = (32, 64, 128),
    dtype: torch.dtype = torch.float32,
    device: DeviceLike = "cuda",
) -> VariantSite:
    """The model path's chunked KDA core (:func:`~repro_torch.models.kda.kda_chunked`)
    on ``b`` sequences of ``s`` new tokens, each continuing from its own
    incoming state, at each chunk length of ``chunks``. Inputs (q, k, v, g,
    beta, state), as the mixer gives them: q and k L2-normalised (q scaled
    by dk^-1/2), v normal, g = -A softplus(z + dt_bias) with A in [1, 16]
    per head, softplus(dt_bias) log-uniform in [1e-3, 1e-1] per channel and
    z normal with std 0.2, beta = sigmoid(normal), the state normal. A
    thunk returns (o, final state); the widths default to
    kimi-linear-48b-a3b's."""
    dev = resolve_device(device)

    def inputs(seed: int):
        gen = torch.Generator(device=dev).manual_seed(seed)

        def normal(*shape):
            return torch.randn(shape, generator=gen, device=dev)

        q = l2_normalize(normal(b, s, h, dk)) * dk ** -0.5
        k = l2_normalize(normal(b, s, h, dk))
        v = normal(b, s, h, dv)
        a = torch.rand((h, 1), generator=gen, device=dev) * 15.0 + 1.0
        rate = torch.exp(torch.rand((h, dk), generator=gen, device=dev) * math.log(100.0) + math.log(1e-3))
        dt_bias = rate + torch.log(-torch.expm1(-rate))                 # softplus⁻¹(rate)
        g = -a * torch.nn.functional.softplus(normal(b, s, h, dk) * 0.2 + dt_bias)
        beta = torch.sigmoid(normal(b, s, h))
        state = normal(b, h, dk, dv)
        return [t.to(dtype) for t in (q, k, v, g, beta, state)]

    def make(chunk):
        def build(q, k, v, g, beta, state):
            return measured_thunk(lambda *t: kda_chunked(*t[:5], chunk, t[5]), q, k, v, g, beta, state)
        return build

    return VariantSite(
        name=f"kda_chunk[b{b} s{s} h{h} dk{dk}]",
        variants=tuple(Variant(f"chunk_{c}", kda_chunk_flops(b, s, h, dk, dv, c), make(c), {"chunk": c})
                       for c in chunks),
        make_inputs=inputs,
    )


# ---------------------------------------------------------- matmul site ----

def matmul_blocks_site(
    m: int = 1024, k: int = 1024, n: int = 1024,
    blocks: Sequence[tuple] = ((64, 64, 64), (128, 128, 8), (128, 128, 16)),
    dtype: torch.dtype = torch.float32,
    device: DeviceLike = "cuda",
) -> VariantSite:
    """Tile shapes of the hand GEMM against ``torch.matmul``. ``blocks``
    must be supported tiles (:data:`~repro_torch.kernels.matmul.matmul.SUPPORTED_TILES`;
    the default is three of them), checked here before anything runs."""
    for tile in blocks:
        check_tile(*tile)
    dev = resolve_device(device)

    def inputs(seed: int):
        gen = torch.Generator().manual_seed(seed)
        a = torch.randn((m, k), generator=gen).to(device=dev, dtype=dtype)
        b_ = torch.randn((k, n), generator=gen).to(device=dev, dtype=dtype)
        return [a, b_]

    f = 2.0 * m * k * n

    def make(bm, bn, bk):
        def build(a, b_):
            return measured_thunk(
                lambda a, b_: matmul(a, b_, block_m=bm, block_n=bn, block_k=bk),
                a, b_,
            )
        return build

    variants = tuple(
        Variant(f"blocks_{bm}x{bn}x{bk}", f, make(bm, bn, bk),
                {"tiles": (bm, bn, bk)})
        for bm, bn, bk in blocks
    ) + (
        Variant("torch_matmul", f, lambda a, b_: measured_thunk(torch.matmul, a, b_)),
    )
    return VariantSite(
        name=f"matmul[{m}x{k}x{n}]", variants=variants, make_inputs=inputs
    )

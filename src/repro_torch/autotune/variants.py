"""Variant sites: sets of mathematically equivalent implementations.

A :class:`VariantSite` is the framework's unit of algorithm choice — the
exact object the paper's methodology ranks. Every variant carries an
analytic FLOP count, so the FLOPs-discriminant test applies directly.

This slice of the port carries one site:

* ``matmul_blocks`` — the hand-written Hopper GEMM's tile shapes plus the
  library baseline ``torch_matmul`` (cuBLAS; the reference's ``xla_dot``):
  equal FLOPs exactly.

The attention, MoE-dispatch and SSD-chunk sites come with the slices that
port their models.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Sequence

import torch

from ..device import DeviceLike, block, resolve_device
from ..kernels.matmul.matmul import check_tile
from ..kernels.matmul.ops import matmul

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
        tensors = self.make_inputs(seed)
        table: Dict[str, Thunk] = {}
        for v in self.variants:
            thunk = v.build(*tensors)
            if warmup:
                thunk()
            table[v.name] = thunk
        return table


def _thunk(fn, *tensors):
    """Run ``fn`` once (warm-up) and return a thunk that runs it and waits
    for the result (``torch.cuda.synchronize()`` on the card)."""
    block(fn(*tensors))

    def run():
        return block(fn(*tensors))

    return run


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
            return _thunk(
                lambda a, b_: matmul(a, b_, block_m=bm, block_n=bn, block_k=bk),
                a, b_,
            )
        return build

    variants = tuple(
        Variant(f"blocks_{bm}x{bn}x{bk}", f, make(bm, bn, bk),
                {"tiles": (bm, bn, bk)})
        for bm, bn, bk in blocks
    ) + (
        Variant("torch_matmul", f, lambda a, b_: _thunk(torch.matmul, a, b_)),
    )
    return VariantSite(
        name=f"matmul[{m}x{k}x{n}]", variants=variants, make_inputs=inputs
    )

"""Gradient compression with error feedback (int8 / sign-SGD style), the
reference's ``distributed/compression.py`` on ``torch.distributed``.

At 1000+-node scale the cross-pod gradient all-reduce is the scaling
bottleneck; 4x (int8) compression with error feedback keeps convergence
(Seide et al. 2014; Karimireddy et al. 2019 — EF-SGD). Three layers:

* pure quantisation ops (`quantize_int8` / `dequantize_int8`) — per-leaf
  symmetric scaling, exactly invertible modulo rounding;
* :class:`ErrorFeedback` — carries the quantisation residual into the next
  step so compression error does not accumulate (sum over steps telescopes);
* ``compressed_psum`` — a data-parallel gradient sync over one mesh
  dimension's process group that all-reduces int8 payloads (sum of
  dequantised shards), run on each rank's local gradients (the reference
  runs it inside ``shard_map``; here inside :func:`repro_torch.launch.compat.shard_map`
  or on plain per-rank tensors).
"""

from __future__ import annotations

from typing import Any, NamedTuple, Tuple

import torch
import torch.distributed as dist

from ..models.layers import tree_map

Pytree = Any


class QuantizedLeaf(NamedTuple):
    q: torch.Tensor        # int8 payload
    scale: torch.Tensor    # f32 scalar (per leaf)


_TINY = torch.finfo(torch.float32).tiny


def quantize_int8(x: torch.Tensor) -> QuantizedLeaf:
    # Subnormals are flushed to zero, in the input and in the scale, as XLA
    # does on CPU and TPU, so a leaf whose largest value is below 127 times
    # the smallest normal float quantises as the reference does: a flushed
    # scale is 0 and every nonzero value goes to +-127.
    xf = x.float()
    xf = torch.where(xf.abs() < _TINY, torch.zeros_like(xf), xf)
    amax = xf.abs().max()
    scale = amax / 127.0
    scale = torch.where(scale < _TINY, torch.zeros_like(scale), scale)
    q = torch.where(scale > 0, torch.clamp(torch.round(xf / scale), -127, 127),
                    127.0 * torch.sign(xf)).to(torch.int8)
    scale = torch.where(amax > 0, scale, torch.ones_like(scale))
    return QuantizedLeaf(q=q, scale=scale)


def dequantize_int8(leaf: QuantizedLeaf) -> torch.Tensor:
    return leaf.q.float() * leaf.scale


def quantize_tree(tree: Pytree) -> Pytree:
    return tree_map(quantize_int8, tree)


def dequantize_tree(tree: Pytree) -> Pytree:
    return tree_map(dequantize_int8, tree)


class ErrorFeedback:
    """e_{t+1} = g_t + e_t - Q(g_t + e_t); apply before quantising."""

    @staticmethod
    def init(grads: Pytree) -> Pytree:
        return tree_map(lambda g: torch.zeros(g.shape, dtype=torch.float32, device=g.device), grads)

    @staticmethod
    def compress(grads: Pytree, residual: Pytree) -> Tuple[Pytree, Pytree]:
        """Returns (quantized tree, new residual)."""
        corrected = tree_map(lambda g, e: g.float() + e, grads, residual)
        quantized = quantize_tree(corrected)
        recon = dequantize_tree(quantized)
        new_residual = tree_map(lambda c, r: c - r, corrected, recon)
        return quantized, new_residual


def compressed_psum(grads: Pytree, axis_name: str, mesh: Any) -> Pytree:
    """Data-parallel sync over ``mesh``'s dimension ``axis_name``: quantise
    locally, all-reduce, dequantise.

    Payload over the wire is int8 values carried in int32 (the sum of
    ranks' int8 payloads needs the headroom). Precision note: a sum of int8
    payloads requires a shared scale — the max scale across the axis (one
    f32 all-reduce of a scalar per leaf), then each rank requantises
    against it and the int32 payloads are summed.
    """
    group = mesh.get_group(axis_name)

    def sync(g: torch.Tensor) -> torch.Tensor:
        scale = quantize_int8(g).scale.clone()
        dist.all_reduce(scale, op=dist.ReduceOp.MAX, group=group)
        # requantise against the shared scale so the sum is coherent
        total = torch.clamp(torch.round(g.float() / scale), -127, 127).to(torch.int8).to(torch.int32)
        dist.all_reduce(total, op=dist.ReduceOp.SUM, group=group)
        return total.float() * scale

    return tree_map(sync, grads)

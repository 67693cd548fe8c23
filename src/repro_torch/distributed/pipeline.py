"""Pipeline parallelism: GPipe-style microbatch schedule over a stage axis
(the reference's ``distributed/pipeline.py`` on ``torch.distributed``).

Not part of the default mesh (the assigned cells fit without PP and a stage
axis strictly increases the collective term for them), but the required
posture for models larger than one device's memory. Each rank of the mesh
dimension ``stage`` runs its stage; the reference's schedule runs M
microbatches over S stages in M+S-1 ticks (bubble fraction
(S-1)/(M+S-1)): at tick t stage 0 injects microbatch t, every stage applies
its function to what it holds, the last stage commits microbatch t-S+1,
and the activations move one stage on with ``batch_isend_irecv`` (the
reference's ``ppermute``). At the end an ``all_gather`` over the stage
dimension hands every rank the last stage's outputs (the reference's
replicated ``out_specs``).

The schedule is written out here rather than taken from
``torch.distributed.pipelining``, so the tick structure and the exact
equality with the sequential stages carry over (tests/test_torch_pipeline.py).
It runs forward only, as the reference's.
"""

from __future__ import annotations

from typing import Any, Callable

import torch
import torch.distributed as dist

from ..launch.compat import DTensor
from ..models.layers import tree_map

Pytree = Any


def _local(x: torch.Tensor) -> torch.Tensor:
    return x.to_local() if isinstance(x, DTensor) else x


def pipeline_apply(
    stage_fn: Callable[[Pytree, torch.Tensor], torch.Tensor],
    stage_params: Pytree,          # leaves stacked [S, ...] (or each rank's [1, ...] shard as a DTensor)
    microbatches: torch.Tensor,    # [M, mb, ...] (same shape through stages), the same on every rank
    mesh: Any,
    stage_axis: str = "stage",
) -> torch.Tensor:
    """Run ``x -> stage_fn(p_S-1, ... stage_fn(p_0, x))`` pipelined.

    Returns [M, mb, ...] outputs on every rank. ``stage_fn`` must preserve
    the activation shape (standard for transformer blocks).
    """
    group = mesh.get_group(stage_axis)
    n_stages = dist.get_world_size(group)
    stage_id = dist.get_rank(group)
    micro = _local(microbatches)
    m = micro.shape[0]
    ticks = m + n_stages - 1

    def here(p):
        # a DTensor sharded over the stage axis holds this stage's [1, ...];
        # a plain tensor holds every stage's
        return _local(p)[0] if isinstance(p, DTensor) else p[stage_id]

    params_here = tree_map(here, stage_params)
    nxt = dist.get_global_rank(group, (stage_id + 1) % n_stages)
    prv = dist.get_global_rank(group, (stage_id - 1) % n_stages)

    inflight = torch.zeros(micro.shape[1:], dtype=micro.dtype, device=micro.device)
    outputs = torch.zeros_like(micro)
    for t in range(ticks):
        # stage 0 injects microbatch t (clamped reads are masked by the
        # commit window on the last stage)
        x_in = micro[min(t, m - 1)] if stage_id == 0 else inflight
        y = stage_fn(params_here, x_in)
        # last stage commits its result for microbatch (t - S + 1)
        if stage_id == n_stages - 1 and t >= n_stages - 1:
            outputs[t - (n_stages - 1)] = y
        # move activations to the next stage (a stage of one keeps its own)
        if n_stages == 1:
            inflight = y
            continue
        recv = torch.empty_like(y)
        ops = [dist.P2POp(dist.isend, y.contiguous(), nxt, group),
               dist.P2POp(dist.irecv, recv, prv, group)]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        inflight = recv

    # only the last stage's `outputs` is real; all_gather over the stage
    # dimension hands it to every rank
    gathered = torch.empty((n_stages * m,) + tuple(outputs.shape[1:]), dtype=outputs.dtype, device=outputs.device)
    dist.all_gather_into_tensor(gathered, outputs.contiguous(), group=group)
    return gathered[(n_stages - 1) * m:]


def bubble_fraction(n_stages: int, n_micro: int) -> float:
    """GPipe bubble overhead: (S-1) / (M + S - 1)."""
    return (n_stages - 1) / (n_micro + n_stages - 1)

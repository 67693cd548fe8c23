"""The plain reference that decides ``correct``, and its comparisons.

Plain PyTorch, in float64, importing nothing of the program: the chain's
product left to right, the SSD as a sequential scan one token at a time,
and the FLOPs-discriminant rule of the paper recomputed from a verdict's
FLOP table and ranks. The program's outputs are what is judged; the
reference reads them only to judge them.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Sequence

import torch


def chain_product(mats: Sequence[torch.Tensor]) -> torch.Tensor:
    """M0 M1 … in float64, left to right."""
    out = mats[0].double()
    for m in mats[1:]:
        out = out @ m.double()
    return out


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, a_log: torch.Tensor,
             bm: torch.Tensor, cm: torch.Tensor) -> torch.Tensor:
    """y [b, s, h, p] of the SSD recurrence in float64, one token at a time:
    state <- exp(dt·A)·state + (dt·x) ⊗ B, y = state · C, A = -exp(a_log)."""
    b, s, h, p = x.shape
    hg = h // bm.shape[2]
    a = -torch.exp(a_log.double())
    x, dt = x.double(), dt.double()
    bm = bm.double().repeat_interleave(hg, dim=2)  # [b, s, h, n]
    cm = cm.double().repeat_interleave(hg, dim=2)
    state = torch.zeros((b, h, p, bm.shape[-1]), dtype=torch.float64, device=x.device)
    y = torch.empty((b, s, h, p), dtype=torch.float64, device=x.device)
    for t in range(s):
        decay = torch.exp(dt[:, t] * a)                                  # [b, h]
        state = state * decay[:, :, None, None] \
            + (x[:, t] * dt[:, t, :, None])[..., None] * bm[:, t, :, None, :]
        y[:, t] = (state * cm[:, t, :, None, :]).sum(-1)
    return y


def tf32(t: torch.Tensor) -> torch.Tensor:
    """``t`` in float32 rounded to TF32 (10 mantissa bits, to nearest even):
    what the tensor cores take from an f32 operand when TF32 is on."""
    bits = t.float().contiguous().view(torch.int32)
    bits = (bits + 0xFFF + ((bits >> 13) & 1)) & -0x2000
    return bits.view(torch.float32)


def chain_tf32(mats: Sequence[torch.Tensor]) -> torch.Tensor:
    """The control: the chain's product left to right with every GEMM in
    TF32 (operands rounded to TF32, products summed in float32)."""
    out = mats[0].float()
    for m in mats[1:]:
        out = tf32(out) @ tf32(m)
    return out


def ssd_scan_tf32(x: torch.Tensor, dt: torch.Tensor, a_log: torch.Tensor,
                  bm: torch.Tensor, cm: torch.Tensor) -> torch.Tensor:
    """The control: :func:`ssd_scan` in float32 with the operands of its two
    products, (dt·x) ⊗ B and state · C, rounded to TF32."""
    b, s, h, p = x.shape
    hg = h // bm.shape[2]
    a = -torch.exp(a_log.float())
    bm = tf32(bm.repeat_interleave(hg, dim=2))
    cm = tf32(cm.repeat_interleave(hg, dim=2))
    state = torch.zeros((b, h, p, bm.shape[-1]), dtype=torch.float32, device=x.device)
    y = torch.empty((b, s, h, p), dtype=torch.float32, device=x.device)
    for t in range(s):
        decay = torch.exp(dt[:, t].float() * a)
        state = state * decay[:, :, None, None] \
            + tf32(x[:, t] * dt[:, t, :, None])[..., None] * bm[:, t, :, None, :]
        y[:, t] = (tf32(state) * cm[:, t, :, None, :]).sum(-1)
    return y


def rel_max_err(out: torch.Tensor, ref: torch.Tensor) -> float:
    """max |out − ref| over max |ref|. A NaN or a shape that differs reads
    as infinitely wrong."""
    if tuple(out.shape) != tuple(ref.shape):
        return float("inf")
    err = ((out.to(ref.device).double() - ref).abs().max() / ref.abs().max()).item()
    return err if err == err else float("inf")


def verdict(flops: Mapping[str, float], ranks: Mapping[str, int]) -> Optional[Dict]:
    """The FLOPs-discriminant verdict of a ranking (paper Sec. I): the
    minimum-FLOPs algorithms that were ranked must all hold the best class.
    None where no minimum-FLOPs algorithm was ranked."""
    least = min(flops.values())
    sf = [name for name in sorted(flops) if flops[name] <= least and name in ranks]
    if not sf:
        return None
    best = min(ranks.values())
    best_sf = min(ranks[name] for name in sf)
    if best_sf > best:
        reason = "faster_outside_min_flops"
    elif len({ranks[name] for name in sf}) > 1:
        reason = "min_flops_split"
    else:
        reason = "none"
    return {"min_flops_algs": sf, "best_rank_in_sf": best_sf, "best_rank_overall": best,
            "is_anomaly": reason != "none", "reason": reason}


def verdict_faults(flops: Mapping[str, float], port_flops: Mapping[str, float],
                   ranks: Mapping[str, int], port: Mapping) -> int:
    """How many of a verdict's reported fields disagree with the reference:
    the FLOP table, the minimum-FLOPs set, both best ranks, the anomaly flag
    and its reason."""
    faults = int({k: float(v) for k, v in port_flops.items()}
                 != {k: float(v) for k, v in flops.items()})
    ref = verdict(flops, ranks)
    if ref is None:
        return faults + 1
    return faults + sum(int(port[key] != ref[key]) if key != "min_flops_algs"
                        else int(sorted(port[key]) != ref[key]) for key in ref)

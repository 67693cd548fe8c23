"""Mixture-of-Experts FFN with two mathematically equivalent dispatches (the
reference's ``models/moe.py``).

* ``gather`` — capacity-based token-choice dispatch: top-k routing, position
  within expert by a stable sort, gather [E, C, d] -> expert GEMMs ->
  weighted scatter-add. FLOPs proportional to *active* parameters. Tokens
  overflowing an expert's capacity are dropped (GShard semantics).
* ``dense`` — every token runs every expert; routing weights (zero for
  unselected experts) combine the results: ~E/top_k x the FLOPs, no
  gather/scatter. With no capacity drops the two agree up to rounding.

The dispatch runs per GROUP (= batch row) with a per-group capacity, as the
reference's ``vmap`` over rows does; here the groups are a leading batch
dimension of one computation (:func:`_gather_groups`), so the expert weights
are read once for all groups. JAX's out-of-bounds scatters (``mode="drop"``)
become writes into a spare column that is sliced away: no boolean masking,
no sort and no ``bincount``, so nothing waits for the device.

The port's own additions: a sigmoid router (``moe_router``; each expert's
score alone, the top-k renormalised, as Kimi's), a scale on the routed
experts' weights (``moe_routed_scale``), and a layer told which experts it
holds (``experts_held`` = (lo, hi), expert parallelism's share): it routes
over all ``n_experts``, holds the weights of its own, and adds only their
part of the result; the shared expert is computed on every share alike.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .config import ModelConfig
from .layers import Params, constrain, gelu_tanh, is_dtensor, normal_init, param_dtype


def init_moe(cfg: ModelConfig, gen: torch.Generator) -> Params:
    dt = param_dtype(cfg)
    e, d, f = cfg.n_experts_held, cfg.d_model, cfg.resolved_moe_d_ff
    out_std = 0.02 / np.sqrt(2 * cfg.n_layers)
    params: Params = {
        "router": normal_init(gen, (d, cfg.n_experts), ("embed", None), dt),
        "wi": normal_init(gen, (e, d, f), ("experts", "embed", "moe_ffn"), dt),
        "wg": normal_init(gen, (e, d, f), ("experts", "embed", "moe_ffn"), dt),
        "wo": normal_init(gen, (e, f, d), ("experts", "moe_ffn", "embed"), dt, out_std),
    }
    if cfg.n_shared_experts > 0:
        sf = cfg.resolved_shared_d_ff
        params["shared"] = {
            "wi": normal_init(gen, (d, sf), ("embed", "ffn"), dt),
            "wg": normal_init(gen, (d, sf), ("embed", "ffn"), dt),
            "wo": normal_init(gen, (sf, d), ("ffn", "embed"), dt, out_std),
        }
        if cfg.moe_shared_gate:
            params["shared"]["gate"] = normal_init(gen, (d, 1), ("embed", None), dt)
    return params


def _one_hot(i: torch.Tensor, n: int) -> torch.Tensor:
    """``i``'s one-hot over ``n`` classes as a comparison (``F.one_hot``
    checks the indices' range on the host, a device sync)."""
    return i[..., None] == torch.arange(n, device=i.device)


def _routing(
    cfg: ModelConfig, params: Params, x: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Router on [..., T, d]: probs [..., T, E], top-k weights [..., T, k],
    indices [..., T, k], aux loss [...] (one per group)."""
    logits = x.float() @ params["router"].float()
    probs = torch.sigmoid(logits) if cfg.moe_router == "sigmoid" else torch.softmax(logits, dim=-1)
    top_w, top_i = torch.topk(probs, cfg.top_k, dim=-1, sorted=True)  # jax.lax.top_k
    if cfg.moe_norm_topk:
        top_w = top_w / top_w.sum(dim=-1, keepdim=True)
    if cfg.moe_routed_scale != 1.0:
        top_w = top_w * cfg.moe_routed_scale
    # Switch-style load-balance aux loss: the share of assignments each
    # expert takes (counted as integers) against its mean probability.
    e = cfg.n_experts
    counts = _one_hot(top_i, e).sum(dim=(-3, -2))                # [..., E]
    frac_tokens = counts / top_i.shape[-2]
    frac_probs = probs.mean(dim=-2)                              # [..., E]
    aux = e * (frac_tokens * frac_probs).sum(dim=-1)
    return probs, top_w, top_i, aux


def _expert_ffn(cfg: ModelConfig, params: Params, xe: torch.Tensor) -> torch.Tensor:
    """Per-expert gated FFN on [E, N, d] -> [E, N, d]."""
    h = torch.bmm(xe, params["wi"].to(xe.dtype))
    g = torch.bmm(xe, params["wg"].to(xe.dtype))
    h = (gelu_tanh(g) if cfg.activation == "geglu" else F.silu(g)) * h
    return torch.bmm(h, params["wo"].to(xe.dtype))


def capacity(cfg: ModelConfig, t: int) -> int:
    """Slots per expert for a group of ``t`` tokens (the reference's formula)."""
    c = int(np.ceil(t * cfg.top_k * cfg.moe_capacity_factor / cfg.n_experts))
    return max(4, min(t, (c + 3) // 4 * 4))


def dispatch_table(cfg: ModelConfig, top_i: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The dispatch table of each group from ``top_i`` [G, T, k]: the token
    in each (expert, slot), [G, E, C], T where the slot is unfilled; and
    each assignment's slot within its expert, [G, T*k], C where it is
    dropped.

    An assignment's position is the number of earlier assignments (in
    token-major order) to its expert: the rank within the expert's run that
    the reference takes from a stable argsort, here a running count of a
    one-hot, which needs no sort and reads nothing back to the host. An
    assignment at or past the capacity C goes to the spare column C, which
    the table leaves out (the reference's dropped write)."""
    g, t, k = top_i.shape
    e, cap = cfg.n_experts, capacity(cfg, t)
    flat_e = top_i.reshape(g, t * k)
    running = torch.cumsum(_one_hot(flat_e, e), dim=1)           # [G, T*k, E]
    slot = torch.clamp(torch.gather(running, 2, flat_e[..., None])[..., 0] - 1, max=cap)
    token_of = torch.arange(t * k, device=top_i.device).div_(k, rounding_mode="floor").expand(g, -1)
    disp = torch.full((g, e * (cap + 1)), t, dtype=torch.int64, device=top_i.device)
    disp.scatter_(1, flat_e * (cap + 1) + slot, token_of)
    return disp.view(g, e, cap + 1)[:, :, :cap], slot


def _gather_groups(cfg: ModelConfig, params: Params, x: torch.Tensor,
                   experts: Optional[Tuple[int, int]] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Capacity-based gather dispatch of every group at once: x [G, T, d] ->
    ([G, T, d], aux [G]); the shared expert is not added here.

    The experts see their slots as one [E, G*C, d] batch. The combine reads
    each assignment's output row back from its (expert, group, slot), a zero
    row where it was dropped, and sums a token's k rows weighted: the terms
    of the reference's scatter-add into the sentinel-padded [T+1, d] buffer,
    added in a fixed order (no atomics), so a run repeats bit for bit.

    ``experts`` = (lo, hi) (``cfg.experts_held`` by default) runs only
    experts lo..hi-1 (the ones whose weights ``params`` holds) and gives
    the others' assignments a zero row: each rank's share of an
    expert-parallel layer, summed across the ranks."""
    g, t, d = x.shape
    e, k, cap = cfg.n_experts, cfg.top_k, capacity(cfg, t)
    lo, hi = experts or cfg.experts_held or (0, e)
    _, top_w, top_i, aux = _routing(cfg, params, x)
    disp, slot = dispatch_table(cfg, top_i)                      # [G, E, C], [G, T*k]
    groups = torch.arange(g, device=x.device)

    # gather: row T of each group is the zero sentinel of unfilled slots
    x_pad = torch.cat([x, x.new_zeros((g, 1, d))], dim=1).view(g * (t + 1), d)
    rows = (disp[:, lo:hi] + (groups * (t + 1))[:, None, None]).transpose(0, 1).reshape(-1)
    ye = _expert_ffn(cfg, params, x_pad.index_select(0, rows).view(hi - lo, g * cap, d))

    # combine: slot C of each (expert, group) is a zero row for dropped
    # ones, and the last row a zero row for experts held elsewhere
    n = hi - lo
    ye = torch.cat([ye.view(n, g, cap, d), ye.new_zeros((n, g, 1, d))], dim=2).view(-1, d)
    flat_e = top_i.reshape(g, t * k)
    rows = (flat_e - lo) * (g * (cap + 1)) + (groups * (cap + 1))[:, None] + slot
    if n != e:
        ye = torch.cat([ye, ye.new_zeros((1, d))])
        rows = torch.where((flat_e >= lo) & (flat_e < hi), rows, n * g * (cap + 1))
    rows = rows.reshape(-1)
    out = ye.index_select(0, rows).view(g, t, k, d) * top_w.to(x.dtype)[..., None]
    return out.sum(dim=2), aux


def _expert_split(cfg: ModelConfig, params: Params, x: torch.Tensor):
    """How a DTensor MoE layer splits across the mesh: (mesh, the expert
    weights' placements, the mesh dimensions that split them, the tokens'
    placements: each group's tokens whole wherever the weights are split,
    the output's: a partial sum over those dimensions, their ranks' count,
    this rank's experts (lo, hi) or None when experts are not split)."""
    from ..launch.compat import Partial, Replicate, Shard

    mesh = x.device_mesh
    w_pl = {k: tuple(params[k].placements) for k in ("wi", "wg", "wo")}
    split = [i for i, p in enumerate(w_pl["wi"]) if not p.is_replicate()]
    x_pl = tuple(Shard(0) if p.is_shard(0) and i not in split else Replicate()
                 for i, p in enumerate(x.placements))
    y_pl = tuple(Partial() if i in split else p for i, p in enumerate(x_pl))
    n_split = int(np.prod([mesh.size(i) for i in split]))
    coord = mesh.get_coordinate()
    e_split = [i for i in split if w_pl["wi"][i].is_shard(0)]
    e_local, idx = cfg.n_experts, 0
    for i in e_split:
        e_local //= mesh.size(i)
        idx = idx * mesh.size(i) + coord[i]
    experts = (idx * e_local, (idx + 1) * e_local) if e_split else None
    return mesh, w_pl, split, x_pl, y_pl, n_split, experts


def _gather_groups_sharded(cfg: ModelConfig, params: Params, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`_gather_groups` on DTensors: each rank dispatches its own
    groups (batch rows) locally, as the reference's GSPMD keeps the
    batch-sharded dispatch (DTensor has no sharding rule for the dispatch's
    scatter and index ops). The expert weights come in as each rank holds
    them after the ZeRO gather: experts split over a mesh dimension
    (expert parallelism) or their d_ff split (tensor parallelism); either
    way the output is a partial sum over that dimension."""
    from ..launch.compat import Replicate, shard_map

    mesh, w_pl, _, x_pl, y_pl, n_split, experts = _expert_split(cfg, params, x)
    # every rank of a split dimension computes the same aux loss: a partial
    # sum of its share keeps each rank's gradient through it one share
    aux_pl = y_pl

    def local(x_l, router, wi, wg, wo):
        y, aux = _gather_groups(cfg, {"router": router, "wi": wi, "wg": wg, "wo": wo}, x_l, experts)
        return y, aux / n_split

    rep = tuple(Replicate() for _ in x_pl)
    fn = shard_map(local, mesh=mesh, in_placements=(x_pl, rep, w_pl["wi"], w_pl["wg"], w_pl["wo"]),
                   out_placements=[y_pl, aux_pl])
    return fn(x, params["router"], params["wi"], params["wg"], params["wo"])


def _dense_sharded(cfg: ModelConfig, params: Params, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`moe_dense` on DTensors x [b, s, d]: each rank runs its own
    batch rows through its own experts (or its share of every expert's
    d_ff) with the routing weights of those experts, and the outputs are a
    partial sum over the dimensions that split the weights. The aux loss is
    the unsharded one, over all b*s tokens: each rank returns its tokens'
    expert counts and summed probabilities as partial sums (over the batch
    dimensions, and a 1/n share over the weight-splitting ones, whose ranks
    route the same tokens), and the loss is formed from their totals."""
    from ..launch.compat import Partial, Replicate, shard_map

    mesh, w_pl, split, x_pl, y_pl, n_split, experts = _expert_split(cfg, params, x)
    stat_pl = tuple(Partial() if i in split or p.is_shard() else Replicate() for i, p in enumerate(x_pl))
    e = cfg.n_experts

    def local(x_l, router, wi, wg, wo):
        b, s, d = x_l.shape
        x2d = x_l.reshape(b * s, d)
        probs, top_w, top_i, _ = _routing(cfg, {"router": router}, x2d)
        combine = torch.zeros((b * s, e), dtype=torch.float32, device=x2d.device)
        combine.scatter_add_(1, top_i, top_w.float())            # [T, E]
        lo, hi = experts or (0, e)
        ye = _expert_ffn(cfg, {"wi": wi, "wg": wg, "wo": wo}, x2d[None].expand(hi - lo, b * s, d))
        y = torch.einsum("etd,te->td", ye.float(), combine[:, lo:hi]).to(x2d.dtype)
        counts = _one_hot(top_i, e).sum(dim=(0, 1)).float()
        return y.reshape(b, s, d), counts / n_split, probs.sum(dim=0) / n_split

    rep = tuple(Replicate() for _ in x_pl)
    fn = shard_map(local, mesh=mesh, in_placements=(x_pl, rep, w_pl["wi"], w_pl["wg"], w_pl["wo"]),
                   out_placements=[y_pl, stat_pl, stat_pl])
    y, counts, prob_sums = fn(x, params["router"], params["wi"], params["wg"], params["wo"])
    t = x.shape[0] * x.shape[1]
    aux = e * ((counts / t) * (prob_sums / t)).sum()
    return y, aux


def moe_gather(cfg: ModelConfig, params: Params, x2d: torch.Tensor,
               shardings=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Capacity-based gather dispatch. x2d [T, d] -> ([T, d], aux)."""
    params = _pin(params, shardings)
    out, aux = _gather_groups(cfg, params, x2d[None])
    out = out[0]
    if cfg.n_shared_experts > 0:
        out = out + _shared_expert(cfg, params["shared"], x2d)
    return out, aux[0]


def moe_dense(cfg: ModelConfig, params: Params, x2d: torch.Tensor,
              shardings=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dense dispatch: all tokens x all experts, combine by routing weight."""
    params = _pin(params, shardings)
    t, d = x2d.shape
    e = cfg.n_experts
    lo, hi = cfg.experts_held or (0, e)
    _, top_w, top_i, aux = _routing(cfg, params, x2d)
    combine = torch.zeros((t, e), dtype=torch.float32, device=x2d.device)
    combine.scatter_add_(1, top_i, top_w.float())                # [T, E]

    ye = _expert_ffn(cfg, params, x2d[None].expand(hi - lo, t, d))  # [E held, T, d]
    out = torch.einsum("etd,te->td", ye.float(), combine[:, lo:hi]).to(x2d.dtype)

    if cfg.n_shared_experts > 0:
        out = out + _shared_expert(cfg, params["shared"], x2d)
    return out, aux


def _shared_expert(cfg: ModelConfig, sp: Params, x: torch.Tensor) -> torch.Tensor:
    h = x @ sp["wi"].to(x.dtype)
    g = x @ sp["wg"].to(x.dtype)
    y = (F.silu(g) * h) @ sp["wo"].to(x.dtype)
    if not cfg.moe_shared_gate:
        return y
    gate = torch.sigmoid(x.float() @ sp["gate"].float()).to(x.dtype)
    return y * gate


def _pin(params: Params, shardings: Optional[dict]) -> Params:
    """The expert weights laid out by their compute-time shardings
    (dict wi/wg/wo -> sharding), the reference's pin of ZeRO-stored
    weights; the params as they are when there are none."""
    if not shardings:
        return params
    params = dict(params)
    for k in ("wi", "wg", "wo"):
        if shardings.get(k) is not None:
            params[k] = constrain(params[k], shardings[k])
    return params


def apply_moe(
    cfg: ModelConfig,
    params: Params,
    x: torch.Tensor,                  # [b, s, d]
    dispatch: str = "gather",
    shardings: Optional[dict] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dispatch per GROUP (= batch row), GShard-style: each row has its own
    capacity, as in the reference. Returns (y [b, s, d], mean aux)."""
    params = _pin(params, shardings)
    b, s, d = x.shape
    if dispatch == "gather":
        y, aux = (_gather_groups_sharded if is_dtensor(x) else _gather_groups)(cfg, params, x)
        if cfg.n_shared_experts > 0:
            y = y + _shared_expert(cfg, params["shared"], x)
        return y, aux.mean()
    if dispatch == "dense":
        if is_dtensor(x):
            y, aux = _dense_sharded(cfg, params, x)
            if cfg.n_shared_experts > 0:
                y = y + _shared_expert(cfg, params["shared"], x)
            return y, aux
        y, aux = moe_dense(cfg, params, x.reshape(b * s, d))
        return y.reshape(b, s, d), aux
    raise ValueError(f"unknown MoE dispatch {dispatch!r}")

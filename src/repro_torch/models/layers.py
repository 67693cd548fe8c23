"""Primitive layers: params-with-logical-axes, norms, RoPE, MLPs, embeddings
(the reference's ``models/layers.py``).

Parameters are plain nested dicts of tensors. During initialisation each
leaf is a :class:`P` carrying its *logical axis names* (e.g.
``("embed", "ffn")``); :func:`split_params` separates the value tree from
the axis tree. The trees, names and axes are the reference's, so weights
carry across as a tree map (:func:`params_from_numpy`).

Initialisation draws from an explicit ``torch.Generator`` on the target
device, one draw after another: where the reference splits a ``jax.random``
key, the port takes the generator's next numbers. The values differ from
the reference's by design; parity tests carry the reference's weights
across.
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from ..device import DeviceLike, resolve_device
from .config import ModelConfig

Params = Dict[str, Any]
Axes = Tuple[Optional[str], ...]


@dataclass
class P:
    """A parameter leaf paired with logical axis names (len == ndim)."""

    value: torch.Tensor
    axes: Axes

    def __post_init__(self) -> None:
        if len(self.axes) != self.value.ndim:
            raise ValueError(
                f"axes {self.axes} rank != value rank {tuple(self.value.shape)}"
            )


def tree_map(fn: Callable[..., Any], tree: Any, *rest: Any) -> Any:
    """``fn`` on every leaf of a tree of nested dicts (a non-dict is a leaf),
    with the leaves at the same keys of the trees ``rest`` as its further
    arguments (``jax.tree.map``'s form)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    return fn(tree, *rest)


def tree_leaves(tree: Any) -> list:
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in tree_leaves(v)]
    return [tree]


def split_params(tree: Any) -> Tuple[Any, Any]:
    """(values, axes) trees from a tree of :class:`P` leaves."""
    return tree_map(lambda p: p.value, tree), tree_map(lambda p: p.axes, tree)


def torch_dtype(name: Union[str, torch.dtype]) -> torch.dtype:
    """``torch.float32`` for ``"float32"``, and so on (a dtype passes)."""
    if isinstance(name, torch.dtype):
        return name
    dtype = getattr(torch, str(name), None)
    if not isinstance(dtype, torch.dtype):
        raise ValueError(f"unknown dtype {name!r}")
    return dtype


def param_dtype(cfg: ModelConfig) -> torch.dtype:
    return torch_dtype(cfg.param_dtype)


def compute_dtype(cfg: ModelConfig) -> torch.dtype:
    return torch_dtype(cfg.dtype)


def params_from_numpy(tree: Any, device: DeviceLike = "cuda",
                      dtype: Optional[Union[str, torch.dtype]] = None) -> Any:
    """The port's value tree from the reference's as numpy arrays (stacked
    units included): every leaf a tensor on ``device``, with the leaf's
    own dtype, or ``dtype`` for every floating-point leaf when given.
    bfloat16 leaves (numpy's ``ml_dtypes`` extension type) carry their bits
    across unchanged."""
    dev = resolve_device(device)
    cast = torch_dtype(dtype) if dtype is not None else None

    def leaf(a):
        a = np.array(a)  # a writable copy of the reference's (read-only) buffer
        if a.dtype.name == "bfloat16":
            t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
        else:
            t = torch.from_numpy(a)
        if cast is not None and t.is_floating_point():
            t = t.to(cast)
        return t.to(dev)

    return tree_map(leaf, tree)


# ------------------------------------------------------------------ init ---

def normal_init(
    gen: torch.Generator,
    shape: Sequence[int],
    axes: Axes,
    dtype: torch.dtype,
    stddev: float = 0.02,
) -> P:
    """``stddev`` times a standard normal truncated to [-2, 2], drawn in f32
    on the generator's device and cast to ``dtype`` (on the ``meta`` device
    nothing is drawn)."""
    v = torch.empty(tuple(shape), dtype=torch.float32, device=gen.device)
    if v.is_meta:
        return P(v.to(dtype), tuple(axes))
    torch.nn.init.trunc_normal_(v, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return P(v.mul_(stddev).to(dtype), tuple(axes))


def zeros_init(shape: Sequence[int], axes: Axes, dtype: torch.dtype, device: torch.device) -> P:
    return P(torch.zeros(tuple(shape), dtype=dtype, device=device), tuple(axes))


def ones_init(shape: Sequence[int], axes: Axes, dtype: torch.dtype, device: torch.device) -> P:
    return P(torch.ones(tuple(shape), dtype=dtype, device=device), tuple(axes))


# ----------------------------------------------------------------- norms ---

def init_norm(cfg: ModelConfig, dims: int, device: torch.device) -> Params:
    dt = param_dtype(cfg)
    if cfg.norm_type == "layernorm":
        return {
            "scale": ones_init((dims,), ("embed",), dt, device),
            "bias": zeros_init((dims,), ("embed",), dt, device),
        }
    # rmsnorm: gemma2 stores (w) and applies (1 + w); init accordingly.
    if cfg.rms_one_offset:
        return {"scale": zeros_init((dims,), ("embed",), dt, device)}
    return {"scale": ones_init((dims,), ("embed",), dt, device)}


def apply_norm(cfg: ModelConfig, params: Params, x: torch.Tensor) -> torch.Tensor:
    """Norm in f32, cast back to the compute dtype."""
    params = gather_dp(params)
    xf = x.float()
    if cfg.norm_type == "layernorm":
        mean = xf.mean(dim=-1, keepdim=True)
        var = xf.var(dim=-1, keepdim=True, correction=0)  # jnp.var: population variance
        y = (xf - mean) * torch.rsqrt(var + cfg.norm_eps)
        y = y * params["scale"].float() + params["bias"].float()
    else:
        ms = xf.square().mean(dim=-1, keepdim=True)
        y = xf * torch.rsqrt(ms + cfg.norm_eps)
        w = params["scale"].float()
        y = y * (1.0 + w) if cfg.rms_one_offset else y * w
    return y.to(x.dtype)


def rms_head_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    """qwen3 qk-norm: RMS over the head_dim of [..., head_dim]."""
    xf = x.float()
    ms = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(ms + eps) * scale.float()).to(x.dtype)


# ------------------------------------------------------------------ RoPE ---

def rope_frequencies(head_dim: int, theta: float) -> np.ndarray:
    return 1.0 / (theta ** (np.arange(0, head_dim, 2, dtype=np.float64) / head_dim))


@functools.lru_cache(maxsize=16)
def _rope_frequencies_on(head_dim: int, theta: float, device: torch.device) -> torch.Tensor:
    """The f32 frequencies on ``device``, copied there once: a copy from the
    host per call would wait for the device's queue at every layer."""
    return torch.tensor(rope_frequencies(head_dim, theta), dtype=torch.float32, device=device)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotate [..., seq, n_heads, head_dim] by position-dependent phases; the
    head splits into halves (not interleaved pairs).

    ``positions`` (on ``x``'s device) broadcasts against the seq dim: shape
    [seq] or [batch, seq].
    """
    freqs = _rope_frequencies_on(x.shape[-1], theta, x.device)
    angles = positions.float()[..., None] * freqs  # [..., s, hd/2]
    cos = torch.cos(angles)[..., None, :]  # broadcast over heads
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


# ------------------------------------------------------------- embedding ---

def init_embedding(cfg: ModelConfig, gen: torch.Generator) -> Params:
    return {
        "table": normal_init(
            gen, (cfg.vocab_size, cfg.d_model), ("vocab", "embed"), param_dtype(cfg)
        )
    }


def embed_tokens(cfg: ModelConfig, params: Params, tokens: torch.Tensor) -> torch.Tensor:
    table = gather_dp(params)["table"].to(compute_dtype(cfg))
    if is_dtensor(table):
        # DTensor's embedding rule keeps the token ids where they are (an
        # index op could gather them) and looks rows up in the vocab shard
        # each rank holds; the masked partial sum is reduced at once.
        x = reduce_partial(F.embedding(tokens.long(), table))
    else:
        x = table[tokens.long()]
    if cfg.embed_scale:
        # the scale rounded to the compute dtype first, as the reference's
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=x.dtype).item()
    return x


def unembed(cfg: ModelConfig, embed_params: Params, head_params: Optional[Params],
            x: torch.Tensor) -> torch.Tensor:
    """Project to vocabulary logits (tied or untied head); f32 logits. The
    table is cast to f32 whole on every call, as in the reference."""
    embed_params, head_params = gather_dp(embed_params), gather_dp(head_params)
    if cfg.tie_embeddings:
        logits = torch.einsum("...d,vd->...v", x.float(), embed_params["table"].float())
    else:
        if head_params is None:
            raise ValueError(f"{cfg.name}: an untied head needs lm_head parameters")
        logits = torch.einsum("...d,dv->...v", x.float(), head_params["w"].float())
    if cfg.final_logit_softcap:
        c = cfg.final_logit_softcap
        logits = c * torch.tanh(logits / c)
    return logits


def init_unembed(cfg: ModelConfig, gen: torch.Generator) -> Optional[Params]:
    if cfg.tie_embeddings:
        return None
    return {
        "w": normal_init(
            gen, (cfg.d_model, cfg.vocab_size), ("embed", "vocab"), param_dtype(cfg)
        )
    }


# ------------------------------------------------------------------- MLP ---

def init_mlp(cfg: ModelConfig, gen: torch.Generator, d_ff: Optional[int] = None) -> Params:
    d_ff = d_ff if d_ff is not None else cfg.d_ff
    dt = param_dtype(cfg)
    out_std = 0.02 / np.sqrt(2 * cfg.n_layers)
    if cfg.activation in ("swiglu", "geglu"):
        return {
            "wi": normal_init(gen, (cfg.d_model, d_ff), ("embed", "ffn"), dt),
            "wg": normal_init(gen, (cfg.d_model, d_ff), ("embed", "ffn"), dt),
            "wo": normal_init(gen, (d_ff, cfg.d_model), ("ffn", "embed"), dt, out_std),
        }
    return {
        "wi": normal_init(gen, (cfg.d_model, d_ff), ("embed", "ffn"), dt),
        "wo": normal_init(gen, (d_ff, cfg.d_model), ("ffn", "embed"), dt, out_std),
    }


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu(approximate=True)``."""
    return F.gelu(x, approximate="tanh")


def apply_mlp(cfg: ModelConfig, params: Params, x: torch.Tensor) -> torch.Tensor:
    h = x @ params["wi"].to(x.dtype)
    if cfg.activation == "swiglu":
        h = F.silu(x @ params["wg"].to(x.dtype)) * h
    elif cfg.activation == "geglu":
        h = gelu_tanh(x @ params["wg"].to(x.dtype)) * h
    else:
        h = gelu_tanh(h)
    return h @ params["wo"].to(x.dtype)


def softcap(x: torch.Tensor, cap: Optional[float]) -> torch.Tensor:
    if cap is None:
        return x
    return cap * torch.tanh(x / cap)


# ------------------------------------------------------------- sharding ---

def constrain(x: torch.Tensor, sharding: Optional[Any]) -> torch.Tensor:
    """``x`` laid out by ``sharding`` (anything with ``mesh`` and
    ``placements``), the reference's ``with_sharding_constraint``: a DTensor
    is redistributed, a plain tensor is taken as the same on every rank
    (so no data moves to shard it); None returns ``x`` untouched."""
    if sharding is None:
        return x
    from ..launch.compat import DTensor, Replicate

    if not isinstance(x, DTensor):
        x = DTensor.from_local(x, sharding.mesh, [Replicate()] * sharding.mesh.ndim, run_check=False)
    return x.redistribute(sharding.mesh, tuple(sharding.placements))


DP_AXES = ("pod", "data")


def is_dtensor(x: Any) -> bool:
    """Whether ``x`` is a DTensor (without importing the distributed stack
    for a plain tensor)."""
    return type(x).__name__ == "DTensor"


def reduce_partial(x: torch.Tensor) -> torch.Tensor:
    """A DTensor with its pending partial reductions done (all-reduced to
    replicated); anything else as it is."""
    if not is_dtensor(x) or not any(p.is_partial() for p in x.placements):
        return x
    from ..launch.compat import Replicate

    return x.redistribute(x.device_mesh, tuple(Replicate() if p.is_partial() else p for p in x.placements))


def gather_dp(tree: Any) -> Any:
    """ZeRO-3 gather at use: every DTensor leaf of ``tree`` with its
    data-parallel mesh dimensions (``pod``, ``data``) replicated and its
    other placements kept (its gradient is reduce-scattered back). Plain
    tensors pass untouched, so a one-device forward is unchanged."""
    def leaf(x):
        if not is_dtensor(x):
            return x
        from ..launch.compat import Replicate

        names = x.device_mesh.mesh_dim_names or ()
        pl = tuple(Replicate() if n in DP_AXES and p.is_shard() else p for n, p in zip(names, x.placements))
        return x if pl == tuple(x.placements) else x.redistribute(x.device_mesh, pl)

    return tree_map(leaf, tree)


# ---------------------------------------------------------------- slices ---

def seq_shard(t: torch.Tensor, dim: int) -> Tuple[list, int, int]:
    """Where a DTensor's dimension ``dim`` is split: (the mesh dimensions
    that shard it, in mesh order; this rank's offset into it; its local
    length)."""
    mesh, coord = t.device_mesh, t.device_mesh.get_coordinate()
    dims = [i for i, p in enumerate(t.placements) if p.is_shard(dim)]
    length = t.to_local().shape[dim]
    idx = 0
    for i in dims:  # major to minor
        idx = idx * mesh.size(i) + coord[i]
    return dims, idx * length, length


def local_like(x: torch.Tensor, like: torch.Tensor, dim: int) -> torch.Tensor:
    """This rank's part of ``x`` laid out as the DTensor ``like`` but with
    dimension ``dim`` whole (a plain ``x`` is the same on every rank)."""
    from ..launch.compat import DTensor, Replicate

    mesh = like.device_mesh
    if not is_dtensor(x):
        x = DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim, run_check=False)
    pl = tuple(Replicate() if p.is_shard(dim) else p for p in like.placements)
    return x.redistribute(mesh, pl).to_local()


def _update_slice_sharded_(t: torch.Tensor, new: torch.Tensor, start: Union[int, torch.Tensor], dim: int) -> torch.Tensor:
    """:func:`update_slice_` into a DTensor whose ``dim`` may be sharded:
    each rank writes the part of ``new`` that falls in its own slice (a
    one-position write at a device start, or any write at a host start)."""
    _, off, length = seq_shard(t, dim)
    local = t.to_local()
    new = local_like(new, t, dim).to(local.dtype)
    size, extent = new.shape[dim], t.shape[dim]
    if isinstance(start, torch.Tensor):
        if size != 1:
            raise NotImplementedError("a sharded write at a device start takes one position")
        start = start.to(device=local.device, dtype=torch.int64)
        first = torch.clamp(torch.where(start < 0, start + extent, start), 0, extent - size) - off
        inside = (first >= 0) & (first < length)
        idx = first.clamp(0, length - 1).reshape(1)
        local.index_copy_(dim, idx, torch.where(inside, new, local.index_select(dim, idx)))
        return t
    start = int(start)
    start = min(max(start + extent if start < 0 else start, 0), extent - size)
    lo, hi = max(start, off), min(start + size, off + length)
    if lo < hi:
        local.narrow(dim, lo - off, hi - lo).copy_(new.narrow(dim, lo - start, hi - lo))
    return t


def update_slice_(t: torch.Tensor, new: torch.Tensor, start: Union[int, torch.Tensor], dim: int) -> torch.Tensor:
    """Write ``new`` into ``t`` from ``start`` along ``dim``, in place, and
    return ``t``. As in ``lax.dynamic_update_slice``, a negative start
    counts from the end, and the start is then clamped so the update fits:
    a host integer on the host, a 0-d integer tensor on its own device,
    whose value is never read back (the write goes through ``index_copy_``
    over indices built there, so a CUDA graph can capture it)."""
    if is_dtensor(t):
        return _update_slice_sharded_(t, new, start, dim)
    size, extent = new.shape[dim], t.shape[dim]
    new = new.to(t.dtype)
    if isinstance(start, torch.Tensor):
        start = start.to(device=t.device, dtype=torch.int64)
        first = torch.clamp(torch.where(start < 0, start + extent, start), 0, extent - size)
        return t.index_copy_(dim, first + torch.arange(size, device=t.device), new)
    start = int(start)
    start = min(max(start + extent if start < 0 else start, 0), extent - size)
    t.narrow(dim, start, size).copy_(new)
    return t


def update_slice(t: torch.Tensor, new: torch.Tensor, start: Union[int, torch.Tensor], dim: int) -> torch.Tensor:
    """A copy of ``t`` with ``new`` written from ``start`` along ``dim``
    (:func:`update_slice_` on a clone: ``t`` is not changed)."""
    return update_slice_(t.clone(), new, start, dim)

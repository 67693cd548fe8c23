"""Logical-axis sharding rules: DP/FSDP x TP (+ EP/SP) over (pod, data,
model), the reference's ``distributed/sharding.py`` on ``DeviceMesh`` and
DTensor placements.

Models annotate parameters with *logical* axis names; this module maps them
to mesh axes per architecture and mode:

* ``embed``   -> FSDP over the data-parallel axes (pod, data) — ZeRO-style
  parameter + optimizer-state sharding;
* ``vocab``/``ffn``/``q_heads``/``heads``/``moe_ffn`` -> ``model`` (tensor /
  expert parallelism), subject to divisibility;
* attention strategy per arch (``head`` / ``head_q`` / ``sequence``): head
  counts that do not divide the model axis fall back gracefully;
* any rule whose axis sizes do not divide the dimension is dropped for that
  leaf (replicate fallback) — recorded for the dry-run report. DTensor
  would accept the uneven shard; the plan replicates, as the reference's.

The mesh axes are data-parallel ``("pod", "data")`` and tensor ``"model"``;
single-pod meshes simply lack the ``pod`` axis — rules reference axes by
name and silently skip absent ones. A mesh here is a ``DeviceMesh`` with
named dimensions or an :class:`AbstractMesh` (names and sizes only: a plan
needs no process group).

A :class:`Spec` is the reference's ``PartitionSpec``: one entry per tensor
dimension, ``None`` or a tuple of mesh-axis names, major to minor.
:func:`placements` turns it into DTensor placements: every mesh dimension
named in entry ``d`` becomes ``Shard(d)``, the others ``Replicate()``. A
dimension split over two mesh axes (``("pod", "data")``) is ``Shard(d)`` on
both, and DTensor splits it in mesh-dimension order, so the axes of an
entry must appear in the mesh's order (the reference's rules only build
such entries; :func:`placements` refuses others).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..launch.compat import Replicate, Shard, mesh_axis_names, mesh_axis_sizes
from ..models import ModelConfig

AxisRule = Optional[Tuple[str, ...]]  # mesh axes assigned to a logical axis


class Spec(tuple):
    """The reference's ``PartitionSpec``: a tuple with one entry per tensor
    dimension, None or a tuple of mesh-axis names."""

    def __new__(cls, *entries):
        return super().__new__(cls, tuple(None if e is None else tuple(e) for e in entries))

    def __repr__(self) -> str:
        return f"Spec{tuple(self)!r}"


@dataclasses.dataclass(frozen=True)
class AbstractMesh:
    """Mesh axis names and sizes without devices (the reference's
    ``jax.sharding.AbstractMesh``): enough for a plan."""

    sizes: Tuple[int, ...]
    names: Tuple[str, ...]

    @property
    def axis_names(self) -> Tuple[str, ...]:
        return self.names

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.names, self.sizes))


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh (the reference's ``NamedSharding``)."""

    mesh: Any
    spec: Spec

    @property
    def placements(self) -> tuple:
        return placements(self.mesh, self.spec)


def placements(mesh: Any, spec: Sequence) -> tuple:
    """DTensor placements of ``spec`` on ``mesh``: one per mesh dimension,
    ``Shard(d)`` where entry ``d`` names that mesh axis, else
    ``Replicate()``. A mesh axis of size 1 replicates what it would split
    (the same layout; DTensor refuses to view a dimension sharded over it,
    such as a single KV head on a model width of 1)."""
    names = mesh_axis_names(mesh)
    sizes = mesh_axis_sizes(mesh)
    out: List[Any] = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        entry = (entry,) if isinstance(entry, str) else tuple(entry)
        idx = [names.index(a) for a in entry]
        if idx != sorted(idx):
            raise ValueError(f"spec entry {entry} is not in the mesh's axis order {names}")
        for i in idx:
            out[i] = Shard(d) if sizes[names[i]] > 1 else Replicate()
    return tuple(out)


def local_slices(mesh: Any, spec: Sequence, shape: Sequence[int], coord: Dict[str, int]) -> Tuple[slice, ...]:
    """The slices of a tensor of ``shape`` that the device at mesh
    coordinate ``coord`` (``{axis: index}``) holds under ``spec``: each
    entry's axes split the dimension major to minor (even splits)."""
    sizes = mesh_axis_sizes(mesh)
    out = []
    for d, dim in enumerate(shape):
        entry = spec[d] if d < len(spec) else None
        if entry is None:
            out.append(slice(0, dim))
            continue
        entry = (entry,) if isinstance(entry, str) else tuple(entry)
        start, size = 0, dim
        for a in entry:
            size //= sizes[a]
            start += coord[a] * size
        out.append(slice(start, start + size))
    return tuple(out)


def dp_axes(mesh: Any) -> Tuple[str, ...]:
    names = mesh_axis_names(mesh)
    return tuple(a for a in ("pod", "data") if a in names)


def tp_size(mesh: Any) -> int:
    return mesh_axis_sizes(mesh)["model"] if "model" in mesh_axis_names(mesh) else 1


def dp_size(mesh: Any) -> int:
    sizes = mesh_axis_sizes(mesh)
    return int(np.prod([sizes[a] for a in dp_axes(mesh)])) if dp_axes(mesh) else 1


def attention_strategy(cfg: ModelConfig, tp: int) -> str:
    """head: q+kv heads TP; head_q: q TP + replicated KV (broadcast GQA);
    sequence: sequence-parallel attention (no head sharding)."""
    if tp <= 1:
        return "head"
    if cfg.n_heads % tp == 0 and cfg.n_kv_heads % tp == 0:
        return "head"
    if cfg.n_heads % tp == 0:
        return "head_q"
    return "sequence"


def expert_strategy(cfg: ModelConfig, tp: int) -> str:
    """expert: experts over model (EP); tensor: per-expert d_ff over model."""
    if cfg.n_experts and cfg.n_experts % tp == 0:
        return "expert"
    return "tensor"


@dataclasses.dataclass
class ShardingPlan:
    mesh: Any
    rules: Dict[Optional[str], AxisRule]
    attention: str
    experts: str
    fallbacks: List[str] = dataclasses.field(default_factory=list)

    def spec_for(self, axes: Sequence[Optional[str]], shape: Sequence[int]) -> Spec:
        """Spec for one leaf, dropping non-dividing rules."""
        names = mesh_axis_names(self.mesh)
        sizes = mesh_axis_sizes(self.mesh)
        entries: List[AxisRule] = []
        for ax_name, dim in zip(axes, shape):
            rule = self.rules.get(ax_name)
            if rule is None:
                entries.append(None)
                continue
            present = tuple(a for a in rule if a in names)
            if not present:
                entries.append(None)
                continue
            total = int(np.prod([sizes[a] for a in present]))
            if dim % total != 0:
                # try prefixes (e.g. ("pod","data") -> ("pod",))
                chosen: AxisRule = None
                for k in range(len(present) - 1, 0, -1):
                    sub = present[:k]
                    t = int(np.prod([sizes[a] for a in sub]))
                    if dim % t == 0:
                        chosen = sub
                        break
                if chosen is None:
                    self.fallbacks.append(
                        f"axis {ax_name!r} dim {dim} !% mesh{present} -> replicated"
                    )
                    entries.append(None)
                else:
                    self.fallbacks.append(
                        f"axis {ax_name!r} dim {dim} !% mesh{present} -> {chosen}"
                    )
                    entries.append(chosen)
            else:
                entries.append(present)
        return Spec(*entries)

    def sharding_for(self, axes, shape) -> NamedSharding:
        return NamedSharding(self.mesh, self.spec_for(axes, shape))


def make_plan(
    cfg: ModelConfig,
    mesh: Any,
    mode: str = "train",          # train | prefill | decode
    zero3: bool = True,
) -> ShardingPlan:
    """Build the logical-axis -> mesh-axes rule table for (arch, mode)."""
    tp = tp_size(mesh)
    dpa = dp_axes(mesh)
    attn = attention_strategy(cfg, tp)
    exps = expert_strategy(cfg, tp)

    rules: Dict[Optional[str], AxisRule] = {
        None: None,
        "layers": None,                       # unit-loop dim, never sharded
        "vocab": ("model",),
        "embed": dpa if zero3 else None,      # FSDP / ZeRO-3 storage shard
        "ffn": ("model",),
        "moe_ffn": ("model",) if exps == "tensor" else None,
        "experts": ("model",) if exps == "expert" else None,
        "heads": ("model",),                  # SSD heads
        "head_dim": None,
    }
    if attn == "head":
        rules["q_heads"] = ("model",)
        rules["kv_heads"] = ("model",)
    elif attn == "head_q":
        rules["q_heads"] = ("model",)
        rules["kv_heads"] = None              # replicated KV (broadcast GQA)
    else:  # sequence-parallel attention
        rules["q_heads"] = None
        rules["kv_heads"] = None

    return ShardingPlan(mesh=mesh, rules=rules, attention=attn, experts=exps)


def _is_axes(x: Any) -> bool:
    return isinstance(x, tuple) and all(isinstance(e, (str, type(None))) for e in x)


def _map_axes(fn, axes_tree: Any, shape_tree: Any) -> Any:
    if _is_axes(axes_tree):
        return fn(axes_tree, shape_tree)
    return {k: _map_axes(fn, v, shape_tree[k]) for k, v in axes_tree.items()}


def tree_shardings(plan: ShardingPlan, axes_tree: Any, shape_tree: Any) -> Any:
    """NamedSharding tree matching (axes, shapes) trees leaf-for-leaf (a
    shape leaf is a tensor, ``meta`` ones included, or a shape tuple)."""
    return _map_axes(
        lambda axes, leaf: plan.sharding_for(axes, tuple(getattr(leaf, "shape", leaf))),
        axes_tree, shape_tree)


# --------------------------------------------------------- activations -----

def batch_spec(mesh: Any, global_batch: int, extra_dims: int = 1) -> Spec:
    """Shard the batch dim over (pod, data) when divisible, else replicate."""
    dpa = dp_axes(mesh)
    sizes = mesh_axis_sizes(mesh)
    if dpa:
        total = int(np.prod([sizes[a] for a in dpa]))
        if global_batch % total == 0:
            return Spec(dpa, *([None] * extra_dims))
        for k in range(len(dpa) - 1, 0, -1):
            t = int(np.prod([sizes[a] for a in dpa[:k]]))
            if global_batch % t == 0:
                return Spec(dpa[:k], *([None] * extra_dims))
    return Spec(*([None] * (extra_dims + 1)))


def cache_seq_spec(mesh: Any, global_batch: int) -> Spec:
    """KV-cache sharding [b, S, K, hd]: batch over DP when divisible; the
    seq dim takes 'model' (+ the DP axes too when batch is too small —
    long-context decode with batch 1 shards S over every axis)."""
    dpa = dp_axes(mesh)
    dp_total = dp_size(mesh)
    if dpa and global_batch % dp_total == 0:
        return Spec(dpa, ("model",), None, None)
    return Spec(None, dpa + ("model",), None, None)


def state_specs(cfg: ModelConfig, plan: ShardingPlan, state_shapes: Any, global_batch: int) -> Any:
    """Shardings for the decode-state tree (KV caches / SSM states).

    KV caches [U, b, S, K, hd] -> batch over DP, seq over model.
    SSM states [U, b, h, p, n] -> batch over DP, heads over model.
    Conv states [U, b, k-1, c]  -> batch over DP, channels over model.
    """
    mesh = plan.mesh
    dpa = dp_axes(mesh)
    batch_ok = dpa and global_batch % dp_size(mesh) == 0
    b_rule = dpa if batch_ok else None

    def spec_for_leaf(names: Tuple[str, ...], leaf) -> NamedSharding:
        shape = tuple(getattr(leaf, "shape", leaf))
        leafname = names[-1] if names else ""
        if leafname in ("k", "v") and any("kv" in str(n) for n in names):
            # [U, b, S, K, hd]
            seq_rule = ("model",) if batch_ok else (dpa + ("model",))
            seq_rule = _fit(mesh, seq_rule, shape[2])
            spec = Spec(None, _fit(mesh, b_rule, shape[1]), seq_rule, None, None)
        elif leafname == "ssm":
            h_rule = _fit(mesh, ("model",), shape[2])
            spec = Spec(None, _fit(mesh, b_rule, shape[1]), h_rule, None, None)
        elif names and "conv" in names:
            c_rule = _fit(mesh, ("model",), shape[3])
            spec = Spec(None, _fit(mesh, b_rule, shape[1]), None, c_rule)
        elif leafname in ("cross_k", "cross_v"):
            # [L, b, s_enc, K, hd]
            spec = Spec(None, _fit(mesh, b_rule, shape[1]), None, None, None)
        else:
            spec = Spec(*([None] * len(shape)))
        return NamedSharding(mesh, spec)

    def walk(tree, path):
        if isinstance(tree, dict):
            return {k: walk(v, path + (k,)) for k, v in tree.items()}
        return spec_for_leaf(path, tree)

    return walk(state_shapes, ())


def _fit(mesh: Any, rule: AxisRule, dim: int) -> AxisRule:
    """Largest prefix of ``rule`` whose product divides ``dim``."""
    if rule is None:
        return None
    names = mesh_axis_names(mesh)
    sizes = mesh_axis_sizes(mesh)
    present = tuple(a for a in rule if a in names)
    while present:
        total = int(np.prod([sizes[a] for a in present]))
        if dim % total == 0:
            return present
        present = present[:-1]
    return None


# ------------------------------------------------------------- tensors -----

def mesh_coordinate(mesh: Any) -> Dict[str, int]:
    """This rank's ``{axis: index}`` on a ``DeviceMesh``."""
    return dict(zip(mesh_axis_names(mesh), mesh.get_coordinate()))


def local_shape(sharding: NamedSharding, shape: Sequence[int]) -> Tuple[int, ...]:
    """The shape of one device's shard of a tensor of ``shape`` (even splits)."""
    sizes = mesh_axis_sizes(sharding.mesh)
    out = list(shape)
    for d, entry in enumerate(sharding.spec):
        for a in entry or ():
            out[d] //= sizes[a]
    return tuple(out)


def from_local(local: Any, sharding: NamedSharding, shape: Sequence[int]) -> Any:
    """A DTensor of global ``shape`` whose shard on this rank is ``local``
    (no communication; ``local`` must have :func:`local_shape`)."""
    from ..launch.compat import DTensor

    stride, acc = [], 1
    for dim in reversed(tuple(shape)):
        stride.append(acc)
        acc *= dim
    return DTensor.from_local(local, sharding.mesh, sharding.placements, run_check=False,
                              shape=tuple(shape), stride=tuple(reversed(stride)))


def shard_tensor(full: Any, sharding: NamedSharding) -> Any:
    """``full`` (the same on every rank) as a DTensor laid out by
    ``sharding``: this rank keeps its slice; nothing is communicated."""
    idx = local_slices(sharding.mesh, sharding.spec, full.shape, mesh_coordinate(sharding.mesh))
    return from_local(full[idx].contiguous(), sharding, full.shape)


def shard_tree(tree: Any, shardings: Any) -> Any:
    """:func:`shard_tensor` leaf by leaf over matching trees."""
    if isinstance(tree, dict):
        return {k: shard_tree(v, shardings[k]) for k, v in tree.items()}
    return shard_tensor(tree, shardings)

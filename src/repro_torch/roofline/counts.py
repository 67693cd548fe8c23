"""Per-device FLOPs / bytes / collective bytes of an eager step, counted op
by op as it runs: the counterpart of the reference's ``repro.roofline.hlo``,
which parses the compiled per-device HLO. PyTorch emits no HLO, so a
dispatch mode (:class:`CountingMode`) watches the aten ops that one rank
actually runs.

* **Per device.** A mode sees a DTensor op at its *global* shapes (a
  ``FlopCounterMode`` around a DTensor MLP on a 16x16 fake mesh reports the
  whole mesh's FLOPs). This mode hands each DTensor op to DTensor's own
  dispatch (it declines them) and counts what comes back through it: the
  local ops on this rank's shards and the collectives DTensor issues, not
  the shape inference DTensor runs on fake tensors. Replicated compute
  counts in full on each device, as it runs there.
* **FLOPs** come from ``torch.utils.flop_counter``'s formulas (matrix
  products, convolutions, attention kernels) applied to the local ops.
* **Bytes** follow eager execution: nothing is fused, so every op reads
  each input once and writes its output once (views and metadata ops move
  nothing). This is an upper bound on the traffic a fused program would
  make, where the reference's HLO model charges only unfused major ops.
* **Collective bytes** are the operand bytes of each collective, by kind
  (``all-reduce``, ``all-gather``, ``reduce-scatter``, ``all-to-all``,
  ``collective-permute``), the reference's kinds.

The mode keeps one :class:`OpRecord` per (op, output shape) with its count,
FLOPs and bytes. That list (:meth:`CountingMode.records`) is what the dry
run caches next to its report — the counterpart of the reference's gzipped
HLO — so :func:`analyze`, :func:`breakdown_by_opcode` and
:func:`attention_score_traffic` re-derive everything from it without
running a step again.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

#: collective op names (any namespace) -> the reference's HLO kinds
COLLECTIVE_KINDS = {
    "all_reduce": "all-reduce", "allreduce_": "all-reduce", "allreduce_coalesced_": "all-reduce",
    "all_gather_into_tensor": "all-gather", "allgather_": "all-gather",
    "_allgather_base_": "all-gather", "all_gather_into_tensor_coalesced": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter", "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter", "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all", "alltoall_": "all-to-all", "alltoall_base_": "all-to-all",
    "send": "collective-permute", "recv_": "collective-permute", "broadcast_": "collective-permute",
    "broadcast": "collective-permute",
}


@dataclass
class HloCounts:
    """The reference's per-device totals (the name kept so rows and
    helpers read the same)."""

    flops: float = 0.0
    bytes: float = 0.0
    collective_bytes: Dict[str, float] = field(default_factory=dict)

    @property
    def total_collective_bytes(self) -> float:
        return sum(self.collective_bytes.values())


@dataclass
class OpRecord:
    """One (op, output shape) of a counted step: how often it ran and its
    FLOPs and bytes summed over those runs. ``kind`` is the collective kind
    (None for compute); a collective's bytes are its operand bytes."""

    op: str
    shape: Tuple[int, ...]
    count: int = 0
    flops: float = 0.0
    bytes: float = 0.0
    kind: Optional[str] = None

    def to_list(self) -> list:
        return [self.op, list(self.shape), self.count, self.flops, self.bytes, self.kind]

    @classmethod
    def from_list(cls, x: Sequence) -> "OpRecord":
        return cls(x[0], tuple(x[1]), int(x[2]), float(x[3]), float(x[4]), x[5])


def _nbytes(t: Any) -> int:
    return t.numel() * t.element_size() if isinstance(t, torch.Tensor) else 0


def _is_view(func) -> bool:
    returns = func._schema.returns
    alias = returns[0].alias_info if returns else None
    return alias is not None and not alias.is_write


#: ops that allocate or wrap without touching memory
_NO_TRAFFIC = {"empty", "empty_strided", "empty_like", "new_empty", "new_empty_strided",
               "_wrap_tensor_autograd", "wait_tensor"}


def _shape_only(tensors: Iterable[Any]) -> bool:
    """Whether an op ran on shapes only (meta or fake tensors: DTensor's
    sharding propagation infers output shapes so), not on a device."""
    from torch._subclasses.fake_tensor import FakeTensor

    return any(isinstance(t, FakeTensor) or (isinstance(t, torch.Tensor) and t.device.type == "meta")
               for t in tensors)


class CountingMode(TorchDispatchMode):
    """Count the local ops one rank runs (see the module docstring).

    Use as a context manager around the step; :meth:`records` gives the
    per-(op, shape) records, :attr:`counts` the totals."""

    def __init__(self) -> None:
        super().__init__()
        self._records: Dict[Tuple[str, Tuple[int, ...]], OpRecord] = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        from ..launch.compat import DTensor

        flat, _ = tree_flatten((args, kwargs))
        if any(isinstance(t, DTensor) for t in flat):
            # DTensor's own dispatch runs it, with this mode still on the
            # stack: its local ops and collectives come back here
            return NotImplemented
        out = func(*args, **kwargs)
        outs, _ = tree_flatten(out)
        if not _shape_only(flat) and not _shape_only(outs):
            self._count(func, args, kwargs, flat, out, outs)
        return out

    def _count(self, func, args, kwargs, flat, out, outs) -> None:
        name = func.overloadpacket.__name__
        first = next((o for o in outs if isinstance(o, torch.Tensor)), None)
        shape = tuple(first.shape) if first is not None else ()
        rec = self._records.get((name, shape))
        if rec is None:
            rec = self._records[(name, shape)] = OpRecord(name, shape, kind=COLLECTIVE_KINDS.get(name))
        rec.count += 1
        if rec.kind is not None:
            rec.bytes += sum(_nbytes(t) for t in flat)
            return
        formula = flop_registry.get(func.overloadpacket)
        if formula is not None:
            rec.flops += float(formula(*args, **kwargs, out_val=out))
        if not _is_view(func) and name not in _NO_TRAFFIC:
            rec.bytes += sum(_nbytes(t) for t in flat) + sum(_nbytes(t) for t in outs)

    def records(self) -> List[OpRecord]:
        return [dataclasses.replace(r) for r in self._records.values()]

    @property
    def counts(self) -> HloCounts:
        return analyze(self.records())


def _as_records(records: Iterable[Any]) -> List[OpRecord]:
    return [r if isinstance(r, OpRecord) else OpRecord.from_list(r) for r in records]


def analyze(records: Iterable[Any]) -> HloCounts:
    """Per-device totals of a counted step's records (:class:`OpRecord`s
    or their :meth:`OpRecord.to_list` form, as the dry run caches them)."""
    total = HloCounts()
    for r in _as_records(records):
        if r.kind is not None:
            total.collective_bytes[r.kind] = total.collective_bytes.get(r.kind, 0.0) + r.bytes
        else:
            total.flops += r.flops
            total.bytes += r.bytes
    return total


def breakdown_by_opcode(records: Iterable[Any]) -> Dict[str, Dict[str, float]]:
    """Per-aten-op {flops, bytes, count} totals — the §Perf hypothesis
    generator ("what moves the dominant term")."""
    table: Dict[str, Dict[str, float]] = {}
    for r in _as_records(records):
        rec = table.setdefault(r.op, {"flops": 0.0, "bytes": 0.0, "count": 0.0})
        rec["flops"] += r.flops
        rec["bytes"] += r.bytes
        rec["count"] += r.count
    return table


def attention_score_traffic(records: Iterable[Any], seq_dims: Sequence[int]) -> float:
    """Bytes moved by ops whose output is attention-score shaped: rank >= 4
    ([b, h, sq, skv] and the grouped [b, k, g, sq, skv]) with both trailing
    dims in ``seq_dims`` (e.g. {4096, 256} for a seq-sharded 4k cell).

    The hand flash-attention kernel keeps these tiles on chip; the
    kernel-adjusted memory term subtracts this traffic."""
    sset = {int(s) for s in seq_dims}
    return sum(
        r.bytes for r in _as_records(records)
        if r.kind is None and len(r.shape) >= 4 and r.shape[-1] in sset and r.shape[-2] in sset
    )

"""torch version-compat shims for the distributed and launch layers (the
counterpart of the reference's ``repro.launch.compat``, which does the same
for jax).

The port targets the torch releases it meets (2.11 on the card, 2.13 in the
CPU test environment), and this module is the single choke point for the
torch APIs that move between them:

* where ``DeviceMesh``/``init_device_mesh``, ``DTensor``, the placements
  (``Shard``, ``Replicate``, ``Partial``), ``distribute_tensor`` and
  ``implicit_replication`` live: ``torch.distributed.tensor`` from 2.5, the
  private ``torch.distributed._tensor`` before;
* process-group start-up for ``nccl``, ``gloo`` and the ``fake`` backend
  (a process group of any world size in one process whose collectives move
  no data: the dry run's);
* :class:`ElasticGroup`, the default group re-formed at each membership
  change: one rendezvous store that outlives the groups, one group per
  membership epoch on its own ``PrefixStore``, the ranks outside a new
  epoch's world dropping out;
* :func:`make_mesh`, a named ``DeviceMesh`` over the default group;
* :func:`shard_map`, the counterpart of ``jax.shard_map``: a function of
  local shards, run on each rank, with DTensors redistributed to given
  placements on the way in and wrapped (``DTensor.from_local``) on the way
  out. Collectives inside it go over a named mesh dimension's group
  (``mesh.get_group(axis)``).

Importing this module starts no process group.
"""

from __future__ import annotations

import socket
from datetime import timedelta
from typing import Any, Callable, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch.distributed import PrefixStore
from torch.distributed.rendezvous import rendezvous
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

try:  # torch >= 2.5
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard, distribute_tensor
except ImportError:  # pragma: no cover - older torch
    from torch.distributed._tensor import DTensor, Replicate, Shard, distribute_tensor
    from torch.distributed._tensor.placement_types import _Partial as Partial

try:
    from torch.distributed.tensor.experimental import implicit_replication
except ImportError:  # pragma: no cover - older torch
    from torch.distributed._tensor.experimental import implicit_replication

__all__ = [
    "BACKENDS",
    "DTensor",
    "DeviceMesh",
    "ElasticGroup",
    "Partial",
    "Replicate",
    "Shard",
    "barrier",
    "destroy_process_group",
    "distribute_tensor",
    "free_port",
    "implicit_replication",
    "init_device_mesh",
    "init_process_group",
    "make_mesh",
    "mesh_axis_names",
    "mesh_axis_sizes",
    "shard_map",
]

BACKENDS = ("nccl", "gloo", "fake")


def free_port() -> int:
    """A free TCP port on ``localhost`` (for ``tcp://localhost:<port>``)."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def init_process_group(backend: str, world_size: int = 1, rank: int = 0,
                       init_method: Optional[str] = None) -> None:
    """Start the default process group. ``fake`` takes any world size in
    this one process (its collectives move no data); ``nccl`` and ``gloo``
    rendezvous at ``init_method`` (``tcp://localhost:<free port>`` when
    not given, which serves a world of one)."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; one of {BACKENDS}")
    if backend == "fake":
        # the import registers the backend on releases that do not build it in
        from torch.testing._internal.distributed.fake_pg import FakeStore

        dist.init_process_group("fake", store=FakeStore(), rank=rank, world_size=world_size)
        return
    if init_method is None:
        if world_size != 1:
            raise ValueError(f"{backend} over {world_size} ranks needs an init_method")
        init_method = f"tcp://localhost:{free_port()}"
    dist.init_process_group(backend, init_method=init_method, rank=rank, world_size=world_size)


def destroy_process_group() -> None:
    if dist.is_initialized():
        dist.destroy_process_group()


def barrier() -> None:
    """Wait for every rank of the default group (``nccl`` on this rank's
    card)."""
    if dist.get_backend() == "nccl":
        dist.barrier(device_ids=[torch.cuda.current_device()])
    else:
        dist.barrier()


class ElasticGroup:
    """The default process group, re-formed over the survivors at each
    membership change.

    One rendezvous (``init_method``: ``tcp://host:port``, or ``env://``
    under ``torchrun``, whose rank and world size then come from the
    environment) gives a store that outlives every group: rank 0 hosts it
    (under ``torchrun``, its agent does). Membership epoch ``k`` is a group
    on ``PrefixStore("epoch<k>/", store)``, so a new epoch never meets the
    keys of an old one, as re-joining the same init method would. Ranks
    keep their numbers: :meth:`reform` to ``n`` ranks keeps ranks
    ``0 … n-1``, and the others leave (the group is destroyed on them and
    not re-formed). A group cannot grow: a rank that left has no group."""

    def __init__(self, backend: str, rank: int = -1, world_size: int = -1,
                 init_method: Optional[str] = None, timeout: timedelta = timedelta(minutes=10)) -> None:
        if backend not in ("nccl", "gloo"):
            raise ValueError(f"an elastic group runs on nccl or gloo, not {backend!r}")
        if init_method is None:
            if world_size not in (-1, 1):
                raise ValueError(f"{backend} over {world_size} ranks needs an init_method")
            rank, world_size, init_method = 0, 1, f"tcp://localhost:{free_port()}"
        self.backend = backend
        self.store, self.rank, world_size = next(rendezvous(init_method, rank, world_size, timeout=timeout))
        self.epoch = -1
        self.world_size = 0
        self._join(world_size)

    def _join(self, world_size: int) -> None:
        self.epoch += 1
        self.world_size = world_size
        dist.init_process_group(self.backend, store=PrefixStore(f"epoch{self.epoch}/", self.store),
                                rank=self.rank, world_size=world_size)

    def reform(self, world_size: int) -> bool:
        """Destroy the current group and form the next epoch's over ranks
        ``0 … world_size-1`` (every rank of the current group calls this).
        Returns whether this rank is in it; one that is not has left."""
        if not 0 < world_size <= self.world_size:
            raise ValueError(f"cannot re-form a group of {self.world_size} ranks over {world_size}")
        destroy_process_group()
        if self.rank >= world_size:
            self.world_size = 0
            return False
        self._join(world_size)
        return True

    def close(self) -> None:
        """Leave: destroy this rank's group (the store lives on while a
        rank holds it)."""
        destroy_process_group()
        self.world_size = 0


def make_mesh(axis_shapes: Sequence[int], axis_names: Sequence[str],
              device_type: str = "cuda") -> DeviceMesh:
    """A ``DeviceMesh`` of ``axis_shapes`` named ``axis_names`` over the
    default process group's ranks in row-major order (the group must
    exist, and its world size be the mesh's size)."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a process group: call init_process_group first")
    return init_device_mesh(device_type, tuple(axis_shapes), mesh_dim_names=tuple(axis_names))


def mesh_axis_names(mesh: Any) -> Tuple[str, ...]:
    """Axis names of a ``DeviceMesh`` or of an abstract mesh (anything with
    ``axis_names``)."""
    if isinstance(mesh, DeviceMesh):
        return tuple(mesh.mesh_dim_names or ())
    return tuple(mesh.axis_names)


def mesh_axis_sizes(mesh: Any) -> dict:
    """``{axis name: size}``, the reference's ``mesh.shape``."""
    if isinstance(mesh, DeviceMesh):
        return dict(zip(mesh_axis_names(mesh), mesh.mesh.shape))
    return dict(mesh.shape)


class _ContiguousGrad(torch.autograd.Function):
    """Identity whose gradient is made contiguous: a local function's
    backward can hand back strided gradients (an einsum's permuted
    products), and DTensor's view rule refuses to view a strided shard."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return grad.contiguous()


def _local(x: Any, mesh: DeviceMesh, placements: Optional[Sequence], split: set) -> Any:
    if placements is None or not isinstance(x, DTensor):
        return x
    placements = tuple(placements)
    if tuple(x.placements) != placements:
        x = x.redistribute(mesh, placements)
    # replicated along a dimension the function splits: each rank's
    # gradient is its share, summed across them (jax's shard_map psums so)
    grad = tuple(Partial() if i in split and p.is_replicate() else p for i, p in enumerate(placements))
    local = x.to_local(grad_placements=grad)
    return _ContiguousGrad.apply(local) if local.requires_grad else local


def shard_map(f: Callable, *, mesh: DeviceMesh, in_placements: Sequence, out_placements: Any) -> Callable:
    """``f`` over local shards: each DTensor argument is redistributed to
    its entry of ``in_placements`` (None: passed as it is) and given to
    ``f`` as its local tensor; ``f``'s outputs (a tensor or a tuple) come
    back as DTensors with ``out_placements`` (one placements tuple per
    output; None keeps an output local). Autograd flows through both ends
    (``to_local``/``from_local`` are differentiable), so ``f`` may be a
    piece of a training step: the gradient of an input replicated along a
    mesh dimension that ``f`` splits (some input sharded, or some output
    sharded or partial, along it) is summed across that dimension. An
    output may not be replicated along such a dimension (each rank's
    gradient through it would count once per rank): make it ``Partial``
    and divide its local value by the dimension's size."""
    single = not isinstance(out_placements, list)
    pls = (out_placements,) if single else out_placements
    split = {i for pl in (*in_placements, *pls) if pl is not None
             for i, p in enumerate(pl) if p.is_shard() or p.is_partial()}
    for pl in pls:
        if pl is not None and any(pl[i].is_replicate() for i in split):
            raise ValueError(f"output placements {pl} replicate a mesh dimension the function splits {sorted(split)}")

    def wrapped(*args):
        out = f(*(_local(a, mesh, p, split) for a, p in zip(args, in_placements)))
        outs = (out,) if single else out
        wrapped_out = tuple(
            o if p is None else DTensor.from_local(o, mesh, tuple(p), run_check=False)
            for o, p in zip(outs, pls))
        return wrapped_out[0] if single else wrapped_out

    return wrapped


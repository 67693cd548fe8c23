"""Mesh construction for single-pod and multi-pod deployments (the
reference's ``launch/mesh.py`` on ``DeviceMesh``).

``make_production_mesh`` builds the 16x16 (256-device pod, axes data x
model) or 2x16x16 (two pods, axes pod x data x model) target mesh. A
``DeviceMesh`` spans the default process group, so these meshes exist on a
process group of that world size: the ``fake`` one for a dry run
(:mod:`.dryrun`), which holds rank 0's shard on one card. Functions only —
importing this module starts no process group.

The builder generalises: ``make_mesh(n_pods, dp, tp)`` supports arbitrary
pod counts (the 'pod' axis carries pure data parallelism, so scaling pods
never changes per-pod sharding).
"""

from __future__ import annotations

from typing import Optional

import torch.distributed as dist

from .compat import init_process_group
from .compat import make_mesh as _compat_make_mesh
from .compat import mesh_axis_names, mesh_axis_sizes


def make_production_mesh(*, multi_pod: bool = False, device_type: str = "cuda"):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _compat_make_mesh(shape, axes, device_type)


def make_mesh(n_pods: int = 1, dp: int = 16, tp: int = 16, device_type: str = "cuda"):
    """General mesh: (pod, data, model) or (data, model) when n_pods == 1."""
    if n_pods > 1:
        return _compat_make_mesh((n_pods, dp, tp), ("pod", "data", "model"), device_type)
    return _compat_make_mesh((dp, tp), ("data", "model"), device_type)


def make_host_mesh(tp: Optional[int] = None, device_type: str = "cuda"):
    """Mesh over the default process group's ranks (one card: a world of
    one, started here on ``nccl`` — ``gloo`` for the CPU — when no group
    exists).

    Picks (dp, tp) = (n // tp, tp) with tp the largest power of two <= n
    (at most 8) unless given. Falls back to (1, 1) on a single device.
    """
    if not dist.is_initialized():
        init_process_group("nccl" if device_type == "cuda" else "gloo")
    n = dist.get_world_size()
    if tp is None:
        tp = 1
        while tp * 2 <= n and tp * 2 <= 8:
            tp *= 2
    dp = max(n // tp, 1)
    return _compat_make_mesh((dp, tp), ("data", "model"), device_type)


def describe(mesh) -> str:
    names = mesh_axis_names(mesh)
    sizes = mesh_axis_sizes(mesh)
    return (
        f"mesh axes={names} shape={tuple(sizes[a] for a in names)} "
        f"devices={mesh.size()}"
    )

"""Sharded, atomic, keep-k checkpointing with auto-resume (the reference's
``checkpoint/manager.py``, on the reference's on-disk format).

Layout (one directory per step)::

    <dir>/step_000042/
        manifest.json     # leaf keys, shapes, dtypes, step metadata
        arrays_0.npz      # flattened leaves keyed by tree path
    <dir>/LATEST          # text file: last durably committed step

The leaves and their keys are the reference's: dict keys sorted, a
NamedTuple's fields by name (``params/...``, ``opt/step``,
``opt/master/...``), joined by ``/``. A bfloat16 leaf is stored as its raw
two bytes, a numpy void array (``|V2``; the reference's ``ml_dtypes`` array
is written as ``<V2``, and both load as ``V2``), with ``"bfloat16"`` in the
manifest's ``dtypes``, and restored by viewing those bytes as
``torch.bfloat16``. So the port restores the reference's checkpoints and
writes the same keys, shapes and dtypes.

Durability: writes go to ``step_X.tmp<shard>`` and are ``os.rename``d into
place (atomic on POSIX), LATEST updated last — a crash mid-write never
corrupts the restore path. ``CheckpointManager(async_writes=True)`` copies
the state to the host at ``save`` (the training step updates its tensors in
place) and serialises it on a background thread.
"""

from __future__ import annotations

import json
import os
import queue
import shutil
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..device import DeviceLike, resolve_device

Pytree = Any


def _flatten_with_paths(tree: Pytree, prefix: str = "") -> List[Tuple[str, Any]]:
    """(key, leaf) in ``jax.tree_util.tree_flatten_with_path``'s order."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        items = [(str(k), tree[k]) for k in sorted(tree)]
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        items = [(f, getattr(tree, f)) for f in tree._fields]
    elif isinstance(tree, (list, tuple)):
        items = [(str(i), v) for i, v in enumerate(tree)]
    else:
        return [(prefix, tree)]
    return [kv for k, v in items for kv in _flatten_with_paths(v, f"{prefix}/{k}" if prefix else k)]


def _unflatten_like(like: Pytree, leaves: Dict[str, Any], prefix: str = "") -> Pytree:
    """``like``'s structure with the leaf at each key taken from ``leaves``."""
    join = (lambda k: f"{prefix}/{k}") if prefix else str
    if like is None:
        return None
    if isinstance(like, dict):
        return {k: _unflatten_like(v, leaves, join(k)) for k, v in like.items()}
    if isinstance(like, tuple) and hasattr(like, "_fields"):
        return type(like)(*(_unflatten_like(getattr(like, f), leaves, join(f)) for f in like._fields))
    if isinstance(like, (list, tuple)):
        return type(like)(_unflatten_like(v, leaves, join(i)) for i, v in enumerate(like))
    return leaves[prefix]


def _host_array(leaf: Any) -> Tuple[np.ndarray, str]:
    """(the array ``np.savez`` writes, the manifest's dtype name)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view("V2"), "bfloat16"
        arr = t.numpy()
    else:
        arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def save_checkpoint(
    directory: str,
    step: int,
    state: Pytree,
    *,
    shard_id: int = 0,
    num_shards: int = 1,
    extra: Optional[Dict[str, Any]] = None,
) -> str:
    """Atomic checkpoint write; returns the committed path."""
    os.makedirs(directory, exist_ok=True)
    final = os.path.join(directory, f"step_{step:08d}")
    tmp = final + f".tmp{shard_id}"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)

    leaves = _flatten_with_paths(state)
    host = {key: _host_array(leaf) for key, leaf in leaves}
    np.savez(os.path.join(tmp, f"arrays_{shard_id}.npz"), **{k: a for k, (a, _) in host.items()})

    manifest = {
        "step": step,
        "num_shards": num_shards,
        "keys": [k for k, _ in leaves],
        "shapes": {k: list(np.shape(a)) for k, (a, _) in host.items()},
        "dtypes": {k: name for k, (_, name) in host.items()},
        "time": time.time(),
        "extra": extra or {},
    }
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)

    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)                       # atomic commit
    _write_latest(directory, step)
    return final


def _write_latest(directory: str, step: int) -> None:
    tmp = os.path.join(directory, "LATEST.tmp")
    with open(tmp, "w") as f:
        f.write(str(step))
    os.rename(tmp, os.path.join(directory, "LATEST"))


def latest_step(directory: str) -> Optional[int]:
    path = os.path.join(directory, "LATEST")
    if not os.path.exists(path):
        return None
    try:
        with open(path) as f:
            step = int(f.read().strip())
    except ValueError:
        return None
    if os.path.exists(os.path.join(directory, f"step_{step:08d}", "manifest.json")):
        return step
    # LATEST points at a missing/corrupt dir — fall back to newest valid.
    steps = sorted(all_steps(directory), reverse=True)
    return steps[0] if steps else None


def all_steps(directory: str) -> List[int]:
    if not os.path.isdir(directory):
        return []
    out = []
    for name in os.listdir(directory):
        if name.startswith("step_") and not name.endswith(".tmp"):
            if os.path.exists(os.path.join(directory, name, "manifest.json")):
                try:
                    out.append(int(name[5:]))
                except ValueError:
                    pass
    return sorted(out)


def restore_checkpoint(
    directory: str,
    state_like: Pytree,
    *,
    step: Optional[int] = None,
    device: Optional[DeviceLike] = None,
    shard_id: int = 0,
) -> Tuple[Pytree, int, Dict[str, Any]]:
    """Restore into the structure of ``state_like`` (a tree whose leaves have
    ``.shape``), each leaf a tensor of the checkpoint's dtype.

    A leaf lands on its like's device; where the like has no storage (a
    ``meta`` tensor, so the like costs no memory) or is not a tensor, on
    ``device`` (default: the CPU).
    """
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {directory}")
    path = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    restored = {}
    with np.load(os.path.join(path, f"arrays_{shard_id}.npz")) as data:
        for key, like in _flatten_with_paths(state_like):
            if key not in data:
                raise KeyError(f"checkpoint {path} missing leaf {key!r}")
            arr = data[key]
            expect = tuple(like.shape)
            if tuple(arr.shape) != expect:
                raise ValueError(
                    f"leaf {key!r}: checkpoint shape {arr.shape} != expected {expect}"
                )
            if manifest["dtypes"].get(key) == "bfloat16":
                t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
            else:
                t = torch.from_numpy(arr)
            keep = isinstance(like, torch.Tensor) and not like.is_meta
            target = like.device if keep else resolve_device(device or "cpu")
            restored[key] = t.to(target)
    return _unflatten_like(state_like, restored), step, manifest.get("extra", {})


def _host_copy(state: Pytree) -> Pytree:
    """Every tensor leaf copied to the host (a CPU tensor is copied too)."""
    leaves = {k: leaf.detach().to("cpu", copy=True) if isinstance(leaf, torch.Tensor) else np.array(leaf)
              for k, leaf in _flatten_with_paths(state)}
    return _unflatten_like(state, leaves)


class CheckpointManager:
    """Keep-k retention + auto-resume + optional async writes."""

    def __init__(
        self,
        directory: str,
        keep: int = 3,
        async_writes: bool = False,
    ) -> None:
        self.directory = directory
        self.keep = keep
        self._async = async_writes
        self._queue: "queue.Queue" = queue.Queue(maxsize=1)
        self._worker: Optional[threading.Thread] = None
        self._last_error: Optional[BaseException] = None
        if async_writes:
            self._worker = threading.Thread(target=self._run, daemon=True)
            self._worker.start()

    # ---- save ----
    def save(self, step: int, state: Pytree, extra: Optional[Dict] = None) -> None:
        if self._last_error is not None:
            err, self._last_error = self._last_error, None
            raise RuntimeError("previous async checkpoint failed") from err
        if self._async:
            # copy NOW (values at this step: the train step updates in
            # place), serialize in background
            self._queue.put((step, _host_copy(state), extra))
        else:
            save_checkpoint(self.directory, step, state, extra=extra)
            self._gc()

    def _run(self) -> None:
        while True:
            step, state, extra = self._queue.get()
            try:
                save_checkpoint(self.directory, step, state, extra=extra)
                self._gc()
            except Exception as e:  # surfaced on next save()
                self._last_error = e
            finally:
                self._queue.task_done()

    def wait(self) -> None:
        """Block until every queued write is committed."""
        if self._async:
            self._queue.join()

    def _gc(self) -> None:
        steps = all_steps(self.directory)
        for s in steps[: -self.keep]:
            shutil.rmtree(
                os.path.join(self.directory, f"step_{s:08d}"), ignore_errors=True
            )

    # ---- restore ----
    def restore_latest(
        self, state_like: Pytree, device: Optional[DeviceLike] = None
    ) -> Optional[Tuple[Pytree, int, Dict]]:
        step = latest_step(self.directory)
        if step is None:
            return None
        return restore_checkpoint(
            self.directory, state_like, step=step, device=device
        )

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

Streaming: a save copies one leaf to the host while a writer thread
writes the one before (its bytes handed to the zip as they lie), so it
holds at most two leaves on the host, never the whole state. A restore
maps each stored member of the file (``np.memmap``), copies out only what
it places, and checks every member's CRC on worker threads meanwhile, as
``np.load`` would on reading it.

Sharded states: DTensor leaves are gathered (``full_tensor()``, a
collective every rank of the mesh joins) one at a time. On a process group
rank 0 writes, and every rank then waits at a barrier, so none reads a
half-written step. ``restore_checkpoint(..., shardings=)`` lays each leaf
out by its ``NamedSharding`` on the mesh of the restore: each rank keeps
its own slice of the mapped leaf and puts only that on the device. The
file format does not depend on the mesh: a checkpoint written on one mesh
restores on any other, and on none.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import json
import os
import queue
import shutil
import struct
import threading
import time
import zipfile
import zlib
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from ..models.layers import is_dtensor

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


def _is_writer(leaves: List[Tuple[str, Any]]) -> bool:
    """Whether this process writes a state of ``leaves``: any process for a
    state without DTensors, rank 0 for one with them."""
    if not any(is_dtensor(leaf) for _, leaf in leaves):
        return True
    import torch.distributed as dist

    return dist.get_rank() == 0


def _host_array(leaf: Any) -> Tuple[np.ndarray, str]:
    """(the array ``np.savez`` writes, the manifest's dtype name); a
    DTensor is gathered whole first."""
    if is_dtensor(leaf):
        leaf = leaf.full_tensor()
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view("V2"), "bfloat16"
        arr = t.numpy()
    else:
        arr = np.asarray(leaf)
    return arr, str(arr.dtype)


_CHUNK = 64 << 20   # bytes a zip write or CRC call takes at once
_CRC_THREADS = 4


def _write_member(zf: zipfile.ZipFile, key: str, arr: np.ndarray) -> None:
    """``arr`` as the stored member ``<key>.npy`` in ``np.savez``'s format,
    its bytes handed to the zip as they lie in memory (no copy)."""
    arr = arr if arr.flags.c_contiguous else np.ascontiguousarray(arr)
    header = np.lib.format.header_data_from_array_1_0(arr)
    with zf.open(key + ".npy", "w", force_zip64=True) as f:
        try:
            np.lib.format.write_array_header_1_0(f, header)
        except ValueError:  # a header past 64 KiB
            np.lib.format.write_array_header_2_0(f, header)
        data = memoryview(arr.reshape(-1).view(np.uint8))
        for i in range(0, len(data), _CHUNK):
            f.write(data[i:i + _CHUNK])


def save_checkpoint(
    directory: str,
    step: int,
    state: Pytree,
    *,
    shard_id: int = 0,
    num_shards: int = 1,
    extra: Optional[Dict[str, Any]] = None,
) -> str:
    """Atomic checkpoint write, leaf by leaf; returns the committed path.
    With DTensor leaves every rank of their process group calls this (see
    the module docstring)."""
    final = os.path.join(directory, f"step_{step:08d}")
    tmp = final + f".tmp{shard_id}"
    leaves = _flatten_with_paths(state)
    writer = _is_writer(leaves)
    if writer:
        os.makedirs(directory, exist_ok=True)
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)

    shapes, dtypes = {}, {}
    # np.savez's layout (one stored ``<key>.npy`` member a leaf); a leaf is
    # written on the writer thread while the next one comes to the host
    with (zipfile.ZipFile(os.path.join(tmp, f"arrays_{shard_id}.npz"), "w", allowZip64=True)
          if writer else contextlib.nullcontext()) as zf, \
            concurrent.futures.ThreadPoolExecutor(1) as pool:
        written = None
        for key, leaf in leaves:
            arr, name = _host_array(leaf)
            if writer:
                if written is not None:
                    written.result()
                written = pool.submit(_write_member, zf, key, arr)
                shapes[key], dtypes[key] = list(arr.shape), name
            del arr
        if written is not None:
            written.result()

    if writer:
        manifest = {
            "step": step,
            "num_shards": num_shards,
            "keys": [k for k, _ in leaves],
            "shapes": shapes,
            "dtypes": dtypes,
            "time": time.time(),
            "extra": extra or {},
        }
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)                       # atomic commit
        _write_latest(directory, step)
    if any(is_dtensor(leaf) for _, leaf in leaves):
        from ..launch.compat import barrier

        barrier()
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
    shardings: Optional[Pytree] = None,
    shard_id: int = 0,
) -> Tuple[Pytree, int, Dict[str, Any]]:
    """Restore into the structure of ``state_like`` (a tree whose leaves have
    ``.shape``), each leaf a tensor of the checkpoint's dtype.

    ``shardings`` (a tree of ``NamedSharding`` matching ``state_like``; a
    leaf it leaves out, or None, is not sharded) lays each leaf out on the
    CURRENT mesh, which may differ from the mesh at save time (elastic
    resume): a DTensor whose local shard is this rank's slice of the leaf,
    read from the file; no rank puts a whole sharded leaf on the device.
    Any other leaf lands on its like's device; where the like has no
    storage (a ``meta`` tensor, so the like costs no memory) or is not a
    tensor, on ``device`` (default: the CPU).
    """
    from ..distributed.sharding import from_local, local_slices, mesh_coordinate

    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {directory}")
    path = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    placed = dict(_flatten_with_paths(shardings))
    restored = {}
    with _open_arrays(os.path.join(path, f"arrays_{shard_id}.npz")) as data:
        for key, like in _flatten_with_paths(state_like):
            if key not in data:
                raise KeyError(f"checkpoint {path} missing leaf {key!r}")
            arr = data[key]
            expect = tuple(like.shape)
            if tuple(arr.shape) != expect:
                raise ValueError(
                    f"leaf {key!r}: checkpoint shape {arr.shape} != expected {expect}"
                )
            sharding = placed.get(key)
            if sharding is not None:
                mesh = sharding.mesh
                arr = arr[local_slices(mesh, sharding.spec, arr.shape, mesh_coordinate(mesh))]
            arr = arr if arr.flags.c_contiguous else np.ascontiguousarray(arr)
            if manifest["dtypes"].get(key) == "bfloat16":
                t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
            else:
                t = torch.from_numpy(arr)
            if sharding is not None:
                restored[key] = from_local(t.to(mesh.device_type, copy=True), sharding, expect)
                continue
            keep = isinstance(like, torch.Tensor) and not like.is_meta
            target = like.device if keep else resolve_device(device or "cpu")
            restored[key] = t.to(target, copy=True)
    return _unflatten_like(state_like, restored), step, manifest.get("extra", {})


class _MappedArrays:
    """The leaves of an ``np.savez`` archive whose members are stored
    (uncompressed), each mapped from the file (``np.memmap``, copy on
    write) and read only where it is copied out. Each member's CRC is
    checked on worker threads as it is handed out; :meth:`close` waits for
    them and raises ``zipfile.BadZipFile`` on a mismatch, as ``np.load``
    does on reading a damaged member."""

    def __init__(self, path: str, members: Dict[str, Tuple[int, int, int]]) -> None:
        self.path, self.members = path, members
        self._pool = concurrent.futures.ThreadPoolExecutor(_CRC_THREADS)
        self._checks: List[Tuple[str, int, Any]] = []

    def __contains__(self, key: str) -> bool:
        return key + ".npy" in self.members

    def __getitem__(self, key: str) -> np.ndarray:
        start, size, crc = self.members[key + ".npy"]
        with open(self.path, "rb") as f:
            f.seek(start)
            version = np.lib.format.read_magic(f)
            read_header = {(1, 0): np.lib.format.read_array_header_1_0,
                           (2, 0): np.lib.format.read_array_header_2_0}[version]
            shape, fortran, dtype = read_header(f)
            offset = f.tell()
        if dtype.hasobject:
            raise ValueError(f"leaf {key!r} holds Python objects")
        self._checks.append((key, crc, self._pool.submit(_crc32, self.path, start, size)))
        if not int(np.prod(shape)):
            return np.empty(shape, dtype)
        return np.memmap(self.path, dtype=dtype, mode="c", offset=offset, shape=shape,
                         order="F" if fortran else "C")

    def close(self, check: bool = True) -> None:
        try:
            for key, crc, crc_of in self._checks:
                if check and crc_of.result() != crc:
                    raise zipfile.BadZipFile(f"{self.path}: leaf {key!r} fails its CRC")
        finally:
            self._pool.shutdown(cancel_futures=True)

    def __enter__(self) -> "_MappedArrays":
        return self

    def __exit__(self, exc_type, *exc) -> None:
        self.close(check=exc_type is None)


def _crc32(path: str, start: int, size: int) -> int:
    crc = 0
    with open(path, "rb") as f:
        f.seek(start)
        buf = bytearray(min(size, _CHUNK))
        while size:
            n = f.readinto(memoryview(buf)[:min(size, _CHUNK)])
            if not n:
                raise zipfile.BadZipFile(f"{path}: a member ends early")
            crc = zlib.crc32(memoryview(buf)[:n], crc)
            size -= n
    return crc


def _open_arrays(path: str) -> "_MappedArrays":
    """The leaves of an archive ``np.savez`` wrote (every member stored),
    mapped by key."""
    members = {}
    with zipfile.ZipFile(path) as zf, open(path, "rb") as f:
        for info in zf.infolist():
            if info.compress_type != zipfile.ZIP_STORED:
                raise ValueError(f"{path}: {info.filename} is compressed; a checkpoint's members are stored "
                                 "(np.savez)")
            f.seek(info.header_offset)
            local = f.read(30)
            if local[:4] != b"PK\x03\x04":
                raise zipfile.BadZipFile(f"{path}: no local header for {info.filename}")
            name_len, extra_len = struct.unpack("<HH", local[26:30])
            members[info.filename] = (info.header_offset + 30 + name_len + extra_len, info.file_size, info.CRC)
    return _MappedArrays(path, members)


def _host_copy(state: Pytree) -> Pytree:
    """Every tensor leaf copied to the host (a CPU tensor is copied too; a
    DTensor gathered whole)."""
    def copy(leaf):
        if is_dtensor(leaf):
            leaf = leaf.full_tensor()
        return leaf.detach().to("cpu", copy=True) if isinstance(leaf, torch.Tensor) else np.array(leaf)

    leaves = {k: copy(leaf) for k, leaf in _flatten_with_paths(state)}
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
        self._barrier_at_wait = False
        if async_writes:
            self._worker = threading.Thread(target=self._run, daemon=True)
            self._worker.start()

    # ---- save ----
    def save(self, step: int, state: Pytree, extra: Optional[Dict] = None) -> None:
        if self._last_error is not None:
            err, self._last_error = self._last_error, None
            raise RuntimeError("previous async checkpoint failed") from err
        leaves = _flatten_with_paths(state)
        writer = _is_writer(leaves)
        if self._async:
            # copy NOW (values at this step: the train step updates in
            # place), serialize in background; with DTensors rank 0 writes
            # and every rank waits for it at wait()
            host = _host_copy(state)
            self._barrier_at_wait |= any(is_dtensor(leaf) for _, leaf in leaves)
            if writer:
                self._queue.put((step, host, extra))
        else:
            save_checkpoint(self.directory, step, state, extra=extra)
            if writer:
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
        """Block until every queued write is committed (on a process
        group, every rank's)."""
        if self._async:
            self._queue.join()
            if self._barrier_at_wait:
                from ..launch.compat import barrier

                barrier()
                self._barrier_at_wait = False

    def _gc(self) -> None:
        steps = all_steps(self.directory)
        for s in steps[: -self.keep]:
            shutil.rmtree(
                os.path.join(self.directory, f"step_{s:08d}"), ignore_errors=True
            )

    # ---- restore ----
    def restore_latest(
        self, state_like: Pytree, device: Optional[DeviceLike] = None,
        shardings: Optional[Pytree] = None,
    ) -> Optional[Tuple[Pytree, int, Dict]]:
        step = latest_step(self.directory)
        if step is None:
            return None
        return restore_checkpoint(
            self.directory, state_like, step=step, device=device, shardings=shardings
        )

"""The host side of the port's hand kernels: each CUDA source built into a
shared library with a plain C interface, its C function bound with
``ctypes``, launched on PyTorch's current stream, its launches counted.

Every hand-written kernel of the port is built the same way: at first use,
``nvcc`` compiles ``csrc/<name>.cu`` for ``sm_90a`` into ``build/`` beside
the kernel's module (gitignored), named by a hash of the source and flags so
an edit rebuilds. ``ptxas -v``'s report (registers, shared memory and spills
of every instantiation) is kept beside the library as ``.log``. Nothing is
built when a module is imported.

Each kernel's module declares one :class:`HandKernel`, ``KERNEL``: its
wrapper checks what the kernel does not take, then launches and counts
there. A kernel's counts are ``KERNEL.launches`` and
``KERNEL.launches_by[key]``; ``KERNEL.reset()`` zeroes them.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Any, Callable, Dict, Hashable, Optional, Sequence

import torch

from ..graphs import count_launch

NVCC_FLAGS = (
    "-gencode=arch=compute_90a,code=sm_90a",
    "-std=c++17",
    "-O3",
    "-shared",
    "-Xcompiler",
    "-fPIC",
    "-Xptxas",
    "-v",
)


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels are built from source at first use")


def build_library(source: Path, build_dir: Path) -> Path:
    """Compile ``source`` (once per source and flags) and return the shared
    library's path."""
    key = hashlib.sha256(source.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    lib = build_dir / f"lib{source.stem}-{key}.so"
    if lib.exists():
        return lib
    build_dir.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=build_dir)
    os.close(fd)
    try:
        proc = subprocess.run(
            [nvcc(), *NVCC_FLAGS, "-o", tmp, str(source)],
            capture_output=True, text=True,
        )
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {source.name} ({proc.returncode}):\n{proc.stderr}")
        lib.with_suffix(".log").write_text(proc.stdout + proc.stderr)
        os.replace(tmp, lib)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return lib


class HandKernel:
    """One hand kernel's host side. ``argtypes`` declares the C function's
    arguments but the last, PyTorch's current stream, which :meth:`launch`
    appends; the function returns 0 or an error code, ``errors`` naming its
    own (any other is a CUDA error). :attr:`fn`, the bound function, is
    loaded at the first launch; a harness may set it to another build's
    (:meth:`bind`) for a while."""

    def __init__(self, name: str, source: Path, symbol: str, argtypes: Sequence[Any],
                 keys: Sequence[Hashable], errors: Optional[Dict[int, str]] = None) -> None:
        self.name, self.source, self.symbol, self.keys = name, source, symbol, tuple(keys)
        self.build_dir = source.parent.parent / "build"
        self.argtypes = (*argtypes, ctypes.c_void_p)
        self.errors = errors or {}
        self.fn: Optional[Callable[..., int]] = None
        self.reset()

    def build(self) -> Path:
        """The library's path, compiled first if need be (:func:`build_library`)."""
        return build_library(self.source, self.build_dir)

    def bind(self, path: Path) -> Callable[..., int]:
        """The C function of the library at ``path``, its arguments declared."""
        fn = getattr(ctypes.CDLL(str(path)), self.symbol)
        fn.argtypes, fn.restype = self.argtypes, ctypes.c_int
        return fn

    def load(self) -> Callable[..., int]:
        """:attr:`fn`, built and bound first if need be."""
        if self.fn is None:
            self.fn = self.bind(self.build())
        return self.fn

    def launch(self, index: int, what: Callable[[], str], *args: Any) -> None:
        """Call the C function on ``args`` and PyTorch's current stream of
        CUDA device ``index``, that device current; a nonzero return raises
        ``RuntimeError`` naming the kernel, the error and ``what()``."""
        fn = self.fn or self.load()
        stream = torch._C._cuda_getCurrentRawStream(index)
        if index == torch.cuda.current_device():
            err = fn(*args, stream)
        else:
            with torch.cuda.device(index):
                err = fn(*args, stream)
        if err != 0:
            raise RuntimeError(f"{self.name} kernel launch failed: error {err} "
                               f"({self.errors.get(err, 'CUDA error')}) for {what()}")

    def count(self, key: Hashable) -> None:
        """Count one launch under ``key``, now or at each replay of the graph
        being captured (:func:`repro_torch.graphs.count_launch`)."""
        count_launch(functools.partial(self._bump, key))

    def _bump(self, key: Hashable) -> None:
        self.launches += 1
        self.launches_by[key] += 1

    def reset(self) -> None:
        self.launches = 0
        self.launches_by = dict.fromkeys(self.keys, 0)

"""Build a kernel's CUDA source into a shared library with a plain C
interface, bound with ``ctypes``.

Every hand-written kernel of the port is built the same way: at first use,
``nvcc`` compiles ``csrc/<name>.cu`` for ``sm_90a`` into ``build/`` beside
the kernel's module (gitignored), named by a hash of the source and flags so
an edit rebuilds. ``ptxas -v``'s report (registers, shared memory and spills
of every instantiation) is kept beside the library as ``.log``. Nothing is
built when a module is imported.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

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

"""Mamba-2 SSD chunk scan as a hand-written CUDA C++ kernel for Hopper.

Replaces the reference's Pallas TPU kernel
``src/repro/kernels/ssd/ssd.py:72 ssd_scan_kernel``. The kernel
(``csrc/ssd.cu``) splits the TPU's sequential chunk axis into five passes
(cumsum, C·Bᵀ scores once per B/C group, chunk states, state passing, chunk
scan) with the products on the tensor cores as 3xTF32; its source note
gives the bound and the design. This module builds it, binds it with
``ctypes``, allocates its scratch and checks everything the kernel does not
take.

Two layouts, one kernel: the reference's head-flattened ``xbar [bh, s, p]``,
``logda [bh, s]``, ``B, C [bh, s, n]``, and the model layout
``xbar [b, s, h, p]``, ``logda [b, s, h]``, ``B, C [b, s, g, n]``, where head
``i`` reads group ``i // (h // g)`` (the mapping of ``jnp.repeat``) without
a repeated copy of B and C. Inputs are cast to f32, as the TPU kernel casts
them; the output is in ``xbar``'s dtype.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path
from typing import Tuple

import torch

from ..build import build_library
from .ref import ssd_scan_ref

#: Head dims p instantiated in csrc/ssd.cu (mamba2-1.3b uses 64).
HEAD_DIMS = (16, 32, 64, 128)
#: Largest state dim n the kernel takes (mamba2-1.3b uses 128).
MAX_STATE = 128
#: Longest chunk the kernel takes (mamba2-1.3b uses 256); csrc/ssd.cu
#: asserts at compile time that every accepted shape fits shared memory.
MAX_CHUNK = 4096

#: The kernel's passes, in launch order (bit k of the library's ``passes``
#: mask is ``PASSES[k]``); a scan launches all of them.
PASSES = ("cumsum", "scores", "chunk_state", "state_passing", "chunk_scan")
ALL_PASSES = (1 << len(PASSES)) - 1

SOURCE = Path(__file__).resolve().parent / "csrc" / "ssd.cu"
BUILD_DIR = Path(__file__).resolve().parent / "build"


def build() -> Path:
    """Compile ``csrc/ssd.cu`` (once per source and flags) and return the
    shared library's path."""
    return build_library(SOURCE, BUILD_DIR)


def bind(path: Path) -> ctypes.CDLL:
    """Load a library built from ``csrc/ssd.cu`` and declare its C
    function's arguments."""
    lib = ctypes.CDLL(str(path))
    fn = lib.repro_ssd_scan
    fn.argtypes = (
        [ctypes.c_int]
        + [ctypes.c_void_p] * 8
        + [ctypes.c_int] * 11
        + [ctypes.c_longlong] * 12
        + [ctypes.c_void_p]
    )
    fn.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    return bind(build())


def heads_flat(
    xbar: torch.Tensor, logda: torch.Tensor, b_mat: torch.Tensor, c_mat: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Model layout -> the reference's head-flattened layout, B/C groups
    repeated to heads (``ops.py:40-44`` of the reference)."""
    b, s, h, p = xbar.shape
    g, n = b_mat.shape[2], b_mat.shape[3]
    xf = xbar.transpose(1, 2).reshape(b * h, s, p)
    lf = logda.transpose(1, 2).reshape(b * h, s)
    bf = b_mat.repeat_interleave(h // g, dim=2).transpose(1, 2).reshape(b * h, s, n)
    cf = c_mat.repeat_interleave(h // g, dim=2).transpose(1, 2).reshape(b * h, s, n)
    return xf, lf, bf, cf


def ssd_scan_kernel(
    xbar: torch.Tensor,     # [bh, s, p] or [b, s, h, p]
    logda: torch.Tensor,    # [bh, s] or [b, s, h]
    b_mat: torch.Tensor,    # [bh, s, n] or [b, s, g, n]
    c_mat: torch.Tensor,    # like b_mat
    *,
    chunk: int = 256,
) -> torch.Tensor:
    """``y`` of the SSD scan in ``xbar``'s dtype and layout (contiguous).

    CUDA tensors launch the kernel (or raise); CPU tensors take the plain
    version :func:`~repro_torch.kernels.ssd.ref.ssd_scan_ref`.
    ``ssd_scan_kernel.launches`` counts kernel launches.
    """
    model_layout = xbar.dim() == 4
    if model_layout:
        b, s, h, p = xbar.shape
        g, n = b_mat.shape[2], b_mat.shape[3]
        ok = (tuple(logda.shape) == (b, s, h) and b_mat.dim() == 4
              and tuple(b_mat.shape[:2]) == (b, s) and h % g == 0)
    else:
        if xbar.dim() != 3:
            raise ValueError(f"need xbar [bh, s, p] or [b, s, h, p], got {tuple(xbar.shape)}")
        b, s, p = xbar.shape
        h, g, n = 1, 1, b_mat.shape[-1]
        ok = tuple(logda.shape) == (b, s) and b_mat.dim() == 3 and tuple(b_mat.shape[:2]) == (b, s)
    if not ok or c_mat.shape != b_mat.shape:
        raise ValueError(f"shapes do not fit: xbar {tuple(xbar.shape)}, logda {tuple(logda.shape)}, "
                         f"B {tuple(b_mat.shape)}, C {tuple(c_mat.shape)}")
    chunk = min(chunk, s)
    if chunk <= 0 or s % chunk:
        raise ValueError(f"seq {s} % chunk {chunk} != 0")
    if p not in HEAD_DIMS:
        raise ValueError(f"head dim {p} not instantiated; the CUDA kernel takes {HEAD_DIMS}")
    if n > MAX_STATE:
        raise ValueError(f"state dim {n} > {MAX_STATE}, the kernel's largest")
    if chunk > MAX_CHUNK:
        raise ValueError(f"chunk {chunk} > {MAX_CHUNK}, the kernel's longest")
    tensors = (xbar, logda, b_mat, c_mat)
    if all(x.device.type == "cpu" for x in tensors):
        if not model_layout:
            return ssd_scan_ref(xbar, logda, b_mat, c_mat)[0]
        y, _ = ssd_scan_ref(*heads_flat(xbar, logda, b_mat, c_mat))
        return y.reshape(b, h, s, p).transpose(1, 2).contiguous()
    if not (xbar.is_cuda and all(x.device == xbar.device for x in tensors)):
        raise ValueError("xbar, logda, B, C must lie on one CUDA device, got "
                         + ", ".join(str(x.device) for x in tensors))
    if not all(x.is_floating_point() for x in tensors):
        raise ValueError("xbar, logda, B, C must be floating point")
    launch = _launcher(xbar, tensors, model_layout, chunk)
    if launch.y.numel() == 0:
        return launch.y.reshape(xbar.shape).to(xbar.dtype)
    launch(ALL_PASSES)
    ssd_scan_kernel.launches += 1
    return launch.y.reshape(xbar.shape).to(xbar.dtype)


class _Launch:
    """One scan's f32 inputs in the model layout, its output and scratch on
    the card, and the library call that launches any subset of the passes
    on them (all of them for a scan; one at a time when a harness times the
    passes)."""

    def __init__(self, x4, l3, b4, c4, chunk):
        b, s, h, p = x4.shape
        g, n = b4.shape[2], b4.shape[3]
        nc = s // chunk
        ns, qp = -(-n // 4) * 4, -(-chunk // 4) * 4  # scratch pitches, multiples of 4
        dev = x4.device
        self.y = torch.empty(x4.shape, dtype=torch.float32, device=dev)
        self.cum = torch.empty((b, h, s), dtype=torch.float64, device=dev)
        self.scores = torch.empty((b, nc, g, chunk, qp), dtype=torch.float32, device=dev)
        self.states = torch.empty((b, nc + 1, h, p, ns), dtype=torch.float32, device=dev)
        self.inputs = (x4, l3, b4, c4)  # alive while the library reads them
        self.what = f"xbar {tuple(x4.shape)}, n {n}, chunk {chunk}"
        vec_x = x4.data_ptr() % 16 == 0
        vec_bc = n % 4 == 0 and b4.data_ptr() % 16 == 0 and c4.data_ptr() % 16 == 0
        self.args = (
            p, x4.data_ptr(), l3.data_ptr(), b4.data_ptr(), c4.data_ptr(), self.y.data_ptr(),
            self.cum.data_ptr(), self.scores.data_ptr(), self.states.data_ptr(),
            b, h, h // g, s, chunk, n, ns, qp, int(vec_x), int(vec_bc),
        )
        self.strides = [t.stride(i) for t in (x4, l3, b4, self.y) for i in (0, 2, 1)]  # b, h|g, s

    def __call__(self, passes: int) -> None:
        dev = self.y.device
        with torch.cuda.device(dev):
            err = _library().repro_ssd_scan(*self.args, passes, *self.strides,
                                            torch.cuda.current_stream(dev).cuda_stream)
        if err != 0:
            raise RuntimeError(f"SSD kernel launch failed: error {err} for {self.what}")


def _launcher(xbar, tensors, model_layout: bool, chunk: int) -> _Launch:
    """The f32 model-layout views of the inputs ([bh, s, *] is the case
    h = 1) with their output and scratch allocated."""
    x4, l3, b4, c4 = (x.float().contiguous() for x in tensors)
    if not model_layout:
        x4, l3, b4, c4 = x4.unsqueeze(2), l3.unsqueeze(2), b4.unsqueeze(2), c4.unsqueeze(2)
    return _Launch(x4, l3, b4, c4, chunk)


def pass_launcher(xbar, logda, b_mat, c_mat, *, chunk: int = 256) -> _Launch:
    """A launcher of the passes on these CUDA inputs in the model layout,
    for timing each pass on its own: ``run(ALL_PASSES)`` fills the scratch
    and ``y``, then ``run(1 << k)`` repeats pass ``PASSES[k]`` on it. Counts
    no launch; the path goes through :func:`ssd_scan_kernel`."""
    return _launcher(xbar, (xbar, logda, b_mat, c_mat), True, min(chunk, xbar.shape[1]))


ssd_scan_kernel.launches = 0

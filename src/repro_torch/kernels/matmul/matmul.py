"""Blocked GEMM as a hand-written CUDA C++ kernel for Hopper — the paper's
compute substrate on the H100.

Replaces the reference's Pallas TPU kernel
``src/repro/kernels/matmul/matmul.py:45 matmul_kernel``. The kernel
(``csrc/gemm.cu``) tiles the output over CTAs, feeds a ring of
shared-memory stages with ``cp.async`` and runs its products on the tensor
cores with ``mma.sync``: f32 inputs as 3xTF32 (each operand split into two
TF32 halves, three products), bf16 inputs directly; its source note gives
the bound and the design. This module declares its host side
(:data:`KERNEL`), picks its copy mode (:func:`copy_mode`) and checks
everything the kernel does not take.

Tile shapes stay parameters because ``matmul_blocks_site`` ranks them, but
only the instantiated set :data:`SUPPORTED_TILES` exists. The reference's
256/512 tiles cannot be a CTA tile on Hopper (a 256 x 256 f32 accumulator
alone fills an SM's 64K-register file), and an unsupported tile raises
``ValueError`` instead of being mapped onto another one — the site would
otherwise rank identical variants under different names. Ragged edges are
masked in the kernel, so every tile is valid for every shape and the
reference's ``min(block, dim)`` clamping is not needed.

Build: at first launch, ``nvcc`` compiles the source for ``sm_90a`` into a
shared library with a plain C interface under ``build/`` beside this file
(:mod:`repro_torch.kernels.build`). Nothing is built or imported from CUDA
when this module is imported.
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Optional, Tuple, Union

import torch

from ..build import HandKernel
from .ref import matmul_ref

#: (block_m, block_n, block_k) tiles instantiated in csrc/gemm.cu: the
#: census tiles 16/32/64 and the 128 x 128 tiles of eight warps.
SUPPORTED_TILES: Tuple[Tuple[int, int, int], ...] = (
    (16, 16, 16),
    (32, 32, 32),
    (64, 64, 64),
    (128, 128, 8),
    (128, 128, 16),
)
#: Default tile of :func:`matmul_kernel` and :func:`repro_torch.kernels.matmul.ops.matmul`:
#: the fastest of the set at the chain's ~1000-wide GEMMs on an H100 SXM
#: (``chip_smoke.py`` phase 4, PERF.md), where 128 x 128 tiles leave SMs idle.
DEFAULT_TILE: Tuple[int, int, int] = (64, 64, 64)

SOURCE = Path(__file__).resolve().parent / "csrc" / "gemm.cu"
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_MAX_GRID_Y = 65535

#: The kernel's 16-byte copies of f32 rows at any 4-byte alignment: each row
#: from the 16-byte boundary at or below its first element (csrc/gemm.cu).
SHIFT = "16-shift"
#: The kernel's copy modes, each a key of ``KERNEL.launches_by``:
#: 16-byte ``cp.async`` where every row starts on a 16-byte boundary,
#: :data:`SHIFT` (f32 inputs only) and 4-byte copies.
COPY_WIDTHS: Tuple[Union[int, str], ...] = (16, SHIFT, 4)
#: ``repro_gemm``'s sixth argument for each mode (gemm.cu's kShift16 is -16).
_COPY_CODE = {16: 16, SHIFT: -16, 4: 4}

#: The GEMM's build, ``repro_gemm`` and its launches counted by copy mode
#: (:class:`repro_torch.kernels.build.HandKernel`).
KERNEL = HandKernel(
    "GEMM", SOURCE, "repro_gemm",
    [ctypes.c_int] * 6 + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_longlong] * 3,
    keys=COPY_WIDTHS)
#: Compile ``csrc/gemm.cu`` (once per source and flags); the library's path.
build = KERNEL.build


def copy_bytes(*tensors: torch.Tensor) -> int:
    """The kernel's copy width for these row-major matrices (A, B and C):
    16 bytes where every base address and row stride is a multiple of 16
    bytes, else 4. A 16-byte ``cp.async`` at an address off a 16-byte
    boundary faults, so the width follows the layout and never a failure.
    Pure: the CPU tests call it on CPU tensors."""
    for t in tensors:
        if t.data_ptr() % 16 or (t.stride(0) * t.element_size()) % 16:
            return 4
    return 16


def copy_mode(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> Union[int, str]:
    """The launch's copy mode (a key of :data:`COPY_WIDTHS`) for the
    row-major A, B and C: 16 where :func:`copy_bytes` gives 16;
    :data:`SHIFT` for f32 inputs whose bases lie on a 16-byte boundary,
    whatever their row strides (a chunk's head before a row's first element
    then lies in the row before it, and row 0 has none; C is stored element
    by element); else 4, as for a base off a boundary or bf16 rows that are.
    Pure: the CPU tests call it on CPU tensors."""
    if copy_bytes(a, b, c) == 16:
        return 16
    if a.dtype == torch.float32 and not (a.data_ptr() % 16 or b.data_ptr() % 16):
        return SHIFT
    return 4


def check_tile(block_m: int, block_n: int, block_k: int) -> None:
    tile = (block_m, block_n, block_k)
    if tile not in SUPPORTED_TILES:
        raise ValueError(
            f"unsupported GEMM tile {tile}; the CUDA kernel is instantiated for "
            f"{SUPPORTED_TILES} only (TPU tiles of 256/512 do not fit a CTA on "
            "Hopper, and no tile is mapped onto another)"
        )


def matmul_kernel(
    a: torch.Tensor,              # [m, k]
    b: torch.Tensor,              # [k, n]
    *,
    block_m: int = DEFAULT_TILE[0],
    block_n: int = DEFAULT_TILE[1],
    block_k: int = DEFAULT_TILE[2],
    out_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """``a @ b`` by the hand-written GEMM, f32 accumulation, cast to
    ``out_dtype`` (default ``a.dtype``).

    CUDA tensors launch the kernel (or raise); CPU tensors take the plain
    version :func:`~repro_torch.kernels.matmul.ref.matmul_ref`.
    ``KERNEL`` counts the launches, by copy mode.
    """
    check_tile(block_m, block_n, block_k)
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"need a[m,k] @ b[k,n], got {tuple(a.shape)} @ {tuple(b.shape)}")
    if a.dtype != b.dtype or a.dtype not in _DTYPE_CODE:
        raise ValueError(f"inputs must both be float32 or bfloat16, got {a.dtype}, {b.dtype}")
    out_dtype = out_dtype or a.dtype
    if out_dtype not in _DTYPE_CODE:
        raise ValueError(f"out_dtype must be float32 or bfloat16, got {out_dtype}")
    if a.device.type == "cpu" and b.device.type == "cpu":
        return matmul_ref(a, b, out_dtype)
    if not (a.is_cuda and a.device == b.device):
        raise ValueError(f"inputs must lie on one CUDA device, got {a.device}, {b.device}")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("the GEMM kernel takes contiguous row-major inputs")
    m, k = a.shape
    n = b.shape[1]
    c = torch.empty((m, n), dtype=out_dtype, device=a.device)
    if m == 0 or n == 0:
        return c
    if -(-m // block_m) > _MAX_GRID_Y:
        raise ValueError(f"m={m} needs more than {_MAX_GRID_Y} row tiles of {block_m}")
    mode = copy_mode(a, b, c)
    launch(a, b, c, (block_m, block_n, block_k), mode)
    KERNEL.count(mode)
    return c


def launch(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor, tile: Tuple[int, int, int],
           mode: Union[int, str]) -> None:
    """One launch of the kernel, ``c = a @ b``, on PyTorch's current stream
    of their device, in copy mode ``mode``; raises if it fails. Checks and
    counts nothing: :func:`matmul_kernel` checks, picks the mode by
    :func:`copy_mode` and counts; the card's tests and ``chip_smoke.py``
    launch each mode on the same tensors to compare them."""
    m, k = a.shape
    n = b.shape[1]
    KERNEL.launch(a.device.index, lambda: f"tile {tile}, shape {(m, k, n)}, copy mode {mode}",
                  *tile, _DTYPE_CODE[a.dtype], _DTYPE_CODE[c.dtype], _COPY_CODE[mode],
                  a.data_ptr(), b.data_ptr(), c.data_ptr(), m, n, k,
                  a.stride(0), b.stride(0), c.stride(0))

"""Flash attention (forward) as a hand-written CUDA C++ kernel for Hopper.

Replaces the reference's Pallas TPU kernel
``src/repro/kernels/flash_attention/flash_attention.py:103
flash_attention_kernel``. ``csrc/flash_attention.cu`` holds two kernels,
chosen by dtype, each with one CTA per (batch * head, 128-query tile): in
bf16 both products run on the tensor cores (``wgmma``), with K and V brought
by TMA into a ring of shared-memory stages that a producer warpgroup keeps
filled; in f32 both run on the tensor cores as 3xTF32 (``mma.sync``, each
f32 operand split into two TF32 parts, three TF32 products per product), with
K and V brought by ``cp.async`` into a 2-stage ring. Both walk only the kv
tiles their queries can see and keep the online-softmax state in f32
registers; the source note gives the bound and the design. This module builds
the kernels, binds them with ``ctypes`` and checks everything they do not
take.

Two layouts, one kernel: the reference's head-flattened ``[bh, s, d]`` and
the model layout ``q [b, sq, h, d]``, ``k, v [b, skv, kv_heads, d]``, where
query head ``i`` reads kv head ``i // (h // kv_heads)`` (the mapping of
``jnp.repeat``) without a repeated copy of ``k`` and ``v``.

``block_q`` / ``block_k`` keep the reference's contract (``min(block, seq)``
and ``ValueError`` unless they divide the sequences); the CUDA kernels' own
tiles are 128 x 128 (bf16) and 128 x 32 (f32), since the reference's
128 x 512 blocks do not fit a CTA at ``d = 128``. The tile changes only the
order of the sums.
"""

from __future__ import annotations

import ctypes
import functools
import math
from pathlib import Path
from typing import Optional, Tuple

import torch

from ..build import build_library
from .ref import flash_attention_plain

#: Head dims instantiated in csrc/flash_attention.cu: the test shapes and
#: the full-width configurations (qwen3-14b and gemma2-27b use 128).
HEAD_DIMS = (32, 64, 128)

SOURCE = Path(__file__).resolve().parent / "csrc" / "flash_attention.cu"
BUILD_DIR = Path(__file__).resolve().parent / "build"
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_MAX_GRID_Y = 65535
_TILE_Q = 128  # query rows of a CTA (both kernels): the grid's y extent is ceil(sq / 128)
# The C entry point's own error codes (csrc/flash_attention.cu, its note's end).
_ERRORS = {-1: "head dim not instantiated", -2: "dtype not taken",
           -3: "a TMA tensor map could not be encoded",
           -4: "the driver's cuTensorMapEncodeTiled was not found"}


def build() -> Path:
    """Compile ``csrc/flash_attention.cu`` (once per source and flags) and
    return the shared library's path."""
    return build_library(SOURCE, BUILD_DIR)


def bind(path: Path) -> ctypes.CDLL:
    """Load a library built from ``csrc/flash_attention.cu`` and declare its
    C function's arguments."""
    lib = ctypes.CDLL(str(path))
    fn = lib.repro_flash_attention
    fn.argtypes = (
        [ctypes.c_int] * 2
        + [ctypes.c_void_p] * 4
        + [ctypes.c_int] * 10
        + [ctypes.c_float] * 2
        + [ctypes.c_longlong] * 12
        + [ctypes.c_void_p]
    )
    fn.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    return bind(build())


def check_tma_layout(shape, strides, data_ptr: int, element_size: int) -> None:
    """Raise ``ValueError`` unless TMA can read a ``[b, s, h, d]`` tensor of
    this shape, element strides, address and element size: a 16-byte-aligned
    base, ``d`` contiguous, and every other stride of an extent above 1 a
    multiple of 16 bytes below 2^40 bytes. Pure, so the CPU tests reach it;
    nothing is copied to make a tensor fit."""
    if data_ptr % 16:
        raise ValueError(f"TMA needs a 16-byte-aligned base; this tensor starts {data_ptr % 16} "
                         f"bytes past a 16-byte boundary (a view at an offset?)")
    if shape[-1] > 1 and strides[-1] != 1:
        raise ValueError(f"TMA needs the head dim contiguous, got strides {tuple(strides)}")
    for size, stride in zip(shape[:-1], strides[:-1]):
        nbytes = stride * element_size
        if size > 1 and (nbytes % 16 or not 0 < nbytes < 2**40):
            raise ValueError(f"TMA needs strides that are multiples of 16 bytes below 2^40, "
                             f"got {tuple(strides)} elements of {element_size} bytes")


def check_copy_alignment(data_ptr: int) -> None:
    """Raise ``ValueError`` unless the f32 kernel's 16-byte ``cp.async``
    copies can read a contiguous tensor at this address (its rows, ``d`` of
    32, 64 or 128 floats, are then 16-byte multiples). Nothing is copied to
    make a tensor fit."""
    if data_ptr % 16:
        raise ValueError(f"the f32 kernel's 16-byte copies need a 16-byte-aligned base; this "
                         f"tensor starts {data_ptr % 16} bytes past a 16-byte boundary (a view at an offset?)")


def _strides(x: torch.Tensor) -> Tuple[int, int, int]:
    """(b, h, s) strides of a contiguous [b, s, h, d] tensor; an extent of 1
    takes the stride a contiguous tensor would have (torch leaves it free,
    a TMA map does not)."""
    canonical = [math.prod(x.shape[i + 1:]) for i in range(4)]
    return tuple(x.stride(i) if x.shape[i] > 1 else canonical[i] for i in (0, 2, 1))


def heads_flat(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Model layout -> the reference's head-flattened layout, kv heads
    repeated to the query heads (``ops.py:44-51`` of the reference)."""
    b, _, h, d = q.shape
    g = h // k.shape[2]
    k = k.repeat_interleave(g, dim=2)
    v = v.repeat_interleave(g, dim=2)
    return tuple(x.transpose(1, 2).reshape(b * h, x.shape[1], d) for x in (q, k, v))


def flash_attention_kernel(
    q: torch.Tensor,      # [bh, sq, d] or [b, sq, h, d]
    k: torch.Tensor,      # [bh, skv, d] or [b, skv, kv_heads, d]
    v: torch.Tensor,      # like k
    *,
    causal: bool = True,
    sm_scale: Optional[float] = None,
    logit_cap: Optional[float] = None,
    window: Optional[int] = None,
    block_q: int = 128,
    block_k: int = 512,
) -> torch.Tensor:
    """Attention by the hand-written kernel, output in ``q``'s dtype and
    layout (contiguous).

    CUDA tensors launch the kernel (or raise); CPU tensors take the plain
    version :func:`~repro_torch.kernels.flash_attention.ref.flash_attention_plain`.
    ``flash_attention_kernel.launches`` counts kernel launches, and
    ``launches_by_dtype`` splits them between the f32 and the bf16 kernel.
    """
    if q.dim() not in (3, 4) or k.dim() != q.dim() or v.shape != k.shape:
        raise ValueError(f"need q, k, v all [bh, s, d] or all [b, s, h, d], got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    model_layout = q.dim() == 4
    q4 = q if model_layout else q.unsqueeze(2)  # [b, s, h, d]; h = 1 for [bh, s, d]
    k4 = k if model_layout else k.unsqueeze(2)
    v4 = v if model_layout else v.unsqueeze(2)
    b, sq, h, d = q4.shape
    skv, kh = k4.shape[1], k4.shape[2]
    if k4.shape[0] != b or k4.shape[3] != d or h % kh:
        raise ValueError(f"k/v {tuple(k.shape)} do not fit q {tuple(q.shape)}")
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d} not instantiated; the CUDA kernel takes {HEAD_DIMS}")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _DTYPE_CODE:
        raise ValueError(f"q, k, v must all be float32 or bfloat16, got {q.dtype}, {k.dtype}, {v.dtype}")
    block_q = min(block_q, sq)
    block_k = min(block_k, skv)
    if sq % block_q or skv % block_k:
        raise ValueError(f"seq ({sq},{skv}) must divide blocks ({block_q},{block_k})")
    kw = dict(causal=causal, sm_scale=sm_scale, logit_cap=logit_cap, window=window)
    if all(x.device.type == "cpu" for x in (q, k, v)):
        if not model_layout:
            return flash_attention_plain(q, k, v, **kw)
        of = flash_attention_plain(*heads_flat(q, k, v), **kw)
        return of.reshape(b, h, sq, d).transpose(1, 2).contiguous()
    if not (q.is_cuda and q.device == k.device == v.device):
        raise ValueError(f"q, k, v must lie on one CUDA device, got {q.device}, {k.device}, {v.device}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("the flash-attention kernel takes contiguous q, k, v")
    if -(-sq // _TILE_Q) > _MAX_GRID_Y:
        raise ValueError(f"sq = {sq} needs more than {_MAX_GRID_Y} query tiles")
    if q.dtype == torch.bfloat16:
        for x in (q4, k4, v4):
            check_tma_layout(x.shape, x.stride(), x.data_ptr(), x.element_size())
    else:
        for x in (q, k, v):
            check_copy_alignment(x.data_ptr())
    o = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    o4 = o if model_layout else o.unsqueeze(2)
    if o.numel() == 0:
        return o
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(d)
    strides = [st for x in (q4, k4, v4, o4) for st in _strides(x)]  # b, h, s
    lib = _library()
    with torch.cuda.device(q.device):
        err = lib.repro_flash_attention(
            d, _DTYPE_CODE[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            b, h, h // kh, sq, skv, skv - sq if causal else 0,
            int(causal), int(window is not None), int(window or 0),
            int(bool(logit_cap)), float(logit_cap or 0.0), float(scale),
            *strides,
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    if err != 0:
        what = _ERRORS.get(err, "CUDA error")
        raise RuntimeError(f"flash-attention kernel launch failed: error {err} ({what}) for "
                           f"q {tuple(q.shape)}, k {tuple(k.shape)}, {q.dtype}")
    flash_attention_kernel.launches += 1
    flash_attention_kernel.launches_by_dtype[str(q.dtype).split(".")[1]] += 1
    return o


def reset_counts() -> None:
    """Set the kernel's launch counters to 0."""
    flash_attention_kernel.launches = 0
    flash_attention_kernel.launches_by_dtype = {"float32": 0, "bfloat16": 0}


reset_counts()

"""Device selection and the blocking contract shared by the port's builders."""

from __future__ import annotations

from typing import TYPE_CHECKING, Union

if TYPE_CHECKING:
    import torch

# A string annotation: the host-only surfaces (census planner, fsck, the
# oracle) import this module and must not pay torch's import.
DeviceLike = Union[str, "torch.device"]


def resolve_device(device: DeviceLike) -> "torch.device":
    """``torch.device(device)``, refusing a CUDA device the host lacks.

    The port never falls back to the CPU: a caller that wants the CPU says
    so with ``device="cpu"``.
    """
    import torch

    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} requested but no CUDA device is available; "
            "pass device='cpu' explicitly to run on the CPU"
        )
    return dev


def block(out: "torch.Tensor") -> "torch.Tensor":
    """Wait until ``out`` (a tensor, or a tuple of tensors on one device)
    is computed: ``torch.cuda.synchronize()`` for CUDA tensors (kernels are
    queued asynchronously); a CPU tensor is finished when the operation
    returns."""
    first = out[0] if isinstance(out, tuple) else out
    if first.is_cuda:
        import torch

        torch.cuda.synchronize(first.device)
    return out

"""Layer helpers (the reference's ``models/layers.py``); the port has
``softcap`` so far."""

from __future__ import annotations

from typing import Optional

import torch


def softcap(x: torch.Tensor, cap: Optional[float]) -> torch.Tensor:
    if cap is None:
        return x
    return cap * torch.tanh(x / cap)

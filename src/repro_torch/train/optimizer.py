"""Optimizers (AdamW, Adafactor-mini) and LR schedules (the reference's
``train/optimizer.py``) over the port's parameter trees.

Mixed precision layout as the reference's: model params live in
``param_dtype`` (bf16 at full width); the optimizer keeps an f32 master copy
plus f32 moments, 12 bytes a parameter beside the params' 2.

An update works leaf by leaf and in place: the state's tensors are
overwritten (the reference donates its train state to the step), and each
leaf is taken in flat chunks of at most ``CHUNK`` elements. The arithmetic is
elementwise, in the reference's f32 order — global norm, clip, moments, bias
correction, update, cast — so chunking changes no number but the norm's
summation order, while the transient memory stays a few chunks instead of
whole f32 trees (one is 13.2 GB at granite-moe-3b-a800m's 3.30 B
parameters). The step counter and the schedule live on the host (a 0-d
int32 CPU tensor, and Python floats holding f32 values), so an update waits
for nothing on the device.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..models.layers import is_dtensor, reduce_partial, torch_dtype, tree_leaves, tree_map

Pytree = Any
Schedule = Callable[[int], float]

CHUNK = 1 << 26  # elements of one leaf updated at a time (256 MB in f32)

_f32 = np.float32


# -------------------------------------------------------------- schedules --

def cosine_schedule(
    peak_lr: float,
    warmup_steps: int,
    total_steps: int,
    final_frac: float = 0.1,
) -> Schedule:
    """Linear warm-up, then cosine decay to ``final_frac * peak_lr``; the
    step's learning rate in f32 arithmetic, as a Python float."""
    def lr(step) -> float:
        step = _f32(int(step))
        warm = _f32(peak_lr) * step / _f32(max(warmup_steps, 1))
        progress = np.clip(
            (step - _f32(warmup_steps)) / _f32(max(total_steps - warmup_steps, 1)), _f32(0.0), _f32(1.0)
        )
        cos = _f32(peak_lr) * (
            _f32(final_frac) + _f32((1 - final_frac) * 0.5) * (_f32(1.0) + np.cos(_f32(np.pi) * progress))
        )
        return float(warm if step < warmup_steps else cos)

    return lr


def constant_schedule(lr_value: float) -> Schedule:
    return lambda step: float(_f32(lr_value))


def _chunks(*tensors: torch.Tensor):
    """Matching flat chunks of equally shaped tensors (views of the state's
    own, which are contiguous, so writes to a chunk reach the tensor)."""
    return zip(*(t.reshape(-1).split(CHUNK) for t in tensors))


def _locals(p: torch.Tensor, *rest: torch.Tensor):
    """The leaves of one parameter as plain tensors: DTensors as this
    rank's shards (the others laid out as ``p`` first), so an elementwise
    update works in place on each rank's own part."""
    if not is_dtensor(p):
        return (p,) + rest
    pl = tuple(p.placements)
    return (p.to_local(),) + tuple(
        (t if tuple(t.placements) == pl else t.redistribute(p.device_mesh, pl)).to_local() for t in rest)


def _local_value(x: torch.Tensor) -> torch.Tensor:
    """A replicated DTensor's value as a plain tensor (anything else as it is)."""
    return reduce_partial(x).to_local() if is_dtensor(x) else x


def _f32_copy(p: torch.Tensor) -> torch.Tensor:
    # always a copy: with f32 params a cast would alias the working params,
    # which the in-place update would then overwrite as master
    return p.detach().to(torch.float32, copy=True)


def _zeros(shape, like: torch.Tensor) -> torch.Tensor:
    return torch.zeros(shape, dtype=torch.float32, device=like.device)


def _zeros_like(p: torch.Tensor) -> torch.Tensor:
    """f32 zeros shaped and laid out as ``p`` (a DTensor's on its own shards)."""
    return torch.zeros_like(p, dtype=torch.float32) if is_dtensor(p) else _zeros(p.shape, p)


def _step_tensor(step: int) -> torch.Tensor:
    return torch.tensor(step, dtype=torch.int32)


def _write_params(master: Pytree, param_dtype, params: Optional[Pytree]) -> Pytree:
    """The master weights cast to ``param_dtype``: into ``params`` in place
    when given, else as new tensors."""
    if params is None:
        dtype = torch_dtype(param_dtype)
        return tree_map(lambda m: m.to(dtype, copy=True), master)
    tree_map(lambda p, m: p.copy_(m), params, master)
    return params


# ------------------------------------------------------------------ AdamW --

class AdamWState(NamedTuple):
    step: torch.Tensor    # scalar int32, on the host
    master: Pytree        # f32 master params
    mu: Pytree            # f32 first moment
    nu: Pytree            # f32 second moment


@dataclass(frozen=True)
class AdamW:
    schedule: Schedule
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: Optional[float] = 1.0

    def init(self, params: Pytree) -> AdamWState:
        return AdamWState(
            step=_step_tensor(0),
            master=tree_map(_f32_copy, params),
            mu=tree_map(_zeros_like, params),
            nu=tree_map(_zeros_like, params),
        )

    @torch.no_grad()
    def update(
        self, grads: Pytree, state: AdamWState, param_dtype: torch.dtype,
        params: Optional[Pytree] = None,
    ) -> Tuple[Pytree, AdamWState, Dict[str, torch.Tensor]]:
        """Returns (new params, new state, metrics). ``state``'s tensors are
        updated in place; the new params are written into ``params`` when
        given (the train step passes its working copy), else made anew."""
        step = int(state.step) + 1
        gnorm = global_norm(grads)
        scale = None
        if self.clip_norm is not None:
            scale = _local_value(torch.clamp(self.clip_norm / (gnorm + 1e-9), max=1.0))
        b1, b2 = self.b1, self.b2
        bc1 = float(_f32(1.0) - _f32(b1) ** _f32(step))
        bc2 = float(_f32(1.0) - _f32(b2) ** _f32(step))
        lr = self.schedule(step)

        def upd(p, g, m, v):
            for pc, gc, mc, vc in _chunks(*_locals(p, g, m, v)):
                gc = gc.float() if scale is None else gc.float() * scale
                mc.mul_(b1).add_(gc * (1 - b1))
                vc.mul_(b2).add_(gc * (1 - b2) * gc)
                denom = (vc / bc2).sqrt_().add_(self.eps)
                u = (mc / bc1).div_(denom).add_(pc * self.weight_decay)
                pc.sub_(u.mul_(lr))

        tree_map(upd, state.master, grads, state.mu, state.nu)
        params = _write_params(state.master, param_dtype, params)
        metrics = {"grad_norm": gnorm, "lr": torch.tensor(lr, dtype=torch.float32)}
        return params, state._replace(step=_step_tensor(step)), metrics


# -------------------------------------------------------------- Adafactor --

class AdafactorState(NamedTuple):
    step: torch.Tensor
    master: Pytree
    vr: Pytree            # row second-moment factors (or full v for <2D)
    vc: Pytree            # col second-moment factors


@dataclass(frozen=True)
class Adafactor:
    """Factored second moments (Shazeer & Stern) — 4→~2 bytes/param state.

    Memory-saving option for the largest archs; moments for rank>=2 leaves
    are factored over the last two dims.
    """

    schedule: Schedule
    decay: float = 0.8
    eps: float = 1e-30
    clip_threshold: float = 1.0
    weight_decay: float = 0.0

    def init(self, params: Pytree) -> AdafactorState:
        def vr_init(p):
            return _zeros(p.shape[:-1] if p.ndim >= 2 else p.shape, p)

        def vc_init(p):
            return _zeros(p.shape[:-2] + p.shape[-1:] if p.ndim >= 2 else (), p)

        return AdafactorState(
            step=_step_tensor(0),
            master=tree_map(_f32_copy, params),
            vr=tree_map(vr_init, params),
            vc=tree_map(vc_init, params),
        )

    @torch.no_grad()
    def update(self, grads, state, param_dtype, params=None):
        """As :meth:`AdamW.update`; each leaf's update whole (its RMS clip
        spans the leaf)."""
        step = int(state.step) + 1
        beta = float(_f32(1.0) - _f32(step) ** _f32(-self.decay))
        one_minus_beta = float(_f32(1.0) - _f32(beta))
        lr = self.schedule(step)
        lr_wd = float(_f32(lr) * _f32(self.weight_decay))

        def upd(p, g, vr, vc):
            g = g.float()
            g2 = g * g + self.eps
            if p.ndim >= 2:
                vr.mul_(beta).add_(g2.mean(dim=-1) * one_minus_beta)
                vc.mul_(beta).add_(g2.mean(dim=-2) * one_minus_beta)
                r = vr / vr.mean(dim=-1, keepdim=True).clamp_min(self.eps)
                u = g / torch.sqrt(r[..., None] * vc[..., None, :] + self.eps)
            else:
                vr.mul_(beta).add_(g2 * one_minus_beta)
                u = g / torch.sqrt(vr + self.eps)
            rms_u = torch.sqrt(torch.mean(u * u) + 1e-12)
            u = u / torch.clamp(rms_u / self.clip_threshold, min=1.0)
            p.copy_(p - u * lr - p * lr_wd)

        tree_map(upd, state.master, grads, state.vr, state.vc)
        params = _write_params(state.master, param_dtype, params)
        metrics = {"grad_norm": global_norm(grads), "lr": torch.tensor(lr, dtype=torch.float32)}
        return params, state._replace(step=_step_tensor(step)), metrics


@torch.no_grad()
def global_norm(tree: Pytree) -> torch.Tensor:
    """sqrt of the sum of every leaf's squares, in f32 (chunk by chunk; a
    DTensor leaf's over its shards, summed across the ranks)."""
    return torch.sqrt(sum(
        x.float().square().sum() if is_dtensor(x) else sum(c.float().square().sum() for (c,) in _chunks(x))
        for x in tree_leaves(tree)
    ))

"""Training step builder: loss, grad accumulation and the optimizer update
(the reference's ``train/trainer.py``).

``make_train_step`` returns ``(train_state, batch) -> (train_state, metrics)``
with:

* next-token cross-entropy (+ router aux loss, + optional z-loss) computed
  in f32;
* microbatch gradient accumulation as a loop inside the step (the
  reference's ``lax.scan``), f32 accumulators averaged as the reference's;
* remat on the layer unit (``ForwardOptions.remat``);
* AdamW/Adafactor update on the f32 master copy, the param re-cast written
  into the working params.

The step consumes its state, as the reference's jitted step donates it: the
params and the optimizer's tensors are updated in place, and the state
returned holds the same tensors. Batch leaves (numpy arrays or tensors) go
to the params' device; metrics come back as 0-d tensors.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, NamedTuple, Tuple

import torch

from ..device import DeviceLike
from ..models import ForwardOptions, ModelConfig, encdec_forward, lm_forward
from ..models.layers import is_dtensor, params_from_numpy, reduce_partial, tree_leaves, tree_map
from .optimizer import AdafactorState, AdamW, AdamWState

Pytree = Any
Batch = Dict[str, Any]


class TrainState(NamedTuple):
    params: Pytree          # param_dtype (bf16) working copy
    opt: Any                # AdamWState / AdafactorState (f32)


@dataclass(frozen=True)
class LossConfig:
    z_loss: float = 0.0
    aux_coef: float = 0.001
    label_ignore: int = -1


def cross_entropy(
    logits: torch.Tensor,       # [b, s, V] f32
    labels: torch.Tensor,       # [b, s] int; label_ignore masked out
    loss_cfg: LossConfig,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    mask = (labels != loss_cfg.label_ignore).float()
    safe_labels = labels.clamp_min(0).long()
    if is_dtensor(logits):
        lse, gold = _vocab_parallel_lse_gold(logits, safe_labels)
    else:
        lse = torch.logsumexp(logits, dim=-1)                    # [b, s]
        gold = torch.gather(logits, -1, safe_labels[..., None])[..., 0]
    nll = (lse - gold) * mask
    denom = mask.sum().clamp_min(1.0)
    loss = nll.sum() / denom
    metrics = {"nll": loss, "tokens": mask.sum()}
    if loss_cfg.z_loss > 0.0:
        zl = loss_cfg.z_loss * (lse.square() * mask).sum() / denom
        loss = loss + zl
        metrics["z_loss"] = zl
    return loss, metrics


def _vocab_parallel_lse_gold(logits: torch.Tensor, labels: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(logsumexp, gold logit) of DTensor logits [b, s, V] whose vocab may
    be sharded: the max and the sum of exponentials reduce across the
    vocab shards, and each rank gathers the gold logits that fall in its
    own vocab slice (zero elsewhere), summed across them (Megatron's
    vocab-parallel cross entropy; a gather along a sharded dimension would
    gather the whole logits first)."""
    from ..launch.compat import DTensor, Partial, Replicate

    logits = reduce_partial(logits)
    m = logits.detach().amax(dim=-1, keepdim=True)
    lse = ((logits - m).exp().sum(dim=-1)).log() + m[..., 0]
    mesh, vdim = logits.device_mesh, logits.ndim - 1
    vocab_dims = [i for i, p in enumerate(logits.placements) if p.is_shard(vdim)]
    label_pl = tuple(Replicate() if i in vocab_dims else p for i, p in enumerate(logits.placements))
    gold_pl = tuple(Partial() if i in vocab_dims else p for i, p in enumerate(logits.placements))
    if not is_dtensor(labels):
        labels = DTensor.from_local(labels, mesh, [Replicate()] * mesh.ndim, run_check=False)
    labels = labels.redistribute(mesh, label_pl).to_local()
    local = logits.to_local()
    width, coord, shard = local.shape[-1], mesh.get_coordinate(), 0
    for i in vocab_dims:  # this rank's vocab slice, split major to minor
        shard = shard * mesh.size(i) + coord[i]
    idx = labels - shard * width
    inside = (idx >= 0) & (idx < width)
    gold = torch.gather(local, -1, idx.clamp(0, width - 1)[..., None])[..., 0] * inside
    return lse, DTensor.from_local(gold, mesh, gold_pl, run_check=False)


def make_loss_fn(
    cfg: ModelConfig,
    opts: ForwardOptions,
    loss_cfg: LossConfig,
) -> Callable[..., Tuple[torch.Tensor, Dict[str, torch.Tensor]]]:
    def loss_fn(params: Pytree, batch: Batch):
        if cfg.is_encoder_decoder:
            logits, aux = encdec_forward(cfg, params, batch["enc_embeds"], batch["tokens"], opts=opts)
        elif "embeds" in batch:
            logits, aux = lm_forward(cfg, params, embeds=batch["embeds"], opts=opts)
        else:
            logits, aux = lm_forward(cfg, params, tokens=batch["tokens"], opts=opts)
        loss, metrics = cross_entropy(logits, batch["labels"], loss_cfg)
        total = loss + loss_cfg.aux_coef * aux
        metrics["aux"] = aux
        metrics["loss"] = total
        return total, metrics

    return loss_fn


def _grads(loss_fn, params: Pytree, batch: Batch) -> Tuple[Pytree, Dict[str, torch.Tensor]]:
    """(grads in the params' dtypes, detached metrics) of one batch."""
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    try:
        loss, metrics = loss_fn(params, batch)
        loss = reduce_partial(loss)
        grads = iter(torch.autograd.grad(loss, leaves, allow_unused=True, materialize_grads=True))
    finally:
        for p in leaves:
            p.requires_grad_(False)
    return tree_map(lambda _: next(grads), params), {k: v.detach() for k, v in metrics.items()}


def _f32_zeros_like(p: torch.Tensor) -> torch.Tensor:
    """f32 zeros shaped (and, for a DTensor, laid out) as ``p``."""
    if is_dtensor(p):
        return torch.zeros_like(p, dtype=torch.float32)
    return torch.zeros(p.shape, dtype=torch.float32, device=p.device)


def _micro(v: torch.Tensor, i: int, n: int) -> torch.Tensor:
    """Microbatch ``i`` of ``n`` of a batch leaf [global_b, ...]: rows
    [i * mb, (i + 1) * mb), the reference's reshape to [n_micro, mb, ...].
    A DTensor whose batch is sharded splits each rank's own rows instead
    (as a data-parallel trainer does): the microbatches hold other rows,
    and the accumulated mean over equal microbatches is the same."""
    if not is_dtensor(v):
        mb = v.shape[0] // n
        return v[i * mb: (i + 1) * mb]
    from ..launch.compat import DTensor

    local = v.to_local()
    mb = local.shape[0] // n
    return DTensor.from_local(local[i * mb: (i + 1) * mb], v.device_mesh, v.placements, run_check=False)


def make_train_step(
    cfg: ModelConfig,
    optimizer: AdamW,
    opts: ForwardOptions = ForwardOptions(),
    loss_cfg: LossConfig = LossConfig(),
    num_microbatches: int = 1,
) -> Callable[[TrainState, Batch], Tuple[TrainState, Dict[str, torch.Tensor]]]:
    """Build the train step (see the module docstring)."""
    loss_fn = make_loss_fn(cfg, opts, loss_cfg)

    def accumulated_grads(params, batch):
        acc = tree_map(_f32_zeros_like, params)
        metrics = None
        for i in range(num_microbatches):
            grads, m = _grads(loss_fn, params, {k: _micro(v, i, num_microbatches) for k, v in batch.items()})
            tree_map(lambda a, g: a.add_(g.float()), acc, grads)
            metrics = m if metrics is None else {k: metrics[k] + m[k] for k in metrics}
        inv = 1.0 / num_microbatches
        grads = tree_map(lambda a: a.mul_(inv), acc)
        metrics = {k: v * inv for k, v in metrics.items()}
        metrics["tokens"] = metrics["tokens"] / inv  # tokens should sum
        return grads, metrics

    def train_step(state: TrainState, batch: Batch):
        device = tree_leaves(state.params)[0].device
        batch = {k: v if is_dtensor(v) else torch.as_tensor(v, device=device) for k, v in batch.items()}
        if num_microbatches > 1:
            grads, metrics = accumulated_grads(state.params, batch)
        else:
            grads, metrics = _grads(loss_fn, state.params, batch)
        params, opt_state, opt_metrics = optimizer.update(
            grads, state.opt, cfg.param_dtype, params=state.params
        )
        metrics.update(opt_metrics)
        return TrainState(params=params, opt=opt_state), metrics

    return train_step


def init_train_state(
    cfg: ModelConfig, optimizer: AdamW, params: Pytree
) -> TrainState:
    return TrainState(params=params, opt=optimizer.init(params))


def train_state_from_numpy(state: Any, device: DeviceLike = "cuda") -> TrainState:
    """The port's train state from the reference's as numpy arrays
    (``jax.tree.map(np.asarray, ref_state)``): the params and the optimizer's
    f32 trees on ``device`` with their own dtypes (bfloat16 bits carried, as
    :func:`params_from_numpy` does), the step counter on the host. The
    optimizer state's kind is read from its fields."""
    opt = state.opt
    cls = next(c for c in (AdamWState, AdafactorState) if tuple(opt._fields) == c._fields)
    trees = {f: params_from_numpy(getattr(opt, f), device) for f in cls._fields if f != "step"}
    return TrainState(
        params=params_from_numpy(state.params, device),
        opt=cls(step=torch.tensor(int(opt.step), dtype=torch.int32), **trees),
    )

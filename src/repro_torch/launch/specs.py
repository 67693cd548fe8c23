"""Per-cell plans: (architecture x input-shape x mesh) -> a step with fully
specified input shardings and shape-only arguments (the reference's
``launch/specs.py`` on ``DeviceMesh`` and DTensor).

The reference traces its step with ``jax.ShapeDtypeStruct`` arguments and
compiles it ahead of time; the port's counterparts are:

* ``eval_shape`` -> initialisation on the ``meta`` device: every argument
  of a :class:`CellPlan` is a tree of ``meta`` tensors (shapes and dtypes,
  no storage);
* ``lower().compile()`` -> :meth:`CellPlan.build`: this rank's local shard
  of every argument, drawn at its local shape on a device and wrapped as a
  DTensor (``DTensor.from_local``, no communication), and the step that
  runs on them. A full tensor is never made: command-r-plus-104b's bf16
  weights alone are about 208 GB.

``build_cell`` returns the :class:`CellPlan` for ``train_step`` /
``prefill`` / ``serve_step`` as the shape's kind dictates. The serving
cells run the in-place steps (the reference donates the decode state).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from ..configs.shapes import ShapeSpec
from ..distributed.sharding import (
    NamedSharding,
    Spec,
    batch_spec,
    dp_axes,
    dp_size,
    from_local,
    local_shape,
    make_plan,
    state_specs,
    tp_size,
    tree_shardings,
)
from ..models import (
    ForwardOptions,
    ModelConfig,
    init_encdec_params,
    init_encdec_state,
    init_lm_params,
    init_lm_state,
    lm_decode_inplace,
    lm_prefill_inplace,
)
from ..models.layers import compute_dtype
from ..serve.engine import make_prefill, make_serve_step
from ..train.optimizer import AdamW, cosine_schedule
from ..train.trainer import LossConfig, TrainState, init_train_state, make_train_step

Pytree = Any

#: Activation budget for remat-saved unit inputs per device; drives the
#: microbatch count heuristic.
SAVED_ACT_BUDGET_BYTES = 2 << 30


def param_shapes(cfg: ModelConfig) -> Tuple[Pytree, Pytree]:
    """(shape tree of ``meta`` tensors, logical-axes tree) with ZERO
    allocation."""
    init = init_encdec_params if cfg.is_encoder_decoder else init_lm_params
    return init(cfg, device="meta")


def pick_microbatches(cfg: ModelConfig, shape: ShapeSpec, mesh: Any, seq_sharded: bool) -> int:
    """Smallest divisor of the per-DP-group batch whose remat-saved
    activations fit the per-device budget."""
    dpn = dp_size(mesh)
    b_local = max(shape.global_batch // dpn, 1)
    tp = tp_size(mesh) if seq_sharded else 1
    per_seq = shape.seq_len * cfg.d_model * 2  # bf16 residual stream
    for n_micro in [d for d in range(1, b_local + 1) if b_local % d == 0]:
        saved = cfg.n_units * (b_local // n_micro) * per_seq / tp
        if saved <= SAVED_ACT_BUDGET_BYTES:
            return n_micro
    return b_local


def _is_tensor(x: Any) -> bool:
    return isinstance(x, torch.Tensor)


def _map2(fn: Callable, tree: Any, shardings: Any) -> Any:
    """``fn(leaf, sharding)`` over a tree of dicts / NamedTuples whose
    shardings tree matches it (a None sharding passes its leaf through)."""
    if isinstance(tree, dict):
        return {k: _map2(fn, v, shardings[k]) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_map2(fn, v, s) for v, s in zip(tree, shardings)))
    return fn(tree, shardings)


@dataclasses.dataclass
class CellPlan:
    arch: str
    shape: ShapeSpec
    mesh: Any
    cfg: ModelConfig
    kind: str                      # train | prefill | decode
    fn: Callable                   # step function over the args
    args: Tuple[Pytree, ...]       # ``meta`` tensor trees (and host scalars)
    in_shardings: Tuple[Pytree, ...]
    num_microbatches: int = 1
    attention_strategy: str = ""
    notes: Tuple[str, ...] = ()

    def build(self, device: Any, seed: int = 0) -> Tuple[Callable, Tuple[Pytree, ...]]:
        """(step, args): this rank's shard of every argument, drawn at its
        local shape on ``device`` (floating leaves N(0, 0.02²) in their
        dtype, integer leaves uniform token ids) and wrapped as DTensors of
        the global shapes. ``step(*args)`` runs the cell once (call it under
        :func:`repro_torch.launch.compat.implicit_replication`, as
        :mod:`.dryrun` does)."""
        gen = torch.Generator(device=device).manual_seed(seed)
        vocab = self.cfg.vocab_size

        def leaf(x, sharding):
            if not _is_tensor(x) or x.device.type != "meta" or sharding is None:
                return x
            shp = local_shape(sharding, x.shape)
            if x.dtype.is_floating_point:
                local = torch.empty(shp, dtype=torch.float32, device=device).normal_(0.0, 0.02, generator=gen)
                local = local.to(x.dtype)
            else:
                local = torch.randint(0, vocab, shp, generator=gen, device=device, dtype=x.dtype)
            return from_local(local, sharding, x.shape)

        args = tuple(_map2(leaf, a, s) for a, s in zip(self.args, self.in_shardings))
        return self.fn, args


def build_cell(
    arch: str,
    cfg: ModelConfig,
    shape: ShapeSpec,
    mesh: Any,
    opts_override: Optional[Dict[str, Any]] = None,
) -> CellPlan:
    if shape.kind == "train":
        return _build_train_cell(arch, cfg, shape, mesh, opts_override or {})
    if shape.kind == "prefill":
        return _build_prefill_cell(arch, cfg, shape, mesh, opts_override or {})
    return _build_decode_cell(arch, cfg, shape, mesh, opts_override or {})


# ------------------------------------------------------------------ train --

def _sharding_opts(cfg, shape, mesh, plan, overrides, training: bool):
    """Boundary/interior/attention sharding choices."""
    notes = []
    tp = tp_size(mesh)
    dpa = dp_axes(mesh)
    dpn = dp_size(mesh)
    b, s = shape.global_batch, shape.seq_len

    b_rule = dpa if (dpa and b % dpn == 0) else None
    # Megatron-SP: carry seq-sharded over model => remat-saved activations
    # divide by tp. The interior re-gathers.
    boundary = interior = None
    if training and overrides.get("sp_boundary", True) and s % tp == 0:
        boundary = NamedSharding(mesh, Spec(b_rule, ("model",), None))
        interior = NamedSharding(mesh, Spec(b_rule, None, None))
        notes.append("SP: carry seq-sharded over model; interior gathered")

    # Attention core for archs whose heads don't divide tp: sequence-shard
    # the QUERIES over 'model' (scores [b, H, sq/tp, skv]) with K/V
    # replicated — head-count-agnostic, no batch reshard, exact FLOPs split.
    attn_q = attn_kv = None
    attn_q_block = 0
    gqa_mode = "broadcast" if plan.attention == "head_q" else "grouped"
    if plan.attention == "sequence" and s % tp == 0:
        attn_q = NamedSharding(mesh, Spec(b_rule, ("model",), None, None))
        attn_kv = NamedSharding(mesh, Spec(b_rule, None, None, None))
        notes.append("attention q seq-sharded over model, K/V replicated")
        if not training:
            # prefill at 32k: kv-only chunking keeps peak scores bounded
            # without q-dim slicing over the sharded axis.
            attn_q_block = -1
    elif plan.attention in ("head", "head_q"):
        # Pin the attention-core layout to head-sharded (the constraint
        # applies after the broadcast repeat, so K/V carry H heads in
        # head_q mode too).
        head_spec = NamedSharding(mesh, Spec(b_rule, None, ("model",), None))
        attn_q = head_spec
        attn_kv = head_spec if gqa_mode == "broadcast" else (
            head_spec if cfg.n_kv_heads % tp == 0 else None
        )
        notes.append("attention core pinned head-sharded")
    return boundary, interior, attn_q, attn_kv, attn_q_block, gqa_mode, notes


def _moe_compute_shardings(cfg, mesh, plan):
    """Compute-time expert-weight pin: refuted in the reference's §Perf
    iterations (replicating the ZeRO 'data' shard of d_model at use forced
    fully replicated expert compute). Mechanism retained; None by default."""
    return None


def _build_train_cell(arch, cfg, shape, mesh, overrides) -> CellPlan:
    plan = make_plan(cfg, mesh, mode="train")
    boundary, interior, attn_q, attn_kv, attn_q_block, gqa_mode, notes = _sharding_opts(
        cfg, shape, mesh, plan, overrides, training=True
    )

    b_local = max(shape.global_batch // dp_size(mesh), 1)
    n_micro = overrides.get(
        "num_microbatches",
        pick_microbatches(cfg, shape, mesh, boundary is not None),
    )
    n_micro = min(n_micro, b_local)  # cannot split below 1 seq/microbatch
    # 'reference' attention up to 8k (scores of a head-sharded layer are
    # transient), chunked beyond.
    default_attn = "reference" if shape.seq_len <= 8192 else "chunked"
    opts = ForwardOptions(
        attn_impl=overrides.get("attn_impl", default_attn),
        moe_dispatch=overrides.get("moe_dispatch", "gather"),
        mamba_impl="chunked",
        remat=overrides.get("remat", "full"),
        gqa_mode=overrides.get("gqa_mode", gqa_mode),
        boundary_sharding=boundary,
        interior_sharding=interior,
        attn_q_sharding=attn_q,
        attn_kv_sharding=attn_kv,
        attn_q_block=overrides.get("attn_q_block", attn_q_block),
        moe_compute_shardings=_moe_compute_shardings(cfg, mesh, plan),
    )

    # ---- shapes (zero allocation) ----
    params_s, axes = param_shapes(cfg)
    optimizer = AdamW(schedule=cosine_schedule(3e-4, 2000, 100_000))
    state_s = init_train_state(cfg, optimizer, params_s)

    param_sh = tree_shardings(plan, axes, params_s)
    # optimizer state shares the param shardings leaf-for-leaf; the step
    # counter is a host scalar.
    opt_sh = type(state_s.opt)(step=None, master=param_sh, mu=param_sh, nu=param_sh)
    state_sh = TrainState(params=param_sh, opt=opt_sh)

    b, s = shape.global_batch, shape.seq_len
    bspec = NamedSharding(mesh, batch_spec(mesh, b, extra_dims=1))
    embeds_sh = NamedSharding(mesh, batch_spec(mesh, b, extra_dims=2))
    meta, dt = torch.device("meta"), compute_dtype(cfg)
    batch_s: Dict[str, Any] = {}
    batch_sh: Dict[str, Any] = {}
    if cfg.is_encoder_decoder:
        batch_s["enc_embeds"] = torch.empty((b, cfg.encoder_seq, cfg.d_model), dtype=dt, device=meta)
        batch_sh["enc_embeds"] = embeds_sh
        batch_s["tokens"] = torch.empty((b, s), dtype=torch.int64, device=meta)
        batch_sh["tokens"] = bspec
    elif cfg.frontend == "vision_stub":
        batch_s["embeds"] = torch.empty((b, s, cfg.d_model), dtype=dt, device=meta)
        batch_sh["embeds"] = embeds_sh
        notes.append("vlm: precomputed patch+token embeddings enter as 'embeds'")
    else:
        batch_s["tokens"] = torch.empty((b, s), dtype=torch.int64, device=meta)
        batch_sh["tokens"] = bspec
    batch_s["labels"] = torch.empty((b, s), dtype=torch.int64, device=meta)
    batch_sh["labels"] = bspec

    step = make_train_step(cfg, optimizer, opts, LossConfig(), num_microbatches=n_micro)
    return CellPlan(
        arch=arch, shape=shape, mesh=mesh, cfg=cfg, kind="train",
        fn=step,
        args=(state_s, batch_s),
        in_shardings=(state_sh, batch_sh),
        num_microbatches=n_micro,
        attention_strategy=plan.attention,
        notes=tuple(notes + plan.fallbacks),
    )


# ---------------------------------------------------------------- prefill --

def _build_prefill_cell(arch, cfg, shape, mesh, overrides) -> CellPlan:
    plan = make_plan(cfg, mesh, mode="prefill")
    b, s = shape.global_batch, shape.seq_len
    _, _, attn_q, attn_kv, attn_q_block, gqa_mode, notes = _sharding_opts(
        cfg, shape, mesh, plan, overrides, training=False
    )

    opts = ForwardOptions(
        attn_impl=overrides.get("attn_impl", "chunked"),
        moe_dispatch=overrides.get("moe_dispatch", "gather"),
        mamba_impl="chunked",
        gqa_mode=overrides.get("gqa_mode", gqa_mode),
        attn_q_sharding=attn_q,
        attn_kv_sharding=attn_kv,
        attn_q_block=overrides.get("attn_q_block", attn_q_block),
        moe_compute_shardings=_moe_compute_shardings(cfg, mesh, plan),
    )
    meta, dt = torch.device("meta"), compute_dtype(cfg)
    params_s, axes = param_shapes(cfg)
    param_sh = tree_shardings(plan, axes, params_s)
    embeds_sh = NamedSharding(mesh, batch_spec(mesh, b, extra_dims=2))

    if cfg.is_encoder_decoder:
        state_s = init_encdec_state(cfg, b, s, cfg.encoder_seq, device=meta)
        fn = make_prefill(cfg, opts)
        enc_s = torch.empty((b, cfg.encoder_seq, cfg.d_model), dtype=dt, device=meta)
        args = (params_s, state_s, enc_s)
        in_sh = (param_sh, state_specs(cfg, plan, state_s, b), embeds_sh)
    else:
        state_s = init_lm_state(cfg, b, s, device=meta)
        st_sh = state_specs(cfg, plan, state_s, b)
        if cfg.frontend == "vision_stub":
            in_s = torch.empty((b, s, cfg.d_model), dtype=dt, device=meta)
            in_batch_sh = embeds_sh
            fn = functools.partial(_prefill_embeds, cfg, opts)
            notes.append("vlm prefill via precomputed embeds")
        else:
            in_s = torch.empty((b, s), dtype=torch.int64, device=meta)
            in_batch_sh = NamedSharding(mesh, batch_spec(mesh, b, extra_dims=1))
            fn = functools.partial(_prefill_tokens, cfg, opts)
        args = (params_s, state_s, in_s)
        in_sh = (param_sh, st_sh, in_batch_sh)

    return CellPlan(
        arch=arch, shape=shape, mesh=mesh, cfg=cfg, kind="prefill",
        fn=fn, args=args, in_shardings=in_sh,
        attention_strategy=plan.attention,
        notes=tuple(notes + plan.fallbacks),
    )


def _prefill_tokens(cfg, opts, params, state, tokens):
    return lm_prefill_inplace(cfg, params, state, tokens=tokens, opts=opts)


def _prefill_embeds(cfg, opts, params, state, embeds):
    return lm_prefill_inplace(cfg, params, state, embeds=embeds, opts=opts)


# ----------------------------------------------------------------- decode --

def _decode_inplace(cfg, opts, params, state, tokens, cache_len: int):
    position = torch.tensor(cache_len, dtype=torch.int64, device=tokens.device)
    return lm_decode_inplace(cfg, params, state, tokens, position, opts=opts)


def _build_decode_cell(arch, cfg, shape, mesh, overrides) -> CellPlan:
    plan = make_plan(cfg, mesh, mode="decode")
    b, s = shape.global_batch, shape.seq_len

    opts = ForwardOptions(
        moe_dispatch=overrides.get("moe_dispatch", "gather"),
        moe_compute_shardings=_moe_compute_shardings(cfg, mesh, plan),
    )
    meta = torch.device("meta")
    params_s, axes = param_shapes(cfg)
    if cfg.is_encoder_decoder:
        state_s = init_encdec_state(cfg, b, s, cfg.encoder_seq, device=meta)
        fn = make_serve_step(cfg, opts)
    else:
        state_s = init_lm_state(cfg, b, s, device=meta)
        fn = functools.partial(_decode_inplace, cfg, opts)

    param_sh = tree_shardings(plan, axes, params_s)
    st_sh = state_specs(cfg, plan, state_s, b)
    tok_s = torch.empty((b, 1), dtype=torch.int64, device=meta)
    tok_sh = NamedSharding(mesh, batch_spec(mesh, b, extra_dims=1))
    return CellPlan(
        arch=arch, shape=shape, mesh=mesh, cfg=cfg, kind="decode",
        fn=fn,
        args=(params_s, state_s, tok_s, s - 1),  # the last cache slot
        in_shardings=(param_sh, st_sh, tok_sh, None),
        attention_strategy=plan.attention,
        notes=tuple(plan.fallbacks),
    )

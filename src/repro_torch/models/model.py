"""Model assembly: decoder LMs (dense/MoE/hybrid/SSM) and encoder-decoder
(the reference's ``models/model.py``).

The layer stack loops over *stacked unit parameters* (leading axis
``n_units``, logical axis ``layers``), the reference's ``lax.scan`` made a
Python loop; the parameter trees and the decode state are laid out as the
reference's, so weights and states carry across as tree maps.

Public entry points (pure functions over parameter trees):

* ``init_lm_params`` / ``lm_forward``        — scoring forward
* ``init_lm_state`` / ``lm_prefill`` / ``lm_decode_step`` — serving (the
  reference's functional form, over ``lm_prefill_inplace`` /
  ``lm_decode_inplace``, which write the stacked state in place);
  ``lm_extend_inplace`` — new tokens against a filled cache (latent
  attention only: the port's own, as is what follows)
* ``init_encdec_params`` / ``encdec_forward`` / ``encdec_prefill`` /
  ``encdec_decode_step``                      — whisper-style enc-dec

A config with ``first_k_dense_replace`` leading dense layers (DeepSeek-V2)
runs them before the units: their stacked parameters are ``params["lead"]``
and their stacked decode state ``state["lead"]``, each an attention
sublayer and a dense MLP of width ``d_ff``. Every other config has
neither key, and its trees are the reference's.

Activation checkpointing (``ForwardOptions.remat``) wraps the unit body, as
the reference's ``jax.checkpoint`` does: ``full`` saves nothing inside a
unit, ``dots`` saves the outputs of its matrix products (``mm``, ``addmm``,
``bmm``) and ``dots_no_batch`` those without a batch dimension (``mm``,
``addmm``). The sharding options are the reference's sharding constraints
on DTensors (:func:`.layers.constrain`, the counterpart of
``with_sharding_constraint``): with every one ``None`` nothing is
redistributed and a plain-tensor forward is what it was without them.
"""

from __future__ import annotations

import functools
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Tuple, Union

import torch
from torch.utils.checkpoint import CheckpointPolicy, checkpoint, create_selective_checkpoint_contexts

from ..device import DeviceLike, resolve_device
from .attention import (
    attention_reference,
    decode_attention,
    init_attention,
    init_kv_cache,
    project_out,
    project_qkv,
    update_kv_cache,
)
from .blocks import apply_sublayer, init_sublayer, init_sublayer_state, init_unit, init_unit_state
from .config import FFNKind, LayerKind, ModelConfig, SublayerSpec
from .layers import (
    Params,
    apply_mlp,
    apply_norm,
    compute_dtype,
    constrain,
    embed_tokens,
    gather_dp,
    init_embedding,
    init_mlp,
    init_norm,
    init_unembed,
    normal_init,
    param_dtype,
    split_params,
    tree_map,
    unembed,
)

# remat policy -> the ops whose outputs a unit's checkpoint saves (None: none)
_SAVED_OPS = {
    "full": None,
    "dots": {torch.ops.aten.mm.default, torch.ops.aten.addmm.default, torch.ops.aten.bmm.default},
    "dots_no_batch": {torch.ops.aten.mm.default, torch.ops.aten.addmm.default},
}
REMAT_POLICIES = ("none", *_SAVED_OPS)


class ForwardOptions(NamedTuple):
    attn_impl: str = "auto"         # auto | reference | chunked
    moe_dispatch: str = "gather"    # gather | dense
    mamba_impl: str = "chunked"     # chunked | reference
    remat: str = "none"             # none | full | dots | dots_no_batch
    # GQA contraction order: "grouped" keeps K/V at kv-head granularity;
    # "broadcast" repeats K/V to H query heads (equal FLOPs, more traffic).
    gqa_mode: str = "grouped"
    # Megatron-SP: the unit-loop carry (residual stream at unit boundaries)
    # is sequence-sharded over 'model' so remat-saved activations divide by
    # tp; the unit interior re-gathers. Each sharding is a
    # ``distributed.NamedSharding`` (anything with ``mesh`` and
    # ``placements``); None = let DTensor propagate.
    boundary_sharding: Optional[Any] = None   # e.g. [b(dp), s(model), d]
    interior_sharding: Optional[Any] = None   # e.g. [b(dp), s, d]
    # Attention-core resharding for archs whose heads don't divide tp:
    # sequence-shard the QUERIES over 'model' with K/V replicated.
    attn_q_sharding: Optional[Any] = None     # [b, s, heads, hd] for q + out
    attn_kv_sharding: Optional[Any] = None    # [b, s, kv_heads, hd] for k/v
    # kv-only chunking (q unchunked): q_block == -1
    attn_q_block: int = 0                     # 0 = impl default
    # Compute-time expert-weight shardings: dict {wi, wg, wo} -> sharding.
    moe_compute_shardings: Optional[Any] = None
    # latent attention's algorithm: auto (by analytic FLOPs) | absorb |
    # absorb_chunked | decompress | decompress_chunked
    mla_impl: str = "auto"

    def check(self) -> "ForwardOptions":
        """``self``, or ValueError for an unknown remat policy."""
        if self.remat not in REMAT_POLICIES:
            raise ValueError(f"unknown remat policy {self.remat!r}")
        return self


# ------------------------------------------------------------------ init ---

def _stack(trees: List[Params]) -> Params:
    """Stack a list of equal trees leaf by leaf along a new leading axis,
    emptying the input trees as it goes (each leaf's parts are freed once
    stacked)."""
    out = {}
    for key in list(trees[0]):
        parts = [t.pop(key) for t in trees]
        out[key] = _stack(parts) if isinstance(parts[0], dict) else torch.stack(parts)
    return out


def _stacked_init(n: int, init_one) -> Tuple[Params, Any]:
    """(values, axes) of ``n`` stacked layers, each made by ``init_one()``
    (a tree of :class:`P`) and copied into preallocated stacked leaves, so
    the peak is the stack plus one layer."""
    values0, axes0 = split_params(init_one())
    values = tree_map(lambda v: v.new_empty((n,) + tuple(v.shape)), values0)

    def copy_in(dst, src, i):
        for k, v in src.items():
            if isinstance(v, dict):
                copy_in(dst[k], v, i)
            else:
                dst[k][i].copy_(v)

    copy_in(values, values0, 0)
    del values0
    for i in range(1, n):
        copy_in(values, split_params(init_one())[0], i)
    axes = tree_map(lambda a: ("layers",) + tuple(a), axes0)
    return values, axes


class _ShapesOnly:
    """Stands in for a generator on the ``meta`` device, which has none:
    initialisation then gives every leaf's shape and dtype and draws
    nothing (a checkpoint's restore target that costs no memory)."""

    device = torch.device("meta")


def _generator(seed: int, device: DeviceLike) -> torch.Generator:
    dev = resolve_device(device)
    if dev.type == "meta":
        return _ShapesOnly()
    return torch.Generator(device=dev).manual_seed(seed)


def init_lm_params(cfg: ModelConfig, seed: int = 0, device: DeviceLike = "cuda") -> Tuple[Params, Any]:
    """(values, axes): embedding + stacked units + final norm (+ lm head),
    drawn on ``device`` from a ``torch.Generator`` seeded with ``seed``.

    Stacked unit leaves get a leading ``layers`` logical axis.
    """
    cfg.validate()
    gen = _generator(seed, device)
    embed_v, embed_a = split_params(init_embedding(cfg, gen))
    values: Params = {"embed": embed_v}
    axes: Params = {"embed": embed_a}
    if cfg.first_k_dense_replace:
        values["lead"], axes["lead"] = _stacked_init(
            cfg.first_k_dense_replace, lambda: init_sublayer(cfg, gen, LEAD_SPEC))
    values["units"], axes["units"] = _stacked_init(cfg.n_units, lambda: init_unit(cfg, gen))
    values["final_norm"], axes["final_norm"] = split_params(init_norm(cfg, cfg.d_model, gen.device))

    head_p = init_unembed(cfg, gen)
    if head_p is not None:
        values["lm_head"], axes["lm_head"] = split_params(head_p)
    return values, axes


LEAD_SPEC = SublayerSpec(kind=LayerKind.ATTN, ffn=FFNKind.DENSE)


def _lead(cfg: ModelConfig, params: Params, state: Optional[Dict[str, Any]] = None):
    """(params, state or None) of each leading dense layer, in order."""
    n = cfg.first_k_dense_replace
    if not n:
        return []
    states = _unstack(state["lead"], n) if state is not None else [None] * n
    return list(zip(_unstack(params["lead"], n), states))


def _unit_state(state: Dict[str, Any]) -> Dict[str, Any]:
    """The stacked units' part of a decode state."""
    return {k: v for k, v in state.items() if k != "lead"}


def _unstack(tree: Params, n: int) -> List[Params]:
    """A tree of stacked leaves as ``n`` per-layer trees, each leaf unbound
    once. (Indexing every layer with ``t[i]`` would make autograd write one
    zero-filled gradient the size of the whole stack per layer.)"""
    if isinstance(tree, dict):
        parts = {k: _unstack(v, n) for k, v in tree.items()}
        return [{k: p[i] for k, p in parts.items()} for i in range(n)]
    return tree.unbind(0)


def _remat(fn: Callable, policy: str) -> Callable:
    """``fn`` under ``torch.utils.checkpoint`` with the remat policy's saved
    ops (``fn`` itself for ``"none"``)."""
    if policy == "none":
        return fn
    saved, kwargs = _SAVED_OPS[policy], {}
    if saved is not None:
        def policy_fn(ctx, op, *args, **kwargs):
            return CheckpointPolicy.MUST_SAVE if op in saved else CheckpointPolicy.PREFER_RECOMPUTE

        kwargs["context_fn"] = functools.partial(create_selective_checkpoint_contexts, policy_fn)
    return lambda *args: checkpoint(fn, *args, use_reentrant=False, **kwargs)


# -------------------------------------------------------------- forward ---

def _inputs(cfg: ModelConfig, params: Params, tokens, embeds) -> torch.Tensor:
    if embeds is None:
        if tokens is None:
            raise ValueError("pass tokens or embeds")
        return embed_tokens(cfg, params["embed"], tokens)
    return embeds.to(compute_dtype(cfg))


def lm_forward(
    cfg: ModelConfig,
    params: Params,
    tokens: Optional[torch.Tensor] = None,      # [b, s] int
    embeds: Optional[torch.Tensor] = None,      # [b, s, d] (VLM/audio stubs)
    opts: ForwardOptions = ForwardOptions(),
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence forward. Returns (logits [b, s, vocab] f32, moe_aux)."""
    opts.check()
    unit = cfg.pattern_unit()
    x = _inputs(cfg, params, tokens, embeds)
    positions = torch.arange(x.shape[1], device=x.device)

    def unit_body(x, unit_params):
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        # pin the checkpoint-saved input's sharding before the interior gather
        x = constrain(x, opts.boundary_sharding)
        x = constrain(x, opts.interior_sharding)
        for i, spec in enumerate(unit):
            x, _, a = apply_sublayer(cfg, unit_params[f"sub{i}"], spec, x, mode="train",
                                     positions=positions, opts=opts)
            aux = aux + a
        return constrain(x, opts.boundary_sharding), aux

    def lead_body(x, lead_params):
        x, _, a = apply_sublayer(cfg, lead_params, LEAD_SPEC, x, mode="train", positions=positions,
                                 opts=opts)
        return x, a

    body = _remat(unit_body, opts.remat)
    x = constrain(x, opts.boundary_sharding)
    auxes = []
    for lead_params, _ in _lead(cfg, params):
        x, a = _remat(lead_body, opts.remat)(x, lead_params)
        auxes.append(a)
    for unit_params in _unstack(params["units"], cfg.n_units):
        x, a = body(x, unit_params)
        auxes.append(a)
    aux = torch.stack(auxes).sum()
    # the head takes the carry gathered: a sequence still split over the
    # mesh axis that splits the vocabulary sends DTensor's layout search
    # through every combination of the two (minutes on a three-axis mesh)
    x = constrain(x, opts.interior_sharding)
    x = apply_norm(cfg, params["final_norm"], x)
    logits = unembed(cfg, params["embed"], params.get("lm_head"), x)
    return logits, aux


# --------------------------------------------------------------- serving ---

def init_lm_state(cfg: ModelConfig, batch: int, max_len: int, device: DeviceLike = "cuda") -> Dict[str, Any]:
    """Stacked decode state: one unit state repeated to n_units, each unit's
    its own memory (the reference's ``broadcast_to`` is a value; an
    ``expand`` here would alias every unit's cache to one buffer)."""
    unit_state = init_unit_state(cfg, batch, max_len, compute_dtype(cfg), device)
    state = tree_map(lambda x: x.unsqueeze(0).repeat((cfg.n_units,) + (1,) * x.ndim), unit_state)
    if cfg.first_k_dense_replace:
        lead = init_sublayer_state(cfg, LEAD_SPEC, batch, max_len, compute_dtype(cfg), device)
        state["lead"] = tree_map(
            lambda x: x.unsqueeze(0).repeat((cfg.first_k_dense_replace,) + (1,) * x.ndim), lead)
    return state


def lm_prefill_inplace(
    cfg: ModelConfig,
    params: Params,
    state: Dict[str, Any],
    tokens: Optional[torch.Tensor] = None,
    embeds: Optional[torch.Tensor] = None,
    opts: ForwardOptions = ForwardOptions(),
) -> torch.Tensor:
    """Populate the cache from a prompt (cache_len 0 at entry), writing
    into ``state`` in place through per-layer views of its stacked leaves.
    Returns the last token's logits [b, vocab] f32."""
    opts.check()
    unit = cfg.pattern_unit()
    x = _inputs(cfg, params, tokens, embeds)
    positions = torch.arange(x.shape[1], device=x.device)
    for lead_params, lead_state in _lead(cfg, params, state):
        x, _, _ = apply_sublayer(cfg, lead_params, LEAD_SPEC, x, mode="prefill", positions=positions,
                                 state=lead_state, opts=opts)
    for unit_params, unit_state in zip(_unstack(params["units"], cfg.n_units),
                                       _unstack(_unit_state(state), cfg.n_units)):
        x = constrain(x, opts.interior_sharding)
        for i, spec in enumerate(unit):
            x, _, _ = apply_sublayer(cfg, unit_params[f"sub{i}"], spec, x, mode="prefill",
                                     positions=positions, state=unit_state[f"sub{i}"], opts=opts)
        x = constrain(x, opts.boundary_sharding)
    x = apply_norm(cfg, params["final_norm"], x)
    logits = unembed(cfg, params["embed"], params.get("lm_head"), x[:, -1:, :])
    return logits[:, 0, :]


def lm_decode_inplace(
    cfg: ModelConfig,
    params: Params,
    state: Dict[str, Any],
    tokens: torch.Tensor,       # [b, 1] int — the newest token
    position: torch.Tensor,     # 0-d int64 on the device: tokens already in cache
    opts: ForwardOptions = ForwardOptions(),
) -> torch.Tensor:
    """One serving step, writing into ``state`` in place; returns the logits
    [b, vocab] f32. Nothing is read back to the host (the position stays on
    the device), so the step can be captured as one CUDA graph."""
    opts.check()
    return _step(cfg, params, state, tokens, position, "decode", opts)[:, 0, :]


def lm_extend_inplace(
    cfg: ModelConfig,
    params: Params,
    state: Dict[str, Any],
    tokens: torch.Tensor,       # [b, s] int — the new tokens
    cache_len: int,             # tokens already in the cache
    opts: ForwardOptions = ForwardOptions(),
) -> torch.Tensor:
    """Extend a filled cache by ``s`` tokens at once (a re-asked document's
    new question), writing into ``state`` in place; returns every new
    token's logits [b, s, vocab] f32. Latent attention only."""
    opts.check()
    return _step(cfg, params, state, tokens, int(cache_len), "extend", opts)


def _step(cfg, params, state, tokens, cache_len, mode, opts) -> torch.Tensor:
    """Decode or extend: the new tokens through every layer against the
    state, written in place; their logits [b, s, vocab] f32."""
    unit = cfg.pattern_unit()
    x = embed_tokens(cfg, params["embed"], tokens)
    for lead_params, lead_state in _lead(cfg, params, state):
        x, _, _ = apply_sublayer(cfg, lead_params, LEAD_SPEC, x, mode=mode, state=lead_state,
                                 cache_len=cache_len, opts=opts)
    for unit_params, unit_state in zip(_unstack(params["units"], cfg.n_units),
                                       _unstack(_unit_state(state), cfg.n_units)):
        for i, spec in enumerate(unit):
            x, _, _ = apply_sublayer(cfg, unit_params[f"sub{i}"], spec, x, mode=mode,
                                     state=unit_state[f"sub{i}"], cache_len=cache_len, opts=opts)
    x = apply_norm(cfg, params["final_norm"], x)
    return unembed(cfg, params["embed"], params.get("lm_head"), x)


def lm_prefill(
    cfg: ModelConfig,
    params: Params,
    state: Dict[str, Any],
    tokens: Optional[torch.Tensor] = None,
    embeds: Optional[torch.Tensor] = None,
    opts: ForwardOptions = ForwardOptions(),
) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """Populate the cache from a prompt (cache_len 0 at entry).

    Returns (last-token logits [b, vocab] f32, new state); ``state`` is not
    changed (:func:`lm_prefill_inplace` on a copy).
    """
    state = tree_map(torch.clone, state)
    return lm_prefill_inplace(cfg, params, state, tokens=tokens, embeds=embeds, opts=opts), state


def lm_decode_step(
    cfg: ModelConfig,
    params: Params,
    state: Dict[str, Any],
    tokens: torch.Tensor,       # [b, 1] int — the newest token
    cache_len: Union[int, torch.Tensor],  # tokens already in cache
    opts: ForwardOptions = ForwardOptions(),
) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """One serving step: returns (logits [b, vocab] f32, new state);
    ``state`` is not changed (:func:`lm_decode_inplace` on a copy)."""
    state = tree_map(torch.clone, state)
    position = torch.as_tensor(cache_len, dtype=torch.int64, device=tokens.device)
    return lm_decode_inplace(cfg, params, state, tokens, position, opts=opts), state


# ------------------------------------------------------- encoder-decoder ---

def init_encdec_params(cfg: ModelConfig, seed: int = 0, device: DeviceLike = "cuda") -> Tuple[Params, Any]:
    """Whisper-style: encoder stack (bidirectional) + decoder stack with
    cross-attention. The encoder consumes precomputed frame embeddings
    (the conv frontend is a stub)."""
    cfg.validate()
    gen = _generator(seed, device)
    dev = gen.device

    # Encoder: plain attention+MLP sublayers, bidirectional.
    enc_values, enc_axes = _stacked_init(cfg.n_encoder_layers, lambda: {
        "attn_norm": init_norm(cfg, cfg.d_model, dev),
        "attn": init_attention(cfg, gen),
        "ffn_norm": init_norm(cfg, cfg.d_model, dev),
        "mlp": init_mlp(cfg, gen),
    })
    # Decoder: self-attn + cross-attn + MLP.
    dec_values, dec_axes = _stacked_init(cfg.n_layers, lambda: {
        "self_norm": init_norm(cfg, cfg.d_model, dev),
        "self_attn": init_attention(cfg, gen),
        "cross_norm": init_norm(cfg, cfg.d_model, dev),
        "cross_attn": init_attention(cfg, gen),
        "ffn_norm": init_norm(cfg, cfg.d_model, dev),
        "mlp": init_mlp(cfg, gen),
    })
    embed_v, embed_a = split_params(init_embedding(cfg, gen))
    pos_v, pos_a = split_params(
        {"enc": normal_init(gen, (cfg.encoder_seq, cfg.d_model), (None, "embed"), param_dtype(cfg))}
    )
    enorm_v, enorm_a = split_params(init_norm(cfg, cfg.d_model, dev))
    dnorm_v, dnorm_a = split_params(init_norm(cfg, cfg.d_model, dev))

    values = {"embed": embed_v, "pos": pos_v, "encoder": enc_values, "enc_norm": enorm_v,
              "decoder": dec_values, "final_norm": dnorm_v}
    axes = {"embed": embed_a, "pos": pos_a, "encoder": enc_axes, "enc_norm": enorm_a,
            "decoder": dec_axes, "final_norm": dnorm_a}
    return values, axes


def _encode(cfg: ModelConfig, params: Params, enc_embeds: torch.Tensor,
            opts: Optional[ForwardOptions] = None) -> torch.Tensor:
    """Encoder forward on precomputed frame embeddings [b, s_enc, d]."""
    if opts is not None:
        opts.check()
    x = enc_embeds.to(compute_dtype(cfg))
    s = x.shape[1]
    x = x + gather_dp(params["pos"])["enc"][:s].to(x.dtype)[None]
    positions = torch.arange(s, device=x.device)

    def enc_step(x, layer):
        layer = gather_dp(layer)
        h = apply_norm(cfg, layer["attn_norm"], x)
        q, k, v = project_qkv(cfg, layer["attn"], h, positions)
        x = x + project_out(layer["attn"], attention_reference(q, k, v, causal=False))
        return x + apply_mlp(cfg, layer["mlp"], apply_norm(cfg, layer["ffn_norm"], x))

    step = _remat(enc_step, opts.remat if opts is not None else "none")
    for layer in _unstack(params["encoder"], cfg.n_encoder_layers):
        x = step(x, layer)
    return apply_norm(cfg, params["enc_norm"], x)


def _cross_kv(layer: Params, enc_out: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Cross-attention K/V of the encoder output (no RoPE on k)."""
    k = torch.einsum("bsd,dhk->bshk", enc_out, layer["cross_attn"]["wk"].to(enc_out.dtype))
    v = torch.einsum("bsd,dhk->bshk", enc_out, layer["cross_attn"]["wv"].to(enc_out.dtype))
    return k, v


def _cross_attend(cfg: ModelConfig, layer: Params, x: torch.Tensor, enc_out: torch.Tensor) -> torch.Tensor:
    h = apply_norm(cfg, layer["cross_norm"], x)
    # queries from decoder; keys/values from encoder output
    q = torch.einsum("bsd,dhk->bshk", h, layer["cross_attn"]["wq"].to(h.dtype))
    k, v = _cross_kv(layer, enc_out)
    return x + project_out(layer["cross_attn"], attention_reference(q, k, v, causal=False))


def encdec_forward(
    cfg: ModelConfig,
    params: Params,
    enc_embeds: torch.Tensor,       # [b, s_enc, d] precomputed frame embeddings
    dec_tokens: torch.Tensor,       # [b, s_dec]
    opts: ForwardOptions = ForwardOptions(),
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Scoring forward. Returns (logits [b, s_dec, vocab] f32, aux=0)."""
    enc_out = _encode(cfg, params, enc_embeds, opts)
    x = embed_tokens(cfg, params["embed"], dec_tokens)
    positions = torch.arange(x.shape[1], device=x.device)

    def dec_step(x, layer):
        layer = gather_dp(layer)
        h = apply_norm(cfg, layer["self_norm"], x)
        q, k, v = project_qkv(cfg, layer["self_attn"], h, positions)
        x = x + project_out(layer["self_attn"], attention_reference(q, k, v, causal=True))
        x = _cross_attend(cfg, layer, x, enc_out)
        return x + apply_mlp(cfg, layer["mlp"], apply_norm(cfg, layer["ffn_norm"], x))

    step = _remat(dec_step, opts.remat)
    for layer in _unstack(params["decoder"], cfg.n_layers):
        x = step(x, layer)
    x = apply_norm(cfg, params["final_norm"], x)
    logits = unembed(cfg, params["embed"], None, x)
    return logits, torch.zeros((), dtype=torch.float32, device=x.device)


def init_encdec_state(cfg: ModelConfig, batch: int, max_len: int, s_enc: int,
                      device: DeviceLike = "cuda") -> Dict[str, Any]:
    dev = resolve_device(device)
    dt = compute_dtype(cfg)
    hd = cfg.resolved_head_dim
    kv = init_kv_cache(batch, max_len, cfg.n_kv_heads, hd, dt, dev)
    cross = (cfg.n_layers, batch, s_enc, cfg.n_kv_heads, hd)
    return {
        "self_kv": tree_map(lambda x: x.unsqueeze(0).repeat((cfg.n_layers,) + (1,) * x.ndim), kv),
        # cross K/V computed once at prefill: [L, b, s_enc, K, hd]
        "cross_k": torch.zeros(cross, dtype=dt, device=dev),
        "cross_v": torch.zeros(cross, dtype=dt, device=dev),
    }


def encdec_prefill(
    cfg: ModelConfig,
    params: Params,
    state: Dict[str, Any],
    enc_embeds: torch.Tensor,
    opts: ForwardOptions = ForwardOptions(),
) -> Dict[str, Any]:
    """Run the encoder and precompute per-layer cross K/V."""
    opts.check()
    enc_out = _encode(cfg, params, enc_embeds)
    kvs = [_cross_kv(gather_dp(layer), enc_out) for layer in _unstack(params["decoder"], cfg.n_layers)]
    return {**state, "cross_k": torch.stack([k for k, _ in kvs]), "cross_v": torch.stack([v for _, v in kvs])}


def encdec_decode_step(
    cfg: ModelConfig,
    params: Params,
    state: Dict[str, Any],
    tokens: torch.Tensor,          # [b, 1]
    cache_len: int,
    opts: ForwardOptions = ForwardOptions(),
) -> Tuple[torch.Tensor, Dict[str, Any]]:
    opts.check()
    cache_len = int(cache_len)
    x = embed_tokens(cfg, params["embed"], tokens)
    s_enc = state["cross_k"].shape[2]
    positions = torch.arange(cache_len, cache_len + 1, device=x.device)
    new_kv = []
    layers = zip(_unstack(params["decoder"], cfg.n_layers), _unstack(state["self_kv"], cfg.n_layers))
    for i, (layer, kv) in enumerate(layers):
        layer = gather_dp(layer)
        h = apply_norm(cfg, layer["self_norm"], x)
        q, k, v = project_qkv(cfg, layer["self_attn"], h, positions)
        kv = update_kv_cache(kv, k, v, cache_len)
        x = x + project_out(layer["self_attn"], decode_attention(q, kv["k"], kv["v"], cache_len + 1))
        # cross attention over the (fixed) encoder output
        hc = apply_norm(cfg, layer["cross_norm"], x)
        qc = torch.einsum("bsd,dhk->bshk", hc, layer["cross_attn"]["wq"].to(hc.dtype))
        oc = decode_attention(qc, state["cross_k"][i], state["cross_v"][i], s_enc)
        x = x + project_out(layer["cross_attn"], oc)
        x = x + apply_mlp(cfg, layer["mlp"], apply_norm(cfg, layer["ffn_norm"], x))
        new_kv.append(kv)
    x = apply_norm(cfg, params["final_norm"], x)
    logits = unembed(cfg, params["embed"], None, x)
    return logits[:, 0, :], {**state, "self_kv": _stack(new_kv)}

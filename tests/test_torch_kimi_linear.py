"""Kimi-Linear-48B-A3B on the port's model path, at SMOKE size on the CPU,
against the plain float32 reference (``models/kimi_linear_reference.py``).

SMOKE keeps the published stack's shape: a leading KDA layer with a dense
MLP, one unit [KDA, KDA, MLA, KDA] and the tail [KDA, MLA], and holds
experts 4–11 of 16 (an expert-parallel share).

Tolerances: everything runs in float32, so the port and the reference
differ only in the order of their sums (the chunked KDA core against the
token-by-token recurrence, the grouped einsums and blockwise softmax
against the per-head products), a few ulps of logits of order 0.5: 2e-5
relative to the largest logit holds that with room (the readings are
about 5e-7), while a fault in the mathematics (a missing gate, a dropped
scale, a rotated NoPE channel) moves the logits by 1e-3 or more
(``test_reference_is_not_blind``)."""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

import repro_torch.models as T
from repro_torch.configs import ARCH_SKIPS, SKIPS, get_config
from repro_torch.configs.kimi_linear_48b_a3b import ONE_CARD
from repro_torch.models import kimi_linear_reference as R
from repro_torch.models.config import FFNKind, LayerKind
from repro_torch.models.moe import _shared_expert, apply_moe, init_moe
from repro_torch.models.layers import split_params

TOL = 2e-5
CFG = get_config("kimi-linear-48b-a3b", smoke=True)
FULL = get_config("kimi-linear-48b-a3b")
CONFIG_FILE = Path(__file__).resolve().parents[1] / "portbench" / "configs" / "kimi-linear-48b-a3b.json"


def rel(a, b):
    return float((a - b).abs().max() / b.abs().max())


@pytest.fixture(scope="module")
def model():
    params, _ = T.init_lm_params(CFG, seed=0, device="cpu")
    tokens = torch.from_numpy(np.random.default_rng(0).integers(0, CFG.vocab_size, (2, 48)))
    return params, tokens


def test_layer_kinds_are_the_published_lists():
    lin = json.loads(CONFIG_FILE.read_text())["linear_attn_config"]
    kinds = FULL.layer_kinds()
    assert len(kinds) == 27 == FULL.n_layers
    assert [i + 1 for i, k in enumerate(kinds) if k is LayerKind.KDA] == lin["kda_layers"]
    assert [i + 1 for i, k in enumerate(kinds) if k is LayerKind.ATTN] == lin["full_attn_layers"]
    assert FULL.n_units == 6 and [s.kind for s in FULL.pattern_tail()] == [LayerKind.KDA, LayerKind.ATTN]
    assert FULL.lead_spec().ffn is FFNKind.DENSE
    assert all(s.ffn is FFNKind.MOE for s in FULL.pattern_unit() + FULL.pattern_tail())
    # one card's cut: the lead and two units, layers 1-9 as published
    assert ONE_CARD.layer_kinds() == kinds[:9] and ONE_CARD.n_units == 2
    assert ONE_CARD.n_experts == 256 and ONE_CARD.n_experts_held == 32


def test_parameters_in_place(model):
    params, _ = model
    assert set(params) == {"embed", "lead", "units", "tail", "final_norm", "lm_head"}
    assert set(params["lead"]) == {"kda_norm", "kda", "ffn_norm", "mlp"}
    assert set(params["tail"]) == {"sub0", "sub1"} and "attn" in params["tail"]["sub1"]
    kda = params["units"]["sub0"]["kda"]
    h, dk = CFG.kda_heads, CFG.kda_head_dim
    assert kda["wf_a"].shape == (1, CFG.d_model, CFG.kda_gate_rank) and kda["A_log"].shape == (1, h)
    assert kda["dt_bias"].shape == (1, h * dk) and kda["o_norm"].shape == (1, dk)
    moe = params["units"]["sub2"]["moe"]
    assert moe["router"].shape == (1, CFG.d_model, CFG.n_experts)
    assert moe["wi"].shape == (1, CFG.n_experts_held, CFG.d_model, CFG.moe_d_ff)
    assert set(moe["shared"]) == {"wi", "wg", "wo"}  # ungated
    state = T.init_lm_state(CFG, 2, 64, device="cpu")
    assert state["lead"]["rec"].shape == (1, 2, h, dk, dk)
    assert state["sub1"]["conv"]["q"].shape == (1, 2, CFG.kda_conv_kernel - 1, h * dk)
    assert state["tail"]["sub1"]["latent"]["c"].shape == (1, 2, 64, CFG.kv_lora_rank)
    # the published model, every expert held: 49.1B parameters, 3.5B active
    pc = T.param_counts(FULL)
    assert pc.total == 49_122_548_352 and pc.active == 3_484_326_528


def test_forward_matches_the_reference(model):
    params, tokens = model
    logits, _ = T.lm_forward(CFG, params, tokens=tokens)
    for i in range(tokens.shape[0]):
        assert rel(logits[i], R.forward(CFG, params, tokens[i])) < TOL


def test_prefill_extend_decode_match_the_full_forward(model):
    params, tokens = model
    state = T.init_lm_state(CFG, 2, 64, device="cpu")
    last = T.lm_prefill_inplace(CFG, params, state, tokens=tokens[:, :24])
    ext = T.lm_extend_inplace(CFG, params, state, tokens[:, 24:40], 24)
    steps = [T.lm_decode_inplace(CFG, params, state, tokens[:, t:t + 1], torch.tensor(t))
             for t in range(40, 48)]
    for i in range(2):
        ref = R.forward(CFG, params, tokens[i])
        assert rel(last[i], ref[23]) < TOL
        assert rel(ext[i], ref[24:40]) < TOL
        assert rel(torch.stack([s[i] for s in steps]), ref[40:48]) < TOL
    # prefill then decode alone, through the functional forms, which leave
    # the state they were given unchanged
    fresh = T.init_lm_state(CFG, 2, 64, device="cpu")
    lg, new = T.lm_prefill(CFG, params, fresh, tokens=tokens[:, :40])
    assert float(fresh["sub0"]["rec"].abs().max()) == 0.0
    lg2, _ = T.lm_decode_step(CFG, params, new, tokens[:, 40:41], 40)
    assert rel(lg2, steps[0]) < TOL


def test_reference_is_not_blind(model):
    """Each of KDA's gate, its output norm's gate, the routed scale and
    NoPE, changed, moves the reference's logits far past TOL."""
    params, tokens = model
    ref = R.forward(CFG, params, tokens[0])
    changed = {"moe_routed_scale": 1.0}
    assert rel(R.forward(CFG.replace(**changed), params, tokens[0]), ref) > 50 * TOL
    for leaf in ("wg_b", "dt_bias"):
        p2 = {**params, "units": {**params["units"], "sub0": {**params["units"]["sub0"], "kda": {
            **params["units"]["sub0"]["kda"], leaf: params["units"]["sub0"]["kda"][leaf] + 1.0}}}}
        assert rel(R.forward(CFG, p2, tokens[0]), ref) > 50 * TOL, leaf
    roped, _ = T.lm_forward(CFG.replace(mla_rope=True), params, tokens=tokens[:1])
    assert rel(roped[0], ref) > 50 * TOL


@pytest.mark.parametrize("dispatch", ["gather", "dense"])
def test_expert_shares_add_up_to_the_uncut_layer(dispatch):
    """Eight shares of two experts each, each routing over all 16 and adding
    its own experts' part with the shared expert: their parts, the shared
    expert counted once, add up to the uncut layer."""
    uncut = CFG.replace(experts_held=None, moe_capacity_factor=16 / 4)
    params, _ = split_params(init_moe(uncut, torch.Generator().manual_seed(2)))
    x = torch.randn((2, 24, CFG.d_model), generator=torch.Generator().manual_seed(3))
    whole, _ = apply_moe(uncut, params, x, dispatch=dispatch)
    parts = []
    for i in range(8):
        cfg = uncut.replace(experts_held=(2 * i, 2 * i + 2))
        share = {**params, **{k: params[k][2 * i: 2 * i + 2] for k in ("wi", "wg", "wo")}}
        parts.append(apply_moe(cfg, share, x, dispatch=dispatch)[0])
    shared = _shared_expert(uncut, params["shared"], x)
    total = sum(p - shared for p in parts) + shared
    assert rel(total, whole) < 1e-5
    assert rel(parts[0], whole) > 1e-2  # one share alone is not the layer


def test_sigmoid_router_renormalises_and_scales():
    from repro_torch.models.moe import _routing

    params, _ = split_params(init_moe(CFG, torch.Generator().manual_seed(5)))
    x = torch.randn((7, CFG.d_model), generator=torch.Generator().manual_seed(6))
    probs, top_w, top_i, _ = _routing(CFG, params, x)
    assert torch.allclose(probs, torch.sigmoid(x @ params["router"]))
    assert torch.allclose(top_w.sum(-1), torch.full((7,), CFG.moe_routed_scale))
    assert torch.equal(top_i, torch.topk(probs, CFG.top_k, dim=-1).indices)


def test_training_step_is_finite(model):
    params, tokens = model
    leaves = {k: v.clone().requires_grad_(True) for k, v in params["units"]["sub0"]["kda"].items()}
    p2 = {**params, "units": {**params["units"], "sub0": {**params["units"]["sub0"], "kda": leaves}}}
    logits, aux = T.lm_forward(CFG, p2, tokens=tokens)
    (torch.nn.functional.cross_entropy(logits[:, :-1].reshape(-1, CFG.vocab_size),
                                       tokens[:, 1:].reshape(-1)) + aux).backward()
    assert all(torch.isfinite(v.grad).all() and v.grad.abs().sum() > 0 for v in leaves.values())


def test_serving_engine_greedy_tokens_are_the_forwards_argmax(model):
    from repro_torch.serve import ServingEngine

    params, tokens = model
    out = ServingEngine(CFG, params, max_len=32, device="cpu").generate(tokens[:, :12], 6)
    logits, _ = T.lm_forward(CFG, params, tokens=out[:, :-1])
    assert torch.equal(out[:, 12:], logits[:, 11:].argmax(-1))


def _span_counts(fn):
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        fn()
    names = [e.name for e in prof.events() if e.name.startswith("rt.kda.")]
    return {n: names.count(n) for n in set(names)}


def test_spans(model):
    params, tokens = model
    n = CFG.layer_kinds().count(LayerKind.KDA)
    assert _span_counts(lambda: T.lm_forward(CFG, params, tokens=tokens)) == {
        "rt.kda.conv": n, "rt.kda.gates": n, "rt.kda.chunk": n, "rt.kda.pass": n}
    state = T.init_lm_state(CFG, 2, 64, device="cpu")
    assert _span_counts(lambda: T.lm_prefill_inplace(CFG, params, state, tokens=tokens[:, :24])) == {
        "rt.kda.conv": n, "rt.kda.gates": n, "rt.kda.chunk": n, "rt.kda.pass": n, "rt.kda.state": n}
    assert _span_counts(lambda: T.lm_decode_inplace(CFG, params, state, tokens[:, 24:25], torch.tensor(24))) == {
        "rt.kda.conv": n, "rt.kda.gates": n, "rt.kda.state": n}


def test_dryrun_skips_the_arch_with_its_reason():
    from repro_torch.launch.dryrun import run_cell

    for shape in ("train_4k", "decode_32k", "prefill:128:2"):
        row = run_cell("kimi-linear-48b-a3b", shape, None, "single", device="cpu", smoke=True)
        assert row["status"] == "skipped" and row["reason"] == ARCH_SKIPS["kimi-linear-48b-a3b"]
    assert SKIPS[("kimi-linear-48b-a3b", "long_500k")] == ARCH_SKIPS["kimi-linear-48b-a3b"]


def test_benchmark_configuration_is_the_program_s():
    """The configuration file's published keys give ONE_CARD's widths."""
    c = json.loads(CONFIG_FILE.read_text())
    lin = c["linear_attn_config"]
    assert (ONE_CARD.d_model, ONE_CARD.n_layers, ONE_CARD.vocab_size) == (
        c["hidden_size"], c["num_hidden_layers"], c["vocab_size"])
    assert (ONE_CARD.kda_heads, ONE_CARD.kda_head_dim, ONE_CARD.kda_conv_kernel) == (
        lin["num_heads"], lin["head_dim"], lin["short_conv_kernel_size"])
    assert (ONE_CARD.n_heads, ONE_CARD.kv_lora_rank, ONE_CARD.qk_nope_head_dim, ONE_CARD.qk_rope_head_dim,
            ONE_CARD.v_head_dim) == (c["num_attention_heads"], c["kv_lora_rank"], c["qk_nope_head_dim"],
                                     c["qk_rope_head_dim"], c["v_head_dim"])
    assert ONE_CARD.mla_rope is not c["mla_use_nope"]
    assert (ONE_CARD.d_ff, ONE_CARD.moe_d_ff, ONE_CARD.top_k, ONE_CARD.n_shared_experts) == (
        c["intermediate_size"], c["moe_intermediate_size"], c["num_experts_per_token"], c["num_shared_experts"])
    assert ONE_CARD.n_experts == c["published"]["num_experts"] and ONE_CARD.n_experts_held == c["num_experts"]
    assert ONE_CARD.moe_routed_scale == c["routed_scaling_factor"] and ONE_CARD.norm_eps == c["rms_norm_eps"]

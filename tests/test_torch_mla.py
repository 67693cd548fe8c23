"""DeepSeek-V2-Lite's multi-head latent attention on the port's model path,
at SMOKE size on the CPU, against the plain float32 reference
(``models/deepseek_v2_reference.py``).

Tolerances: everything here runs in float32, so the port and the reference
differ only in the order of their sums (the port's grouped einsums and
blockwise softmax against the reference's per-head products), a few ulps
of logits of order 1: 2e-5 relative to the largest logit holds that with
room, while a fault in the mathematics (a missing scale, rope or norm
weight) moves the logits by 1e-2 or more (``test_reference_sees_yarn``)."""

import torch
import pytest

import repro_torch.models as T
from repro_torch.configs import ARCH_SKIPS, SKIPS, get_config
from repro_torch.models import deepseek_v2_reference as R
from repro_torch.models.flops import mla_algorithm_flops
from repro_torch.models.mla import ALGORITHMS, mla_attention, pick_algorithm

TOL = 2e-5
CFG = get_config("deepseek-v2-lite", smoke=True)
FULL = get_config("deepseek-v2-lite")


def rel(a, b):
    return float((a - b).abs().max() / b.abs().max())


@pytest.fixture(scope="module")
def model():
    params, _ = T.init_lm_params(CFG, seed=0, device="cpu")
    tokens = torch.from_numpy(__import__("numpy").random.default_rng(0).integers(0, CFG.vocab_size, (2, 48)))
    return params, tokens


def test_layers_in_place(model):
    params, _ = model
    assert set(params) == {"embed", "lead", "units", "final_norm", "lm_head"}
    lead, unit = params["lead"], params["units"]["sub0"]
    assert lead["mlp"]["wi"].shape == (1, CFG.d_model, CFG.d_ff) and "moe" not in lead
    assert unit["moe"]["wi"].shape == (CFG.n_layers - 1, CFG.n_experts, CFG.d_model, CFG.moe_d_ff)
    assert set(unit["moe"]["shared"]) == {"wi", "wg", "wo"}  # ungated
    assert unit["moe"]["shared"]["wi"].shape[-1] == CFG.n_shared_experts * CFG.moe_d_ff
    assert set(unit["attn"]) == {"wq", "wkv_a", "kv_norm", "wuk", "wuv", "wo"}
    state = T.init_lm_state(CFG, 2, 64, device="cpu")
    assert state["lead"]["latent"]["c"].shape == (1, 2, 64, CFG.kv_lora_rank)
    assert state["sub0"]["latent"]["kr"].shape == (CFG.n_layers - 1, 2, 64, CFG.qk_rope_head_dim)
    pc = T.param_counts(FULL)
    assert pc.total == 15_706_371_584  # the published 15.7B
    assert FULL.n_units == 26 and FULL.pattern_unit()[0].ffn is T.FFNKind.MOE


def test_forward_matches_the_reference(model):
    params, tokens = model
    logits, _ = T.lm_forward(CFG, params, tokens=tokens)
    for i in range(tokens.shape[0]):
        assert rel(logits[i], R.forward(CFG, params, tokens[i])) < TOL


@pytest.mark.parametrize("impl", ALGORITHMS)
def test_algorithms_agree(model, impl):
    params, tokens = model
    want, _ = T.lm_forward(CFG, params, tokens=tokens, opts=T.ForwardOptions(mla_impl=impl, attn_impl="reference"))
    ref, _ = T.lm_forward(CFG, params, tokens=tokens)
    assert rel(want, ref) < TOL
    # one extend step of the sublayer against a cache, each algorithm alike
    p = {k: v[0] for k, v in params["units"]["sub0"]["attn"].items()}
    g = torch.Generator().manual_seed(1)
    x = torch.randn((2, 8, CFG.d_model), generator=g)
    cache = {"c": torch.randn((2, 40, CFG.kv_lora_rank), generator=g),
             "kr": torch.randn((2, 40, CFG.qk_rope_head_dim), generator=g)}
    base = {k: v.clone() for k, v in cache.items()}
    out = mla_attention(CFG, p, x, 32, base, impl="decompress")
    mine = {k: v.clone() for k, v in cache.items()}
    assert rel(mla_attention(CFG, p, x, 32, mine, impl=impl), out) < TOL
    assert all(torch.equal(mine[k], base[k]) for k in cache)


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
    # the functional forms leave the state they were given unchanged
    fresh = T.init_lm_state(CFG, 2, 64, device="cpu")
    lg, new = T.lm_prefill(CFG, params, fresh, tokens=tokens[:, :24])
    assert float(fresh["sub0"]["latent"]["c"].abs().max()) == 0.0 and torch.equal(lg, last)
    lg, _ = T.lm_decode_step(CFG, params, new, tokens[:, 24:25], 24)
    assert rel(lg, ext[:, 0]) < TOL


def test_reference_sees_yarn(model):
    """The reference is not blind to the rope's YaRN factor nor to its
    attention scale: each changed moves the logits far past TOL."""
    params, tokens = model
    ref = R.forward(CFG, params, tokens[0])
    for change in ({"rope_factor": 1.0}, {"rope_mscale_all_dim": 0.0}):
        assert rel(R.forward(CFG.replace(**change), params, tokens[0]), ref) > 100 * TOL


def test_dispatcher_follows_the_flop_table():
    for q in (1, 64, 128, 168, 169, 256, 512, 2048):
        f = mla_algorithm_flops(FULL, q, 16384)
        order = "absorb" if f["absorb"] < f["decompress"] else "decompress"
        assert pick_algorithm(FULL, q, 16384) == order + ("_chunked" if q > 1024 else "")
    assert pick_algorithm(FULL, 168, 16384) == "absorb" and pick_algorithm(FULL, 169, 16384) == "decompress"
    assert pick_algorithm(FULL, 16384, 16384).startswith("decompress")   # prefill
    assert pick_algorithm(FULL, 1, 16640) == "absorb"                      # decode
    assert pick_algorithm(FULL, 64, 16384, scores="chunked") == "absorb_chunked"
    assert pick_algorithm(FULL, 64, 16384, impl="decompress") == "decompress"
    with pytest.raises(ValueError):
        pick_algorithm(FULL, 64, 16384, impl="latent")
    f = mla_algorithm_flops(FULL, 64, 16384)
    assert f["absorb"] == f["absorb_chunked"] == pytest.approx(38.27e9, rel=1e-3)
    assert f["decompress"] == pytest.approx(80.95e9, rel=1e-3)


def _span_counts(fn):
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        fn()
    names = [e.name for e in prof.events() if e.name.startswith("rt.mla.")]
    return {n: names.count(n) for n in set(names)}


def test_spans_and_counters(model):
    params, tokens = model
    n = CFG.n_layers
    assert _span_counts(lambda: T.lm_forward(CFG, params, tokens=tokens)) == {
        "rt.mla.pick.decompress": n, "rt.mla.expand": n}
    assert _span_counts(lambda: T.lm_forward(CFG, params, tokens=tokens,
                                             opts=T.ForwardOptions(mla_impl="absorb_chunked"))) == {
        "rt.mla.pick.absorb": n, "rt.mla.absorb": 2 * n}
    state = T.init_lm_state(CFG, 2, 64, device="cpu")
    assert _span_counts(lambda: T.lm_prefill_inplace(CFG, params, state, tokens=tokens[:, :24])) == {
        "rt.mla.pick.decompress": n, "rt.mla.expand": n, "rt.mla.cache": n}
    assert _span_counts(lambda: T.lm_decode_inplace(CFG, params, state, tokens[:, 24:25], torch.tensor(24))) == {
        "rt.mla.pick.absorb": n, "rt.mla.absorb": 2 * n, "rt.mla.cache": n}


def test_site_variants_agree_and_carry_the_flop_table():
    from repro_torch.autotune import mla_site

    site = mla_site(q=8, L=64, b=2, cfg=CFG, device="cpu")
    assert site.flops_table() == mla_algorithm_flops(CFG, 8, 64, 2)
    tensors = site.make_inputs(3)
    outs = {name: fn() for name, fn in site.workloads(seed=3).items()}
    assert set(outs) == set(ALGORITHMS)
    for name, out in outs.items():
        assert rel(out, outs["decompress"]) < TOL, name
    assert tensors[0].shape == (2, 8, CFG.d_model)


def test_dryrun_skips_the_arch_with_its_reason():
    from repro_torch.launch.dryrun import run_cell

    for shape in ("train_4k", "decode_32k", "prefill:128:2"):
        row = run_cell("deepseek-v2-lite", shape, None, "single", device="cpu", smoke=True)
        assert row["status"] == "skipped" and row["reason"] == ARCH_SKIPS["deepseek-v2-lite"]
    assert SKIPS[("deepseek-v2-lite", "long_500k")] == ARCH_SKIPS["deepseek-v2-lite"]

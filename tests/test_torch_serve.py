"""The port's serving layer (``repro_torch.serve.engine``, ``serve.quant``,
``launch.serve``) against the JAX package's, on the same weights, prompts
and caches (numpy-made). Tolerances: greedy tokens and int8 payloads
exactly, scales within 1 ulp, attention over the int8 cache within 1e-5,
the reference's bounds for the int8 cache against full precision."""

import contextlib
import io
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.models as R  # noqa: E402
from repro.configs import get_config as ref_config  # noqa: E402
from repro.models.attention import decode_attention as ref_decode_attention  # noqa: E402
from repro.models.attention import init_kv_cache as ref_init_kv_cache  # noqa: E402
from repro.models.attention import update_kv_cache as ref_update_kv_cache  # noqa: E402
from repro.serve import quant as rq  # noqa: E402
from repro.serve.engine import ServingEngine as RefEngine  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import serve as launcher  # noqa: E402
from repro_torch.models.attention import decode_attention, init_kv_cache, update_kv_cache  # noqa: E402
from repro_torch.models.layers import params_from_numpy  # noqa: E402
from repro_torch.serve import ServingEngine, make_prefill, make_serve_step  # noqa: E402
from repro_torch.serve import quant as tq  # noqa: E402


def _kv(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


# ----------------------------------------------------------------- quant ---

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_quantize_kv_matches_reference(seed):
    k = _kv((2, 8, 2, 16), seed)
    k[0, 0, 0] = 0.0  # an all-zero head: scale 1
    rq8, rs = rq.quantize_kv(jnp.asarray(k))
    tq8, ts = tq.quantize_kv(torch.from_numpy(k))
    assert tq8.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq8.numpy(), np.asarray(rq8))
    np.testing.assert_array_max_ulp(ts.numpy(), np.asarray(rs), maxulp=1)
    assert float(ts[0, 0, 0]) == 1.0
    np.testing.assert_array_equal(tq.dequantize_kv(tq8, ts, torch.float32).numpy(),
                                  np.asarray(rq.dequantize_kv(rq8, rs, jnp.float32)))
    # the reference's round-trip bound
    rec = tq.dequantize_kv(tq8, ts, torch.float32).numpy()
    assert (np.abs(rec - k) <= np.abs(k).max(axis=-1, keepdims=True) / 127.0 + 1e-6).all()


def test_quant_decode_attention_matches_reference():
    """The int8 cache filled, then written once more past a clamped offset;
    attention over it against the reference's, and against full precision
    within the reference's 5 %."""
    b, S, K, H, hd = 2, 64, 2, 4, 32
    q, k_new, v_new = _kv((b, 1, H, hd), 0), _kv((b, 40, K, hd), 1), _kv((b, 40, K, hd), 2)
    rc = rq.update_quant_kv_cache(rq.init_quant_kv_cache(b, S, K, hd), jnp.asarray(k_new), jnp.asarray(v_new),
                                  jnp.int32(0))
    tc = tq.update_quant_kv_cache(tq.init_quant_kv_cache(b, S, K, hd, device="cpu"), torch.from_numpy(k_new),
                                  torch.from_numpy(v_new), 0)
    # a write whose offset the update clamps (60 + 8 > 64)
    k2, v2 = _kv((b, 8, K, hd), 3), _kv((b, 8, K, hd), 4)
    rc = rq.update_quant_kv_cache(rc, jnp.asarray(k2), jnp.asarray(v2), jnp.int32(60))
    tc = tq.update_quant_kv_cache(tc, torch.from_numpy(k2), torch.from_numpy(v2), 60)
    for name in ("k_q", "v_q"):
        np.testing.assert_array_equal(tc[name].numpy(), np.asarray(rc[name]))
    for name in ("k_s", "v_s"):
        np.testing.assert_array_max_ulp(tc[name].numpy(), np.asarray(rc[name]), maxulp=1)
    ref = rq.quant_decode_attention(jnp.asarray(q), rc, jnp.int32(40))
    out = tq.quant_decode_attention(torch.from_numpy(q), tc, 40)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5, rtol=1e-5)

    fp = update_kv_cache(init_kv_cache(b, S, K, hd, torch.float32, device="cpu"), torch.from_numpy(k_new),
                         torch.from_numpy(v_new), 0)
    out_fp = decode_attention(torch.from_numpy(q), fp["k"], fp["v"], 40)
    tc40 = tq.update_quant_kv_cache(tq.init_quant_kv_cache(b, S, K, hd, device="cpu"), torch.from_numpy(k_new),
                                    torch.from_numpy(v_new), 0)
    out_q8 = tq.quant_decode_attention(torch.from_numpy(q), tc40, 40)
    assert float((out_q8 - out_fp).abs().max() / (out_fp.abs().max() + 1e-9)) < 0.05
    ref_fp = ref_update_kv_cache(ref_init_kv_cache(b, S, K, hd, jnp.float32), jnp.asarray(k_new),
                                 jnp.asarray(v_new), jnp.int32(0))
    np.testing.assert_allclose(out_fp.numpy(), np.asarray(ref_decode_attention(
        jnp.asarray(q), ref_fp["k"], ref_fp["v"], jnp.int32(40))), atol=1e-5, rtol=1e-5)


def test_quant_cache_halves_bytes():
    b, S, K, hd = 1, 128, 2, 64
    fp = init_kv_cache(b, S, K, hd, torch.bfloat16, device="cpu")
    q8 = tq.init_quant_kv_cache(b, S, K, hd, device="cpu")
    fp_bytes = sum(x.numel() * x.element_size() for x in fp.values())
    q8_bytes = sum(x.numel() * x.element_size() for x in q8.values())
    assert q8_bytes < 0.6 * fp_bytes


# ---------------------------------------------------------------- engine ---

@pytest.mark.parametrize("arch,prompt_len,n_new,max_len", [
    ("qwen2-moe-a2.7b", 12, 10, 32),
    ("qwen3-14b", 12, 10, 32),
    # window 16: a 130-token prompt fills the 128-slot ring cache in two
    # segments, and decode writes across the wrap
    ("gemma2-27b", 130, 8, 160),
    ("mamba2-1.3b", 12, 10, 32),
])
def test_greedy_tokens_match_reference(arch, prompt_len, n_new, max_len):
    rc, tc = ref_config(arch, smoke=True), get_config(arch, smoke=True)
    rp, _ = R.init_lm_params(rc, jax.random.PRNGKey(0))
    tp = params_from_numpy(jax.tree.map(np.asarray, rp), "cpu")
    prompts = np.random.default_rng(1).integers(0, rc.vocab_size, (2, prompt_len)).astype(np.int32)
    ref = RefEngine(rc, rp, max_len=max_len).generate(jnp.asarray(prompts), n_new=n_new)
    engine = ServingEngine(tc, tp, max_len=max_len, device="cpu")
    out = engine.generate(torch.from_numpy(prompts), n_new=n_new)
    assert out.shape == (2, prompt_len + n_new) and out.dtype == torch.int32
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    assert engine.last_logits.shape == (2, tc.vocab_size)


def test_temperature_sampling_is_seeded():
    cfg = get_config("granite-8b", smoke=True)
    from repro_torch.models import init_lm_params

    params, _ = init_lm_params(cfg, seed=0, device="cpu")
    engine = ServingEngine(cfg, params, max_len=24, temperature=0.7, device="cpu")
    prompts = torch.from_numpy(np.random.default_rng(1).integers(0, cfg.vocab_size, (3, 8)))
    a, b = engine.generate(prompts, 8, seed=5), engine.generate(prompts, 8, seed=5)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert torch.equal(a[:, :8], prompts)
    assert int(a.min()) >= 0 and int(a.max()) < cfg.vocab_size
    assert not torch.equal(a, engine.generate(prompts, 8, seed=6))


def test_step_functions_match_reference_whisper():
    """``make_prefill``/``make_serve_step`` route an encoder-decoder config
    to the encoder-decoder functions, as the reference's do."""
    rc, tc = ref_config("whisper-tiny", smoke=True), get_config("whisper-tiny", smoke=True)
    rp, _ = R.init_encdec_params(rc, jax.random.PRNGKey(0))
    tp = params_from_numpy(jax.tree.map(np.asarray, rp), "cpu")
    enc = 0.02 * np.random.default_rng(2).standard_normal((1, rc.encoder_seq, rc.d_model)).astype(np.float32)
    from repro.serve.engine import make_prefill as ref_make_prefill
    from repro.serve.engine import make_serve_step as ref_make_serve_step
    from repro_torch.models import init_encdec_state

    rst = ref_make_prefill(rc)(rp, R.init_encdec_state(rc, 1, 8, rc.encoder_seq), jnp.asarray(enc))
    tst = make_prefill(tc)(tp, init_encdec_state(tc, 1, 8, tc.encoder_seq, device="cpu"), torch.from_numpy(enc))
    tok = np.array([[3]], np.int32)
    rl, _ = ref_make_serve_step(rc)(rp, rst, jnp.asarray(tok), jnp.int32(0))
    tl, _ = make_serve_step(tc)(tp, tst, torch.from_numpy(tok), 0)
    ref = np.asarray(rl)
    assert float(np.abs(tl.numpy() - ref).max()) <= 2e-4 * (1 + float(np.abs(ref).max()))


def test_engine_refuses_a_missing_gpu():
    if torch.cuda.is_available():
        pytest.skip("this host has a GPU: the refusal needs a host without one")
    cfg = get_config("granite-8b", smoke=True)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServingEngine(cfg, {})


# -------------------------------------------------------------- launcher ---

def test_launcher_runs_on_the_cpu():
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = launcher.main(["--arch", "qwen2-moe-a2.7b", "--device", "cpu", "--temperature", "0",
                            "--batch", "2", "--prompt-len", "8", "--tokens", "6"])
    assert rc == 0
    lines = out.getvalue().splitlines()
    assert lines[0].startswith("qwen2-moe-a2.7b (smoke) on cpu: 2x6 tokens in ")
    sample = [int(v) for v in lines[1].removeprefix("sample: [").removesuffix("]").split(",")]
    assert len(sample) == 6 and all(0 <= v < get_config("qwen2-moe-a2.7b", smoke=True).vocab_size for v in sample)
    # greedy: the sample is the engine's on the launcher's weights and prompts
    from repro_torch.models import init_lm_params

    cfg = get_config("qwen2-moe-a2.7b", smoke=True)
    params, _ = init_lm_params(cfg, seed=0, device="cpu")
    prompts = torch.randint(0, cfg.vocab_size, (2, 8), generator=torch.Generator().manual_seed(1))
    expect = ServingEngine(cfg, params, max_len=22, device="cpu").generate(prompts, 6)
    assert sample == expect[0, 8:].tolist()
    assert not math.isnan(float(lines[0].split("(")[-1].split()[0]))


def test_launcher_refuses_an_encoder_decoder_arch():
    with pytest.raises(SystemExit, match="LM arch"):
        launcher.main(["--arch", "whisper-tiny", "--device", "cpu"])

"""The port's serving path through the model stack (``lm_prefill``,
``lm_decode_step``, the encoder-decoder's prefill and decode, the ring cache
of windowed layers) against the JAX package's, on the same parameters and
numpy-made tokens, and the reference's decode-consistency tests on the port.
Tolerances: logits within ``2e-4 * (1 + max|ref|)``, caches within 1e-4
(1e-5 for the ring), the reference's 5e-2 relative bound for decode against
the forward."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.models as R  # noqa: E402
import repro_torch.models as T  # noqa: E402
from repro.configs import ARCH_NAMES  # noqa: E402
from repro.configs import get_config as ref_config  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models.layers import params_from_numpy  # noqa: E402

LM_ARCHS = [a for a in ARCH_NAMES if a != "whisper-tiny"]
LOGIT_TOL = 2e-4


def _params(arch):
    """(reference config, port config, reference params, port params)."""
    rc, tc = ref_config(arch, smoke=True), get_config(arch, smoke=True)
    init = R.init_encdec_params if rc.is_encoder_decoder else R.init_lm_params
    rp, _ = init(rc, jax.random.PRNGKey(0))
    return rc, tc, rp, params_from_numpy(jax.tree.map(np.asarray, rp), "cpu")


def _tokens(cfg, shape, seed=1):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, shape)


def _assert_logits(port, ref, what):
    ref = np.asarray(ref)
    err = float(np.abs(port.numpy() - ref).max())
    assert err <= LOGIT_TOL * (1 + float(np.abs(ref).max())), f"{what}: max|port - ref| {err}"


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_prefill_and_decode_logits_match_reference(arch):
    """``lm_prefill`` of s-1 tokens, then two ``lm_decode_step``s: each
    step's logits against the reference's on the same weights."""
    rc, tc, rp, tp = _params(arch)
    b, s = 2, 24
    tok = _tokens(rc, (b, s + 1))
    rstate, tstate = R.init_lm_state(rc, b, s + 8), T.init_lm_state(tc, b, s + 8, device="cpu")
    rl, rstate = R.lm_prefill(rc, rp, rstate, tokens=jnp.asarray(tok[:, : s - 1]))
    tl, tstate = T.lm_prefill(tc, tp, tstate, tokens=torch.from_numpy(tok[:, : s - 1]))
    _assert_logits(tl, rl, f"{arch} prefill")
    for t in (s - 1, s):
        rl, rstate = R.lm_decode_step(rc, rp, rstate, jnp.asarray(tok[:, t: t + 1]), jnp.int32(t))
        tl, tstate = T.lm_decode_step(tc, tp, tstate, torch.from_numpy(tok[:, t: t + 1]), t)
        _assert_logits(tl, rl, f"{arch} decode at {t}")
    for (path, r), t in zip(jax.tree_util.tree_leaves_with_path(rstate), jax.tree.leaves(tstate)):
        np.testing.assert_allclose(t.float().numpy(), np.asarray(r, np.float32), atol=1e-4, rtol=1e-4,
                                   err_msg=jax.tree_util.keystr(path))


def test_whisper_prefill_and_decode_match_reference():
    rc, tc, rp, tp = _params("whisper-tiny")
    b = 2
    rng = np.random.default_rng(4)
    enc = 0.02 * rng.standard_normal((b, rc.encoder_seq, rc.d_model)).astype(np.float32)
    dec = _tokens(rc, (b, 8))
    rst = R.encdec_prefill(rc, rp, R.init_encdec_state(rc, b, 16, rc.encoder_seq), jnp.asarray(enc))
    tst = T.encdec_prefill(tc, tp, T.init_encdec_state(tc, b, 16, tc.encoder_seq, device="cpu"),
                           torch.from_numpy(enc))
    np.testing.assert_allclose(tst["cross_k"].numpy(), np.asarray(rst["cross_k"]), atol=1e-5, rtol=1e-5)
    for t in range(4):
        rl, rst = R.encdec_decode_step(rc, rp, rst, jnp.asarray(dec[:, t: t + 1]), jnp.int32(t))
        tl, tst = T.encdec_decode_step(tc, tp, tst, torch.from_numpy(dec[:, t: t + 1]), t)
        _assert_logits(tl, rl, f"whisper decode at {t}")


# ----------------------------------------- the reference's tests, on the port

@pytest.mark.parametrize("arch", LM_ARCHS)
def test_smoke_decode_consistency(arch):
    """prefill + decode logits == full-forward logits (per family), on the
    port's own weights."""
    cfg = get_config(arch, smoke=True)
    b, s = 2, 24
    params, _ = T.init_lm_params(cfg, seed=0, device="cpu")
    tokens = torch.from_numpy(_tokens(cfg, (b, s)))
    state = T.init_lm_state(cfg, b, s + 8, device="cpu")
    if cfg.frontend == "vision_stub":
        embeds = T.layers.embed_tokens(cfg, params["embed"], tokens)
        logits, _ = T.lm_forward(cfg, params, embeds=embeds)
        _, state = T.lm_prefill(cfg, params, state, embeds=embeds[:, : s - 1])
    else:
        logits, _ = T.lm_forward(cfg, params, tokens=tokens)
        _, state = T.lm_prefill(cfg, params, state, tokens=tokens[:, : s - 1])
    lg, state = T.lm_decode_step(cfg, params, state, tokens[:, s - 1: s], s - 1)
    ref = logits[:, s - 1, :]
    err = float((lg - ref).abs().max() / (ref.abs().max() + 1e-9))
    assert err < 5e-2, f"{arch}: decode relerr {err}"


def test_whisper_decode_consistency():
    cfg = get_config("whisper-tiny", smoke=True)
    params, _ = T.init_encdec_params(cfg, seed=0, device="cpu")
    b = 2
    enc = T.audio_frame_embeds(cfg, b, cfg.encoder_seq, device="cpu")
    dec = torch.from_numpy(_tokens(cfg, (b, 8), seed=2))
    logits, _ = T.encdec_forward(cfg, params, enc, dec)
    st = T.encdec_prefill(cfg, params, T.init_encdec_state(cfg, b, 16, cfg.encoder_seq, device="cpu"), enc)
    for t in range(4):
        lg, st = T.encdec_decode_step(cfg, params, st, dec[:, t: t + 1], t)
    ref = logits[:, 3, :]
    assert float((lg - ref).abs().max() / (ref.abs().max() + 1e-9)) < 5e-2


def test_sliding_window_decode_ring_buffer():
    """Windowed decode with a ring cache == full-cache windowed decode; and,
    on the reference's weights, the ring cache written by prefill and decode
    past the window equals the reference's slot for slot."""
    cfg = T.ModelConfig(
        name="ring", n_layers=2, d_model=32, n_heads=2, n_kv_heads=2, d_ff=64,
        vocab_size=128, sliding_window=8, dtype="float32", param_dtype="float32",
    )
    params, _ = T.init_lm_params(cfg, seed=0, device="cpu")
    b, s = 1, 30
    tokens = torch.from_numpy(_tokens(cfg, (b, s)))
    logits, _ = T.lm_forward(cfg, params, tokens=tokens, opts=T.ForwardOptions(attn_impl="reference"))
    state = T.init_lm_state(cfg, b, max_len=s + 2, device="cpu")
    _, state = T.lm_prefill(cfg, params, state, tokens=tokens[:, : s - 1])
    lg, _ = T.lm_decode_step(cfg, params, state, tokens[:, s - 1: s], s - 1)
    err = float((lg - logits[:, s - 1]).abs().max()) / float(logits[:, s - 1].abs().max())
    assert err < 5e-2, err

    # a ring that wraps: 128 slots (window 8 rounded up), prefill of 131
    # tokens (two segments), decode across the wrap
    rc = R.ModelConfig(**{f: getattr(cfg, f) for f in cfg.__dataclass_fields__})
    rp, _ = R.init_lm_params(rc, jax.random.PRNGKey(0))
    tp = params_from_numpy(jax.tree.map(np.asarray, rp), "cpu")
    tok = _tokens(cfg, (b, 140))
    rst, tst = R.init_lm_state(rc, b, 200), T.init_lm_state(cfg, b, 200, device="cpu")
    assert tst["sub0"]["kv"]["k"].shape[2] == 128
    _, rst = R.lm_prefill(rc, rp, rst, tokens=jnp.asarray(tok[:, :131]))
    _, tst = T.lm_prefill(cfg, tp, tst, tokens=torch.from_numpy(tok[:, :131]))
    for t in range(131, 136):
        rl, rst = R.lm_decode_step(rc, rp, rst, jnp.asarray(tok[:, t: t + 1]), jnp.int32(t))
        tl, tst = T.lm_decode_step(cfg, tp, tst, torch.from_numpy(tok[:, t: t + 1]), t)
        _assert_logits(tl, rl, f"ring decode at {t}")
    np.testing.assert_allclose(tst["sub0"]["kv"]["k"].numpy(), np.asarray(rst["sub0"]["kv"]["k"]),
                               atol=1e-5, rtol=1e-5)

"""Kimi-Linear-48B-A3B on the card, in float32 with TF32 off: one card's
share of the benchmark's deployment (``ONE_CARD``: layers 1–9 at published
widths, experts 0–31 of each layer's 256) prefills one segment of 16384
tokens through ``lm_prefill_inplace`` and decodes 32 tokens through
``lm_decode_inplace`` captured as one CUDA graph, against the plain
reference's logits (``models/kimi_linear_reference.py``); and the
``kda_chunk`` site at the benchmark cell's widths against the benchmark's
float64 recurrence (``portbench/reference_kda.py``). Skips without a CUDA
device; on the card: ``pytest -m cuda tests/test_torch_kimi_linear_card.py``.

Tolerances, each with its reason:

* ``MODEL_TOL`` = 1e-4 of the largest reference logit. Both sides run in
  float32; they differ in the order of their sums: the chunked KDA core
  against a 16384-step recurrence, blockwise softmax over 16416 keys
  against one row at a time, the gather dispatch against dense experts.
  Each is a few ulps (1e-7) per operation, grown over 9 layers (2.7e-5
  read); the same prefill with TF32 on (operands of 10 mantissa bits,
  5e-4) must read more than the tolerance, and the test holds that too.
* ``CORE_TOL`` = 5e-5, the cell's ``out_err`` limit: the core reads about
  1e-6 against float64 at these widths.
"""

import gc

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro_torch.models as T  # noqa: E402
from repro_torch.configs.kimi_linear_48b_a3b import ONE_CARD  # noqa: E402
from repro_torch.graphs import capture_async, release_pools  # noqa: E402
from repro_torch.models import kimi_linear_reference as R  # noqa: E402

MODEL_TOL = 1e-4
CORE_TOL = 5e-5
PROMPT, STEPS = 16384, 32


@pytest.fixture
def card():
    """The card with TF32 off, its memory released after the test (the
    model's and the graphs' pools), so that each test has the card whole."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the model at published widths does not fit a CPU test")
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    yield torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    gc.collect()
    release_pools()
    torch.cuda.empty_cache()


def rel(a, b):
    return float((a.double() - b.double()).abs().max() / b.double().abs().max())


@pytest.mark.cuda
def test_one_card_prefill_and_graph_decode_match_the_reference(card):
    dev = card
    cfg = ONE_CARD.replace(dtype="float32", param_dtype="float32")
    params, _ = T.init_lm_params(cfg, seed=0, device=dev)
    tokens = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab_size, (1, PROMPT + STEPS))).to(dev)
    state = T.init_lm_state(cfg, 1, PROMPT + STEPS, device=dev)
    token, position = torch.zeros((1, 1), dtype=torch.int64, device=dev), torch.zeros((), dtype=torch.int64, device=dev)
    # captured on the empty state, whose warm-up writes the prefill overwrites
    decode = capture_async(lambda: T.lm_decode_inplace(cfg, params, state, token, position), dev)
    last = T.lm_prefill_inplace(cfg, params, state, tokens=tokens[:, :PROMPT])
    steps = [last]
    for t in range(PROMPT, PROMPT + STEPS):
        token.copy_(tokens[:, t:t + 1])
        position.fill_(t)
        steps.append(decode().clone())
    got = torch.cat(steps)                                                  # [1 + STEPS, vocab]
    torch.cuda.synchronize()
    ref = R.forward(cfg, params, tokens[0], rows=range(PROMPT - 1, PROMPT + STEPS))
    err = rel(got, ref)
    agree = float((got.argmax(-1) == ref.argmax(-1)).float().mean())
    print(f"kimi-linear ONE_CARD f32: max|got - ref| / max|ref| = {err:.3e} over {got.shape[0]} rows; "
          f"argmax agreement {agree:.3f}; max|ref| {float(ref.abs().max()):.4f}")
    assert torch.isfinite(got).all()
    assert err < MODEL_TOL
    # the tolerance sees TF32: the prefill's last logits with TF32 on
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
    low = T.lm_prefill_inplace(cfg, params, T.init_lm_state(cfg, 1, PROMPT, device=dev), tokens=tokens[:, :PROMPT])
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    err_tf32 = rel(low, ref[:1])
    print(f"kimi-linear ONE_CARD with TF32 on: {err_tf32:.3e} of max|ref| at the prefill's last token")
    assert err_tf32 > MODEL_TOL


@pytest.mark.cuda
def test_kda_site_at_the_cells_widths_matches_the_recurrence(card):
    from portbench import reference_kda
    from repro_torch.autotune import kda_chunk_site

    dev = card
    site = kda_chunk_site(b=2, s=8192, h=32, dk=128, dv=128, device=dev)
    inputs = site.make_inputs(5)
    want_o, want_s = reference_kda.recurrence(*inputs)
    for name, thunk in site.workloads(seed=5).items():   # each one CUDA graph
        o, s = thunk()
        eo, es = rel(o, want_o), rel(s, want_s)
        print(f"kda_chunk {name} at 2 x 8192, 32 heads of 128: out {eo:.3e}, state {es:.3e}")
        assert eo < CORE_TOL and es < CORE_TOL, name

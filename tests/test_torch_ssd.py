"""The port's SSD chunk scan (``repro_torch.kernels.ssd``) and Mamba-2 scans
(``repro_torch.models.mamba2``) against the JAX package's, on numpy-made
inputs at the shapes of ``tests/test_kernels.py`` and
``tests/test_models.py``. On the CPU the kernel's wrapper takes its plain
version (the sequential scan); the JAX Pallas kernel runs in interpret mode.
Tolerance: the reference's f32 3e-4 (2e-4 for the state-carry case)."""

import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.ssd.ops import ssd_mix as jax_ssd_mix  # noqa: E402
from repro.kernels.ssd.ref import ssd_scan_ref as jax_scan_ref  # noqa: E402
from repro.models.mamba2 import ssd_chunked as jax_ssd_chunked  # noqa: E402
from repro_torch.autotune import ssd_chunk_site  # noqa: E402
from repro_torch.kernels.ssd import ssd as smod  # noqa: E402
from repro_torch.kernels.ssd.ops import ssd_mix  # noqa: E402
from repro_torch.kernels.ssd.ref import ssd_scan_ref  # noqa: E402
from repro_torch.models.mamba2 import _segsum_decay, ssd_chunked, ssd_reference  # noqa: E402


def _mixer_inputs(b, s, h, p, n, g, seed, a_shift=0.0, dt_shift=0.0):
    """x, dt = softplus(N(0,1) + dt_shift), a_log = N(0, 0.5^2) + a_shift, B, C
    (the reference tests' distributions at shift 0), as float32 numpy."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, h, p))
    dt = np.logaddexp(0.0, rng.standard_normal((b, s, h)) + dt_shift)
    a_log = rng.standard_normal(h) * 0.5 + a_shift
    bm = rng.standard_normal((b, s, g, n))
    cm = rng.standard_normal((b, s, g, n))
    return [a.astype(np.float32) for a in (x, dt, a_log, bm, cm)]


def _pair(arrays):
    return [jnp.asarray(a) for a in arrays], [torch.from_numpy(a) for a in arrays]


def _close(out, expect, tol):
    np.testing.assert_allclose(out.float().numpy(), np.asarray(expect, np.float32),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("use_kernel", [True, False])
@pytest.mark.parametrize("chunk", [32, 64, 128])
def test_ssd_mix_parity_sweep(chunk, use_kernel):
    """test_ssd_kernel_sweep's shapes: both port routes against the JAX
    kernel (interpret) and the JAX plain route."""
    jx, tx = _pair(_mixer_inputs(2, 128, 4, 32, 16, 1, seed=chunk))
    out = ssd_mix(*tx, chunk=chunk, use_kernel=use_kernel)
    assert out.dtype == torch.float32 and tuple(out.shape) == (2, 128, 4, 32)
    _close(out, jax_ssd_mix(*jx, chunk=chunk, use_kernel=True, interpret=True), 3e-4)
    _close(out, jax_ssd_mix(*jx, use_kernel=False), 3e-4)


@pytest.mark.parametrize("use_kernel", [True, False])
def test_ssd_mix_groups_parity(use_kernel):
    """test_ssd_kernel_groups: g = 2 groups broadcast to 4 heads."""
    jx, tx = _pair(_mixer_inputs(1, 64, 4, 16, 8, 2, seed=1))
    out = ssd_mix(*tx, chunk=32, use_kernel=use_kernel)
    _close(out, jax_ssd_mix(*jx, chunk=32, use_kernel=True, interpret=True), 3e-4)
    _close(out, jax_ssd_mix(*jx, use_kernel=False), 3e-4)


def test_ssd_scan_ref_parity_with_state():
    """The plain version on the head-flattened layout, y and final state."""
    rng = np.random.default_rng(2)
    bh, s, p, n = 4, 64, 16, 8
    xbar = rng.standard_normal((bh, s, p)).astype(np.float32)
    logda = -np.abs(rng.standard_normal((bh, s))).astype(np.float32)
    bm = rng.standard_normal((bh, s, n)).astype(np.float32)
    cm = rng.standard_normal((bh, s, n)).astype(np.float32)
    init = rng.standard_normal((bh, p, n)).astype(np.float32)
    jx, tx = _pair([xbar, logda, bm, cm, init])
    y, st = ssd_scan_ref(*tx)
    jy, jst = jax_scan_ref(*jx)
    _close(y, jy, 3e-4)
    _close(st, jst, 3e-4)


@pytest.mark.parametrize("chunk", [8, 16, 64])
def test_ssd_chunked_equals_sequential_and_jax(chunk):
    """test_ssd_chunked_equals_sequential's shapes, plus the JAX function."""
    jx, tx = _pair(_mixer_inputs(2, 64, 2, 8, 4, 1, seed=3))
    y_ref, st_ref = ssd_reference(*tx)
    y, st = ssd_chunked(*tx, chunk)
    _close(y, y_ref.numpy(), 3e-4)
    _close(st, st_ref.numpy(), 3e-4)
    jy, jst = jax_ssd_chunked(*jx, chunk)
    _close(y, jy, 3e-4)
    _close(st, jst, 3e-4)


def test_ssd_chunked_groups_equals_sequential():
    _, tx = _pair(_mixer_inputs(1, 64, 4, 8, 4, 2, seed=4))
    y_ref, st_ref = ssd_reference(*tx)
    y, st = ssd_chunked(*tx, 16)
    _close(y, y_ref.numpy(), 3e-4)
    _close(st, st_ref.numpy(), 3e-4)


@pytest.mark.parametrize("chunk", [256, 512])
def test_ssd_chunked_long_chunks_hold_the_tolerance(chunk):
    """The ssd_chunk site's longest chunks at its default widths (b 2,
    s 2048, h 8, p 32, n 32): |cum| reaches hundreds within a chunk, and an
    f32 cum would carry ulp(|cum|) into every decay, as far as the 3e-4
    tolerance at chunk 512. The port takes cum and its differences in f64."""
    _, tx = _pair(_mixer_inputs(2, 2048, 8, 32, 32, 1, seed=2))
    y_ref, st_ref = ssd_reference(*tx)
    y, st = ssd_chunked(*tx, chunk)
    _close(y, y_ref.numpy(), 3e-4)
    _close(st, st_ref.numpy(), 3e-4)


def test_ssd_state_carry_composes():
    """Two halves with the carried state == one full run (test_models.py:213)."""
    _, (x, dt, a_log, bm, cm) = _pair(_mixer_inputs(1, 32, 2, 8, 4, 1, seed=5))
    y_full, st_full = ssd_reference(x, dt, a_log, bm, cm)
    y1, st1 = ssd_reference(x[:, :16], dt[:, :16], a_log, bm[:, :16], cm[:, :16])
    y2, st2 = ssd_reference(x[:, 16:], dt[:, 16:], a_log, bm[:, 16:], cm[:, 16:], init_state=st1)
    _close(torch.cat([y1, y2], dim=1), y_full.numpy(), 2e-4)
    _close(st2, st_full.numpy(), 2e-4)
    y2c, st2c = ssd_chunked(x[:, 16:], dt[:, 16:], a_log, bm[:, 16:], cm[:, 16:], 8,
                            init_state=st1)
    _close(y2c, y2.numpy(), 2e-4)
    _close(st2c, st2.numpy(), 2e-4)


def test_decay_overflow_above_the_diagonal_stays_finite():
    """|A| * dt about 20 per token: cum_i - cum_j above the diagonal reaches
    thousands and exp overflows to inf. Every route stays finite and equals
    the JAX kernel's output."""
    arrays = _mixer_inputs(1, 128, 2, 16, 8, 1, seed=6, a_shift=2.0, dt_shift=2.0)
    jx, tx = _pair(arrays)
    logda = -np.exp(arrays[2]) * arrays[1]
    assert float(-logda.mean()) > 15.0
    decay = _segsum_decay(torch.from_numpy(logda).reshape(1, 1, 128, 2))
    assert bool(torch.isfinite(decay).all())
    expect = jax_ssd_mix(*jx, chunk=128, use_kernel=True, interpret=True)
    assert np.isfinite(np.asarray(expect)).all()
    for out in (ssd_mix(*tx, chunk=128), ssd_mix(*tx, use_kernel=False),
                ssd_chunked(*tx, 128)[0]):
        assert bool(torch.isfinite(out).all())
        _close(out, expect, 3e-4)


def test_model_layout_equals_head_flattened_layout():
    """The kernel's two layouts are one function (B/C groups read in place
    equal B/C repeated to heads)."""
    _, (x, dt, a_log, bm, cm) = _pair(_mixer_inputs(1, 64, 4, 16, 8, 2, seed=7))
    logda = dt * -torch.exp(a_log)
    xbar = x * dt[..., None]
    y4 = smod.ssd_scan_kernel(xbar, logda, bm, cm, chunk=32)
    y3 = smod.ssd_scan_kernel(*smod.heads_flat(xbar, logda, bm, cm), chunk=32)
    assert torch.equal(y4, y3.reshape(1, 4, 64, 16).transpose(1, 2))


def test_cpu_tensors_take_the_plain_version():
    xbar, logda = torch.randn(2, 64, 16), -torch.rand(2, 64)
    bm, cm = torch.randn(2, 64, 8), torch.randn(2, 64, 8)
    before = smod.ssd_scan_kernel.launches
    out = smod.ssd_scan_kernel(xbar, logda, bm, cm, chunk=32)
    assert torch.equal(out, ssd_scan_ref(xbar, logda, bm, cm)[0])
    assert smod.ssd_scan_kernel.launches == before


@pytest.mark.parametrize(
    "p,n,s,chunk",
    [(24, 8, 64, 32),      # head dim 24 not instantiated
     (16, 256, 64, 32),    # state dim above 128
     (16, 8, 96, 64),      # seq % chunk
     (128, 128, 8192, 8192)],  # chunk above the kernel's longest (shared memory)
)
def test_wrapper_rejects_what_the_kernel_does_not_take(p, n, s, chunk):
    xbar, logda = torch.randn(1, s, p), -torch.rand(1, s)
    bm = torch.randn(1, s, n)
    with pytest.raises(ValueError):
        smod.ssd_scan_kernel(xbar, logda, bm, bm.clone(), chunk=chunk)


def test_tensors_off_the_cpu_and_off_cuda_raise():
    xbar, logda, bm = (torch.empty(shape, device="meta") for shape in ((1, 64, 16), (1, 64), (1, 64, 8)))
    with pytest.raises(ValueError, match="CUDA"):
        smod.ssd_scan_kernel(xbar, logda, bm, bm)


def test_cuda_request_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ssd_chunk_site()  # device="cuda" by default


def test_kernel_source_instantiates_exactly_the_head_dims():
    src = smod.SOURCE.read_text()
    dims = {int(x) for x in re.findall(r"^\s*REPRO_HEAD_DIM\((\d+)\)\s*$", src, re.M)}
    assert dims == set(smod.HEAD_DIMS)
    assert "ssd.py:72" in src  # names the TPU kernel it replaces
    assert f"kMaxN = {smod.MAX_STATE};" in src and f"kMaxChunk = {smod.MAX_CHUNK};" in src
    assert f"kMaxP = {max(smod.HEAD_DIMS)};" in src  # the shared-memory static_assert's p


# ------------------------------------- the kernel's split and its faults ----

def _tf32(x, guard=True):
    """cvt.rna.tf32.f32's rounding as csrc/ssd.cu writes it out: add 2^12 to
    the bits and clear the 13 below the 10-bit mantissa; with the guard
    (to_tf32, hi's rounding) an x whose exponent is all ones (inf, NaN)
    passes as it is, without it (round_tf32, lo's) the canonical NaN that
    x - hi then is comes out -0."""
    bits = x.view(torch.int32)
    rounded = (bits + 0x1000) & -0x2000
    if guard:
        rounded = torch.where((bits & 0x7F800000) == 0x7F800000, bits, rounded)
    else:
        rounded = torch.where(torch.isnan(x), torch.full_like(bits, -0x80000000), rounded)
    return rounded.view(torch.float32)


def _products(a, b, terms):
    """a @ b in f32 with each operand split into hi = rna(x), lo = rna(x - hi):
    3 terms are the kernel's a_lo b_hi + a_hi b_lo + a_hi b_hi, 1 term the
    single TF32 product."""
    a_hi, b_hi = _tf32(a), _tf32(b)
    if terms == 1:
        return a_hi @ b_hi
    return a_hi @ b_hi + a_hi @ _tf32(b - b_hi, False) + _tf32(a - a_hi, False) @ b_hi


def _split_scan(xbar, logda, bm, cm, chunk, terms):
    """csrc/ssd.cu's passes for one head, written in torch: cum in f64, the
    scores C B^T, the chunk states (a), their passing (b) and the chunk scan
    (c), every product as `terms` TF32 products and every exp in f32 of an
    f64 exponent."""
    s, p = xbar.shape
    y = torch.empty_like(xbar)
    state = torch.zeros(p, bm.shape[1])
    for c0 in range(0, s, chunk):
        x, b, c = xbar[c0:c0 + chunk], bm[c0:c0 + chunk], cm[c0:c0 + chunk]
        cum = torch.cumsum(logda[c0:c0 + chunk].double(), 0)
        diff = cum[:, None] - cum[None, :]
        lower = torch.ones(chunk, chunk, dtype=torch.bool).tril()
        # exp kept only where i >= j (above the diagonal it may be inf)
        decay = torch.where(lower, torch.exp(diff.float()), torch.zeros(()))
        scores = _products(c, b.T, terms)
        y_inter = torch.exp(cum.float())[:, None] * _products(c, state.T, terms)
        y[c0:c0 + chunk] = y_inter + _products(scores * decay, x, terms)
        w = torch.exp((cum[-1] - cum).float())
        s_chunk = _products((x * w[:, None]).T.contiguous(), b, terms)
        state = torch.exp(cum[-1].float()) * state + s_chunk
    return y


def test_split_algebra_holds_the_tolerance_only_as_3xtf32():
    """Passes (a)-(c) with their products as the tensor cores take them, at
    b 1, s 1024, h 4, p 64, n 128, chunk 256 (seed 2), against an f64
    sequential scan: 3xTF32 uses under 0.2 of 3e-4 * (1 + |y|), one TF32
    product at least 10 times all of it (the planted fault 'lo forced to 0'
    of chip_smoke.py)."""
    arrays = _mixer_inputs(1, 1024, 4, 64, 128, 1, seed=2)
    x, dt, a_log, bm, cm = (torch.from_numpy(a) for a in arrays)
    xbar, logda = x * dt[..., None], dt * -torch.exp(a_log)
    shares = {1: 0.0, 3: 0.0}
    for head in range(4):
        xs, ls, bs, cs = xbar[0, :, head], logda[0, :, head], bm[0, :, 0], cm[0, :, 0]
        state = torch.zeros(64, 128, dtype=torch.float64)
        ref = torch.empty(1024, 64, dtype=torch.float64)
        for t in range(1024):
            state = state * torch.exp(ls[t].double()) + xs[t].double()[:, None] * bs[t].double()
            ref[t] = state @ cs[t].double()
        for terms in shares:
            out = _split_scan(xs, ls, bs, cs, 256, terms).double()
            share = float(((out - ref).abs() / (3e-4 * (1 + ref.abs()))).max())
            shares[terms] = max(shares[terms], share)
    assert shares[3] < 0.2, shares
    assert shares[1] > 10.0, shares


@pytest.mark.parametrize("pattern", [0x7FC00000, 0x7FFFFFFF, 0xFFFFFFFF, 0x7F800000, 0xFF800000])
def test_guarded_split_keeps_a_nan_a_nan(pattern):
    """ssd.cu's copy of the guarded split: a NaN (host-made, CUDA's
    canonical one, its negative) stays NaN in hi and in a 3xTF32 product,
    an inf stays inf in hi; a C with one NaN makes that row of C B^T NaN and
    no other."""
    x = torch.tensor([pattern & 0xFFFFFFFF], dtype=torch.int64).to(torch.int32).view(torch.float32)
    hi = _tf32(x)
    assert torch.equal(hi.view(torch.int32), x.view(torch.int32))
    c = torch.randn(8, 16, generator=torch.Generator().manual_seed(0))
    b = torch.randn(8, 16, generator=torch.Generator().manual_seed(1))
    c[3, 5] = x[0]
    scores = _products(c, b.T.contiguous(), 3)
    if torch.isnan(x).all():
        assert torch.equal(scores.isnan().any(1), torch.arange(8) == 3)
    else:
        assert not torch.isfinite(scores[3]).all() and torch.isfinite(scores[torch.arange(8) != 3]).all()


def test_kernel_to_tf32_carries_the_nan_guard():
    """ssd.cu's to_tf32 passes an x whose exponent is all ones as it is,
    before the rounding add, in the text chip_smoke.py's TF32_GUARD names."""
    src = smod.SOURCE.read_text()
    body = re.search(r"uint32_t to_tf32\(float x\) \{(.*?)\n\}", src, re.S).group(1)
    assert "if (!(fabsf(x) < __uint_as_float(0x7f800000u))) return bits;" in body
    assert body.index("return bits;") < body.index("return round_tf32(x);")
    assert src.count(_chip_smoke().TF32_GUARD) == 1


def _chip_smoke():
    """``chip_smoke.py`` as a module (it imports torch only inside main)."""
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke_for_ssd_tests", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("index", range(5))
def test_planted_ssd_faults_edit_the_source_exactly_once(index):
    """Every planted SSD fault of chip_smoke.py's phase 9 names a text that
    occurs exactly once in ssd.cu (a rewrite that loses one fails here, not
    on the card), and the required ones are the four the power check needs."""
    faults = _chip_smoke().SSD_FAULTS
    assert [name for name, _, _, must in faults if must] == [
        "lo forced to 0 (1xTF32)", "state passing without its chunk decay",
        "chunk scan reads the state after its own chunk", "diagonal left out of L (i > j)"]
    name, old, new, _ = faults[index]
    src = smod.SOURCE.read_text()
    assert src.count(old) == 1, name
    assert new != old and src.replace(old, new).count(new) >= 1


def test_pass_bits_follow_the_source():
    """Bit k of the library's `passes` mask launches PASSES[k] (the per-pass
    timing of chip_smoke.py relies on it)."""
    src = smod.SOURCE.read_text()
    launched = re.findall(r"if \(passes & (\d+)\) \{.*?ssd_(\w+?)_kernel", src, re.S)
    assert [(int(bit), name) for bit, name in launched] == [
        (1 << k, name) for k, name in enumerate(smod.PASSES)]
    assert smod.ALL_PASSES == 31


def test_kernel_flops_are_the_datas_not_per_head_scores():
    """C B^T once per (batch, chunk, group): the flops the kernel issues at
    mamba2-1.3b (its tiling, chip_smoke.ssd_kernel_flops) lie within 10 % of
    the data's 2.61e10 (the diagonal blocks are computed whole), far from
    the 4.31e10 of scores per head."""
    smoke = _chip_smoke()
    src = smod.SOURCE.read_text()
    assert f"kTile = {smoke.SSD_TILE};" in src and f"kKT = {smoke.SSD_KT};" in src
    b, s, h, p, n, g, chunk = smoke.MAMBA2
    data = b * s * (g * (chunk + 1) * n + h * ((chunk + 1) * p + 4.0 * p * n))
    per_head_scores = b * s * h * ((chunk + 1) * (n + p) + 4.0 * p * n)
    kernel = smoke.ssd_kernel_flops(*smoke.MAMBA2)
    assert abs(data - 2.607e10) < 0.01e10 and abs(per_head_scores - 4.305e10) < 0.01e10
    assert data <= kernel < 1.1 * data

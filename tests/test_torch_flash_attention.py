"""The port's flash attention (``repro_torch.kernels.flash_attention``)
against the JAX package's, on numpy-made inputs. On the CPU the kernel's
wrapper takes its plain version (the CUDA kernel runs only on the card,
where ``chip_smoke.py`` holds it against the same plain version). The JAX
Pallas kernel runs in interpret mode. Tolerances are the reference's
(``tests/test_kernels.py``): f32 2e-3, bf16 3e-2."""

import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash_attention.flash_attention import (  # noqa: E402
    flash_attention_kernel as jax_kernel,
)
from repro.kernels.flash_attention.ops import flash_attention as jax_ops  # noqa: E402
from repro.kernels.flash_attention.ref import flash_attention_ref as jax_ref  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention as fmod  # noqa: E402
from repro_torch.kernels.flash_attention.ops import flash_attention  # noqa: E402
from repro_torch.kernels.flash_attention.ref import (  # noqa: E402
    flash_attention_plain,
    flash_attention_ref,
)

DTYPES = [(jnp.float32, torch.float32, 2e-3), (jnp.bfloat16, torch.bfloat16, 3e-2)]
# bh, sq, skv, d, causal, window, logit_cap, block_q, block_k
SWEEP = [  # the cases of test_flash_kernel_sweep
    (2, 256, 256, 64, True, None, None, 128, 128),
    (1, 128, 128, 128, False, None, None, 64, 128),
    (2, 128, 512, 64, True, None, None, 64, 128),    # decode-ish sq < skv
    (1, 256, 256, 64, True, 64, None, 64, 64),       # sliding window
    (1, 256, 256, 64, True, None, 50.0, 128, 64),    # gemma softcap
]
TRAPS = [  # where the TPU kernel and its oracle compute different functions
    (1, 128, 64, 32, True, None, None, 64, 64),      # causal, sq > skv: rows that see no key
    (1, 64, 128, 32, False, 32, None, 64, 64),       # window without causal, sq != skv
]


def _inputs(bh, sq, skv, d, seed, jdtype, tdtype):
    rng = np.random.default_rng(seed)
    arrays = [rng.standard_normal(shape).astype(np.float32)
              for shape in ((bh, sq, d), (bh, skv, d), (bh, skv, d))]
    return ([jnp.asarray(a).astype(jdtype) for a in arrays],
            [torch.from_numpy(a).to(tdtype) for a in arrays])


def _close(out, expect, tol):
    np.testing.assert_allclose(out.float().numpy(), np.asarray(expect, np.float32),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("jdtype,tdtype,tol", DTYPES)
@pytest.mark.parametrize("bh,sq,skv,d,causal,win,cap,bq,bk", SWEEP)
def test_oracle_parity_sweep(bh, sq, skv, d, causal, win, cap, bq, bk, jdtype, tdtype, tol):
    (jq, jk, jv), (q, k, v) = _inputs(bh, sq, skv, d, sq + skv + d, jdtype, tdtype)
    kw = dict(causal=causal, window=win, logit_cap=cap)
    out = flash_attention_ref(q, k, v, **kw)
    assert out.dtype == tdtype and tuple(out.shape) == (bh, sq, d)
    _close(out, jax_ref(jq, jk, jv, **kw), tol)


@pytest.mark.parametrize("jdtype,tdtype,tol", DTYPES)
@pytest.mark.parametrize("bh,sq,skv,d,causal,win,cap,bq,bk", SWEEP + TRAPS)
def test_plain_matches_the_tpu_kernel(bh, sq, skv, d, causal, win, cap, bq, bk, jdtype, tdtype, tol):
    """``flash_attention_plain`` is the function the Pallas kernel computes,
    the trap cases included."""
    (jq, jk, jv), (q, k, v) = _inputs(bh, sq, skv, d, sq + skv + d, jdtype, tdtype)
    kw = dict(causal=causal, window=win, logit_cap=cap)
    expect = jax_kernel(jq, jk, jv, block_q=bq, block_k=bk, interpret=True, **kw)
    out = flash_attention_plain(q, k, v, **kw)
    assert out.dtype == tdtype
    _close(out, expect, tol)
    # the wrapper takes the plain version for CPU tensors, and launches nothing
    before = fmod.flash_attention_kernel.launches
    wrapped = fmod.flash_attention_kernel(q, k, v, block_q=bq, block_k=bk, **kw)
    assert torch.equal(wrapped, out)
    assert fmod.flash_attention_kernel.launches == before


@pytest.mark.parametrize("bh,sq,skv,d,causal,win,cap,bq,bk", TRAPS)
def test_traps_the_oracle_differs_from_the_kernel(bh, sq, skv, d, causal, win, cap, bq, bk):
    """The two reference functions really differ here (by more than 0.1):
    the CUDA kernel is held against the kernel's function, not the oracle."""
    _, (q, k, v) = _inputs(bh, sq, skv, d, sq + skv + d, jnp.float32, torch.float32)
    kw = dict(causal=causal, window=win, logit_cap=cap)
    gap = (flash_attention_plain(q, k, v, **kw) - flash_attention_ref(q, k, v, **kw)).abs()
    assert float(gap.max()) > 0.1
    if sq > skv:  # causal: the first sq - skv rows see no key and are exactly 0
        assert torch.equal(flash_attention_plain(q, k, v, **kw)[:, : sq - skv],
                           torch.zeros(bh, sq - skv, d))


@pytest.mark.parametrize("use_kernel", [True, False])
@pytest.mark.parametrize("window,cap", [(None, None), (48, 30.0)])
def test_ops_gqa_parity(use_kernel, window, cap):
    """Model layout [b, s, h, d] with GQA (h = 4, kv = 2), as
    test_flash_ops_gqa_broadcast, against the JAX wrapper on the same route."""
    b, s, h, kv, d = 2, 128, 4, 2, 32
    rng = np.random.default_rng(1)
    arrays = [rng.standard_normal(shape).astype(np.float32)
              for shape in ((b, s, h, d), (b, s, kv, d), (b, s, kv, d))]
    kw = dict(window=window, logit_cap=cap, block_q=64, block_k=64, use_kernel=use_kernel)
    expect = jax_ops(*[jnp.asarray(a) for a in arrays], interpret=True, **kw)
    out = flash_attention(*[torch.from_numpy(a) for a in arrays], **kw)
    assert tuple(out.shape) == (b, s, h, d)
    _close(out, expect, 2e-3)


def test_model_layout_equals_head_flattened_layout():
    """The kernel's two layouts are one function: [b, s, h, d] with GQA
    equals [bh, s, d] on kv heads repeated with the mapping of jnp.repeat."""
    b, s, h, kv, d = 2, 64, 6, 2, 32
    q, k, v = torch.randn(b, s, h, d), torch.randn(b, s, kv, d), torch.randn(b, s, kv, d)
    out = fmod.flash_attention_kernel(q, k, v, window=20, logit_cap=40.0)
    for i in range(h):
        expect = flash_attention_plain(q[:, :, i], k[:, :, i // 3], v[:, :, i // 3],
                                       window=20, logit_cap=40.0)
        assert torch.allclose(out[:, :, i], expect, atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("block_q,block_k", [(128, 512), (64, 64), (4096, 4096)])
def test_blocks_clamp_to_the_sequence(block_q, block_k):
    q, k, v = torch.randn(1, 64, 32), torch.randn(1, 64, 32), torch.randn(1, 64, 32)
    out = fmod.flash_attention_kernel(q, k, v, block_q=block_q, block_k=block_k)
    assert torch.equal(out, flash_attention_plain(q, k, v))


@pytest.mark.parametrize(
    "q,k,block_q,block_k",
    [
        (torch.randn(1, 96, 32), torch.randn(1, 96, 32), 64, 64),     # 96 % 64
        (torch.randn(1, 64, 32), torch.randn(1, 96, 32), 64, 64),     # skv % block_k
        (torch.randn(1, 64, 16), torch.randn(1, 64, 16), 64, 64),     # head dim 16
        (torch.randn(1, 64, 32), torch.randn(2, 64, 32), 64, 64),     # bh mismatch
        (torch.randn(2, 64, 3, 32), torch.randn(2, 64, 2, 32), 64, 64),  # h % kv
        (torch.randn(1, 64, 32).half(), torch.randn(1, 64, 32).half(), 64, 64),  # f16
    ],
)
def test_wrapper_rejects_what_the_kernel_does_not_take(q, k, block_q, block_k):
    with pytest.raises(ValueError):
        fmod.flash_attention_kernel(q, k, k.clone(), block_q=block_q, block_k=block_k)


def test_tensors_off_the_cpu_and_off_cuda_raise():
    q = torch.empty(1, 64, 32, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        fmod.flash_attention_kernel(q, q, q)


def test_kernel_source_instantiates_exactly_the_head_dims():
    src = fmod.SOURCE.read_text()
    dims = {int(x) for x in re.findall(r"^\s*REPRO_HEAD_DIM\((\d+)\)\s*$", src, re.M)}
    assert dims == set(fmod.HEAD_DIMS)
    assert "flash_attention.py:103" in src  # names the TPU kernel it replaces


def _chip_smoke():
    """``chip_smoke.py`` as a module (it imports torch only inside main)."""
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke_for_tests", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("index", range(5))
def test_planted_faults_edit_the_source_exactly_once(index):
    """Every planted fault of chip_smoke.py's phase 8 names a text that
    occurs exactly once in flash_attention.cu (a rewrite that loses one
    fails here, not on the card), and the required ones are the four the
    power check needs."""
    faults = _chip_smoke().FLASH_FAULTS
    assert len(faults) == 5
    assert [name for name, _, _, must in faults if must] == [
        "last live kv tile skipped", "first live kv tile skipped from query row 2048 on",
        "rows from 512 on written as 0", "O not rescaled by alpha"]
    name, old, new, _ = faults[index]
    if old is None:
        assert new is None
        return
    src = fmod.SOURCE.read_text()
    assert src.count(old) == 1, name
    assert new != old and src.replace(old, new).count(new) >= 1


def test_kernel_name_reads_the_mangled_instantiations():
    smoke = _chip_smoke()

    def n(x):
        return f"{len(x)}{x}"

    ns = n("_GLOBAL__N__8a3b2c11_18_flash_attention_cu_5e6f7a81")
    assert smoke.kernel_name(f"_ZN{ns}{n('flash_bf16_kernel')}ILi128EEEvK14CUtensorMap_stS2_S2_"
                             "P13__nv_bfloat16NS_6ParamsE") == "flash_bf16_kernel<Li128E>"
    assert smoke.kernel_name(f"_ZN{ns}{n('flash_f32_kernel')}ILi32EEEvPKfS2_S2_PfNS_6ParamsE") \
        == "flash_f32_kernel<Li32E>"
    assert smoke.kernel_name("not_mangled") == "not_mangled"


def test_tma_check_refuses_a_misaligned_base():
    """A contiguous bf16 view at an odd storage offset starts 2 bytes past a
    16-byte boundary: TMA cannot take it, and nothing copies it to fit."""
    base = torch.zeros(8 + 2 * 64 * 4 * 32, dtype=torch.bfloat16)
    view = base[1:-7].view(2, 64, 4, 32)
    assert view.is_contiguous() and view.storage_offset() == 1
    with pytest.raises(ValueError, match="16-byte-aligned"):
        fmod.check_tma_layout(view.shape, view.stride(), view.data_ptr(), view.element_size())
    assert base.data_ptr() % 16 == 0
    aligned = base[8:].view(2, 64, 4, 32)  # 16 bytes in
    fmod.check_tma_layout(aligned.shape, aligned.stride(), aligned.data_ptr(), aligned.element_size())


@pytest.mark.parametrize(
    "shape,strides,ok",
    [
        ((2, 64, 4, 32), (8192, 128, 32, 1), True),    # contiguous [b, s, h, d]
        ((1, 64, 1, 32), (7, 32, 3, 1), True),         # extents of 1: their strides are free
        ((2, 64, 4, 32), (8192, 129, 32, 1), False),   # s stride 258 bytes
        ((2, 64, 4, 32), (8192, 128, 33, 1), False),   # h stride 66 bytes
        ((2, 64, 4, 32), (8192, 128, 32, 2), False),   # d not contiguous
    ],
)
def test_tma_check_strides(shape, strides, ok):
    if ok:
        fmod.check_tma_layout(shape, strides, 1024, 2)
    else:
        with pytest.raises(ValueError):
            fmod.check_tma_layout(shape, strides, 1024, 2)


def test_strides_of_unit_extents_are_canonical():
    """An extent of 1 may carry any stride in a contiguous torch tensor (a
    TMA map would refuse 7 elements); the kernel gets the stride a
    contiguous tensor would have."""
    q = torch.zeros(3, 64, 32).unsqueeze(2)           # [b, s, 1, d]
    assert fmod._strides(q) == (64 * 32, 32, 32)      # b, h, s
    odd = torch.empty_strided((1, 64, 1, 32), (5, 32, 7, 1))
    assert odd.is_contiguous()
    assert fmod._strides(odd) == (64 * 32, 32, 32)
    fmod.check_tma_layout(odd.shape, odd.stride(), 1024, 2)


# ---------------------------------------------- the f32 kernel's design ----

def _split_trunc(x):
    """flash_attention.cu's split_tf32: hi = x with its 13 low mantissa bits
    cleared, lo = x - hi exactly (float32)."""
    x = np.asarray(x, np.float32)
    hi = (x.view(np.uint32) & np.uint32(0xFFFFE000)).view(np.float32)
    with np.errstate(invalid="ignore"):
        return hi, x - hi


def _read(x):
    """An operand as the tensor core reads it: its 13 low bits ignored."""
    return (np.asarray(x, np.float32).view(np.uint32) & np.uint32(0xFFFFE000)).view(np.float32)


def _product(a, b, terms):
    """a @ b as the kernel's mma.sync steps compute it, in float64 after
    the tensor core's operand read: 3 terms a_lo b_hi + a_hi b_lo + a_hi b_hi,
    1 term a_hi b_hi."""
    (a_hi, a_lo), (b_hi, b_lo) = _split_trunc(a), _split_trunc(b)
    a_hi, a_lo, b_hi, b_lo = (_read(x).astype(np.float64) for x in (a_hi, a_lo, b_hi, b_lo))
    if terms == 1:
        return a_hi @ b_hi
    return a_lo @ b_hi + a_hi @ b_lo + a_hi @ b_hi


def _causal_attention(q, k, v, qk_terms, pv_terms):
    """Causal attention with Q K^T and P V as the given TF32 products and
    the softmax in float64 (p rounded to float32, as the kernel holds it)."""
    s = _product(q, k.T, qk_terms) / np.sqrt(q.shape[1])
    s = np.where(np.tril(np.ones(s.shape, bool)), s, -np.inf)
    p = np.exp(s - s.max(1, keepdims=True))
    return _product(p.astype(np.float32), v, pv_terms) / p.sum(1, keepdims=True)


def test_3xtf32_attention_holds_the_f32_tolerance_and_1xtf32_qk_does_not():
    """The design's premise at s 512, d 128, q at 4x unit scale (chip_smoke's
    ops path), causal, against float64 attention: both products as the
    kernel's 3xTF32 use under 0.01 of 2e-3 * (1 + |o|); Q K^T as one TF32
    product uses more than all of it (the planted fault 'Q K^T at 1xTF32');
    P V as one TF32 product stays under it, which is why that fault is
    recorded, not required."""
    rng = np.random.default_rng(16)
    q = (rng.standard_normal((512, 128)) * 4).astype(np.float32)
    k, v = (rng.standard_normal((512, 128)).astype(np.float32) for _ in range(2))
    s = q.astype(np.float64) @ k.T.astype(np.float64) / np.sqrt(128)
    s = np.where(np.tril(np.ones(s.shape, bool)), s, -np.inf)
    p = np.exp(s - s.max(1, keepdims=True))
    exact = p @ v.astype(np.float64) / p.sum(1, keepdims=True)

    def share(qk, pv):
        out = _causal_attention(q, k, v, qk, pv)
        return float((np.abs(out - exact) / (2e-3 * (1 + np.abs(exact)))).max())

    assert share(3, 3) < 0.01
    assert share(1, 3) > 1.0
    assert 0.0 < share(3, 1) < 1.0


@pytest.mark.parametrize("pattern", [0x7FC00000, 0x7FFFFFFF, 0xFFFFFFFF, 0x7F800001, 0x7F800000, 0x7F7FF000])
def test_truncating_split_is_nan_safe(pattern):
    """The f32 kernel's split cannot carry into the exponent: every NaN
    (CUDA's canonical 0x7fffffff, its negative, one with only a low
    mantissa bit set, which the tensor core reads as inf) gives a NaN
    product through lo; an inf gives NaN as in gemm.cu; a finite value next
    to FLT_MAX stays finite (gemm.cu's rounding makes it inf)."""
    x = np.array([pattern], np.uint32).view(np.float32)
    hi, lo = _split_trunc(x)
    with np.errstate(invalid="ignore", over="ignore"):
        product = _product(x, np.float32([[0.75]]), 3)
    if np.isnan(x).all():
        assert np.isnan(lo).all() and np.isnan(product).all()
    elif np.isinf(x).all():
        assert (hi == x).all() and np.isnan(lo).all()
    else:
        assert np.isfinite(hi).all() and np.isfinite(lo).all() and hi + lo == x


def test_p_as_a_fragment_by_the_key_permutation():
    """O += P V with P taken from the S fragment in registers: lane 4g + t
    holds S's C elements (g, 2t), (g, 2t+1), (g+8, 2t), (g+8, 2t+1); the
    kernel passes them as A elements (g, t), (g+8, t), (g, t+4), (g+8, t+4)
    and reads B's rows t and t+4 from V's rows 2t and 2t+1. Rebuilt from
    those index maps, one m16n8k8 product is P V."""
    rng = np.random.default_rng(0)
    p, v = rng.standard_normal((16, 8)), rng.standard_normal((8, 8))
    a, b = np.full((16, 8), np.nan), np.full((8, 8), np.nan)
    for lane in range(32):
        g, t = lane >> 2, lane & 3
        c = [p[g, 2 * t], p[g, 2 * t + 1], p[g + 8, 2 * t], p[g + 8, 2 * t + 1]]
        # kernel: split_tf32(e4[0] -> [0], e4[2] -> [1], e4[1] -> [2], e4[3] -> [3])
        a[g, t], a[g + 8, t], a[g, t + 4], a[g + 8, t + 4] = c[0], c[2], c[1], c[3]
        # kernel: vb = vs + (8 n + 2 t) * P + 8 j + g; b0 = vb[0], b1 = vb[P]
        b[t, g], b[t + 4, g] = v[2 * t, g], v[2 * t + 1, g]
    np.testing.assert_allclose(a @ b, p @ v, rtol=1e-12, atol=1e-12)
    src = fmod.SOURCE.read_text()
    for text in ("split_tf32(e4[0], phi[n][0], plo[n][0]);", "split_tf32(e4[2], phi[n][1], plo[n][1]);",
                 "split_tf32(e4[1], phi[n][2], plo[n][2]);", "split_tf32(e4[3], phi[n][3], plo[n][3]);",
                 "const float* vb = vs + (8 * n + 2 * t) * P + 8 * j + g;",
                 "split_tf32(vb[0], vhi[0], vlo[0]);", "split_tf32(vb[P], vhi[1], vlo[1]);"):
        assert src.count(text) == 1, text


@pytest.mark.parametrize("index", range(4))
def test_planted_f32_faults_edit_the_source_exactly_once(index):
    """Every planted fault of the f32 power check names a text that occurs
    exactly once in flash_attention.cu, and the required ones are the three
    the f32 power check needs (P V at 1xTF32 is recorded)."""
    faults = _chip_smoke().FLASH_F32_FAULTS
    assert [name for name, _, _, must in faults if must] == [
        "Q K^T at 1xTF32", "last live kv tile skipped", "O not rescaled by alpha"]
    assert [name for name, _, _, must in faults if not must] == ["P V at 1xTF32"]
    name, old, new, _ = faults[index]
    src = fmod.SOURCE.read_text()
    assert src.count(old) == 1, name
    assert new != old and src.replace(old, new).count(old) == 0


def test_f32_kernel_is_instantiated_for_exactly_the_head_dims():
    """Each head dim of REPRO_HEAD_DIM (== HEAD_DIMS) launches the f32
    kernel through launch_f32<D>, and its shared memory (128 query rows and
    two stages of 32-key K and V tiles, rows padded to D + 4 floats) fits a
    CTA."""
    src = fmod.SOURCE.read_text()
    assert "if (dtype == kF32) return launch_f32<D>(q, k, v, o, b, p, s);" in src
    dims = {int(x) for x in re.findall(r"^\s*REPRO_HEAD_DIM\((\d+)\)\s*$", src, re.M)}
    assert dims == set(fmod.HEAD_DIMS)
    assert "constexpr int kF32Rows = 128;" in src and "constexpr int kF32Keys = 32;" in src
    assert "constexpr int kF32Stages = 2;" in src
    for d in fmod.HEAD_DIMS:
        assert 4 * (128 * (d + 4) + 2 * 2 * 32 * (d + 4)) <= 227 * 1024, d


def test_f32_copy_alignment_check():
    """The f32 kernel's 16-byte copies need a 16-byte-aligned base; a
    contiguous view one float into its storage is refused, nothing copied."""
    fmod.check_copy_alignment(1024)
    with pytest.raises(ValueError, match="16-byte-aligned"):
        fmod.check_copy_alignment(1028)


def test_launch_counters_reset_per_dtype():
    fmod.flash_attention_kernel.launches_by_dtype["float32"] += 1
    fmod.reset_counts()
    assert fmod.flash_attention_kernel.launches == 0
    assert fmod.flash_attention_kernel.launches_by_dtype == {"float32": 0, "bfloat16": 0}

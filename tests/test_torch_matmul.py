"""The port's GEMM (``repro_torch.kernels.matmul``) against the JAX package's
Pallas GEMM in interpret mode, on numpy-made inputs. On the CPU the port's
wrappers take the plain version (the CUDA kernel runs only on the card,
where ``chip_smoke.py`` holds it against the same plain version).
Tolerances are the reference's: f32 2e-4 and bf16 2e-2 for one product,
5e-4 for a chain (``tests/test_kernels.py``)."""

import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.expressions import generate_chain_algorithms  # noqa: E402
from repro.kernels.matmul.ops import chain_matmul as ref_chain_matmul  # noqa: E402
from repro.kernels.matmul.ops import matmul as ref_matmul  # noqa: E402
from repro_torch.autotune import matmul_blocks_site  # noqa: E402
from repro_torch.expressions import inputs_from_reference  # noqa: E402
from repro_torch.kernels.build import NVCC_FLAGS  # noqa: E402
from repro_torch.kernels.matmul import matmul as kmod  # noqa: E402
from repro_torch.kernels.matmul.ops import chain_matmul, matmul  # noqa: E402
from repro_torch.kernels.matmul.ref import matmul_ref  # noqa: E402


def _pair(m, k, n, seed, dtype=jnp.float32):
    rng = np.random.default_rng(seed)
    a = jnp.asarray(rng.standard_normal((m, k)) / np.sqrt(k), jnp.float32).astype(dtype)
    b = jnp.asarray(rng.standard_normal((k, n)) / np.sqrt(k), jnp.float32).astype(dtype)
    return a, b


@pytest.mark.parametrize("dtype,tol", [(jnp.float32, 2e-4), (jnp.bfloat16, 2e-2)])
@pytest.mark.parametrize(
    "m,k,n,bm,bn,bk",
    [  # the shapes and reference tiles of test_matmul_kernel_sweep
        (256, 256, 256, 128, 128, 128),
        (300, 200, 450, 128, 128, 128),
        (64, 512, 128, 256, 256, 512),
        (128, 128, 1024, 128, 256, 128),
    ],
)
def test_matmul_parity_sweep(m, k, n, bm, bn, bk, dtype, tol):
    a, b = _pair(m, k, n, seed=m + n, dtype=dtype)
    expect = ref_matmul(a, b, block_m=bm, block_n=bn, block_k=bk, interpret=True)
    ta, tb = inputs_from_reference([np.asarray(a), np.asarray(b)], device="cpu")
    out = matmul(ta, tb)
    assert out.dtype == ta.dtype and tuple(out.shape) == (m, n)
    np.testing.assert_allclose(out.float().numpy(), np.asarray(expect, np.float32),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("i,j,k_", [(1, 1, 1), (2, 3, 1), (3, 2, 3)])
def test_matmul_parity_irregular_shapes(i, j, k_):
    """The 17i x 23j x 13k property shapes at 16-tiles, f32 2e-4."""
    m, k, n = 17 * i, 23 * j, 13 * k_
    a, b = _pair(m, k, n, seed=100 * i + 10 * j + k_)
    expect = ref_matmul(a, b, block_m=16, block_n=16, block_k=16, interpret=True)
    ta, tb = inputs_from_reference([np.asarray(a), np.asarray(b)], device="cpu")
    out = matmul(ta, tb, block_m=16, block_n=16, block_k=16)
    np.testing.assert_allclose(out.numpy(), np.asarray(expect), rtol=2e-4, atol=2e-4)


def test_chain_matmul_parity():
    """The paper's six algorithms of dims (24,16,4,20,12), 5e-4."""
    dims = (24, 16, 4, 20, 12)
    rng = np.random.default_rng(2)
    arrays = [(rng.standard_normal((dims[i], dims[i + 1])) / np.sqrt(dims[i + 1]))
              .astype(np.float32) for i in range(4)]
    mats = inputs_from_reference(arrays, device="cpu")
    for alg in generate_chain_algorithms(dims):
        expect = ref_chain_matmul(alg, [jnp.asarray(x) for x in arrays], interpret=True,
                                  block_m=16, block_n=16, block_k=16)
        out = chain_matmul(alg, mats, block_m=16, block_n=16, block_k=16)
        np.testing.assert_allclose(out.numpy(), np.asarray(expect), rtol=5e-4, atol=5e-4,
                                   err_msg=alg.name)


@pytest.mark.parametrize("tile", kmod.SUPPORTED_TILES)
@pytest.mark.parametrize("out_dtype", [None, torch.float32, torch.bfloat16])
def test_cpu_tensors_take_the_plain_version(tile, out_dtype):
    a, b = torch.randn(33, 47), torch.randn(47, 21)
    before = kmod.KERNEL.launches
    out = kmod.matmul_kernel(a, b, block_m=tile[0], block_n=tile[1], block_k=tile[2],
                             out_dtype=out_dtype)
    assert torch.equal(out, matmul_ref(a, b, out_dtype))
    assert out.dtype == (out_dtype or torch.float32)
    assert kmod.KERNEL.launches == before  # the plain version is no launch


@pytest.mark.parametrize("tile", [(128, 128, 128), (256, 256, 512), (256, 256, 256),
                                  (512, 512, 256), (64, 64, 32)])
def test_unsupported_tile_raises(tile):
    a, b = torch.randn(8, 8), torch.randn(8, 8)
    with pytest.raises(ValueError, match="unsupported GEMM tile"):
        matmul(a, b, block_m=tile[0], block_n=tile[1], block_k=tile[2])
    with pytest.raises(ValueError, match="unsupported GEMM tile"):
        matmul_blocks_site(8, 8, 8, blocks=(tile,), device="cpu")


def test_use_kernel_false_is_the_plain_version_for_any_tile():
    a, b = torch.randn(9, 7), torch.randn(7, 5)
    out = matmul(a, b, block_m=256, block_n=256, block_k=512, use_kernel=False)
    assert torch.equal(out, matmul_ref(a, b))


@pytest.mark.parametrize(
    "a,b",
    [
        (torch.randn(4, 5), torch.randn(6, 3)),                       # k mismatch
        (torch.randn(4, 5), torch.randn(5, 3, dtype=torch.bfloat16)),  # mixed dtypes
        (torch.randn(4, 5).half(), torch.randn(5, 3).half()),         # f16
        (torch.randn(2, 4, 5), torch.randn(5, 3)),                    # batched
    ],
)
def test_wrapper_rejects_what_the_kernel_does_not_take(a, b):
    with pytest.raises(ValueError):
        matmul(a, b)


def _tile_table(src):
    """``csrc/gemm.cu``'s ``Tile<BM, BN, BK>`` lines: warps along M and N and
    stages of the ring, per tile."""
    rows = re.findall(r"struct Tile<(\d+), (\d+), (\d+)> \{ static constexpr int "
                      r"kWarpsM = (\d+), kWarpsN = (\d+), kStages = (\d+); \};", src)
    return {tuple(int(x) for x in r[:3]): tuple(int(x) for x in r[3:]) for r in rows}


def test_kernel_source_instantiates_exactly_the_supported_tiles():
    src = kmod.SOURCE.read_text()
    tiles = {tuple(int(x) for x in t)
             for t in re.findall(r"^\s*REPRO_TILE\((\d+), (\d+), (\d+)\)\s*$", src, re.M)}
    assert tiles == set(kmod.SUPPORTED_TILES)
    assert kmod.DEFAULT_TILE in kmod.SUPPORTED_TILES
    assert "-gencode=arch=compute_90a,code=sm_90a" in NVCC_FLAGS
    table = _tile_table(src)
    assert set(table) == set(kmod.SUPPORTED_TILES)
    # the design: 1 warp at 16^3, 4 at 32^3 and 64^3, 8 at the 128 x 128 tiles
    assert {t: wm * wn for t, (wm, wn, _) in table.items()} == {
        (16, 16, 16): 1, (32, 32, 32): 4, (64, 64, 64): 4, (128, 128, 8): 8, (128, 128, 16): 8}
    for (bm, bn, bk), (wm, wn, stages) in table.items():
        # each warp owns whole 16 x 16 blocks of m16 x n8 fragments
        assert bm % (16 * wm) == 0 and bn % (16 * wn) == 0 and bk % 8 == 0
        assert stages >= 2
        # the ring fits a block's 227 KB of dynamic shared memory, in both
        # input types (the kernel's row pitches: f32 A + 4, B + 8 floats;
        # bf16 rows an odd number of 16-byte lines)
        f32_stage = 4 * (bm * (bk + 4) + bk * (bn + 8))
        bf16_stage = 2 * (bm * (bk if (bk // 8) % 2 else bk + 8) + bk * (bn + 8))
        assert stages * max(f32_stage, bf16_stage) <= 227 * 1024


def test_chain_matmul_use_kernel_false_matches_torch_matmul():
    dims = (10, 7, 5, 9)
    mats = [torch.randn(dims[i], dims[i + 1]) for i in range(3)]
    for alg in generate_chain_algorithms(dims):
        out = chain_matmul(alg, mats, use_kernel=False)
        env = {f"M{i}": m for i, m in enumerate(mats)}
        for dest, lhs, rhs in alg.steps:
            env[dest] = env[lhs] @ env[rhs]
        assert torch.equal(out, env[alg.steps[-1][0]])


# ------------------------------------------------ 3xTF32, on the CPU ----

def _tf32(x, guard=True):
    """``cvt.rna.tf32.f32`` (and the kernel's ``to_tf32``): to nearest, ties
    away from zero, at 10 mantissa bits; the 13 bits below cleared. With
    the guard an x whose exponent is all ones (inf, NaN) passes as it is;
    ``guard=False`` is the split before the guard."""
    bits = np.asarray(x, np.float32).view(np.uint32)
    rounded = (bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)
    if guard:
        rounded = np.where(bits & np.uint32(0x7F800000) == np.uint32(0x7F800000), bits, rounded)
    return rounded.astype(np.uint32).view(np.float32)


def _split(x, guard=True):
    """The kernel's split_tf32: hi = rna(x) (with the guard), lo = rna(x - hi)
    (without it: for an inf or NaN x, x - hi is NaN and lo comes out 0)."""
    x = np.asarray(x, np.float32)
    hi = _tf32(x, guard)
    with np.errstate(invalid="ignore"):
        lo = np.where(np.isnan(x - hi), np.float32(0.0), _tf32(x - hi, guard=False))
    return hi, lo.astype(np.float32)


def _read(x):
    """An operand as the tensor core reads it: its 13 low bits ignored."""
    return (np.asarray(x, np.float32).view(np.uint32) & np.uint32(0xFFFFE000)).view(np.float32)


def _tf32_products(a, b):
    """The kernel's products, summed in f64: 3xTF32 (a_lo*b_hi + a_hi*b_lo +
    a_hi*b_hi) and the two planted faults' arithmetic, 1xTF32 (lo = 0) and
    one cross term dropped."""
    a_hi, b_hi = _tf32(a), _tf32(b)
    a_lo, b_lo = _tf32(a - a_hi), _tf32(b - b_hi)

    def dot(x, y):
        return x.astype(np.float64) @ y.astype(np.float64)

    return {
        "3xTF32": dot(a_lo, b_hi) + dot(a_hi, b_lo) + dot(a_hi, b_hi),
        "1xTF32": dot(a_hi, b_hi),
        "cross term dropped": dot(a_lo, b_hi) + dot(a_hi, b_hi),
    }


@pytest.mark.parametrize("m,k,n", [(256, 256, 256), (300, 200, 450), (64, 512, 128),
                                   (128, 128, 1024), (497, 854, 338)])
def test_3xtf32_meets_the_f32_tolerance_and_its_faults_do_not(m, k, n):
    """The design's premise on chip_smoke's inputs (a / sqrt(k), b unit):
    3xTF32 is within 2e-4 * (1 + |p|) of the f32 product by far, one TF32
    product and a dropped cross term are not (so the planted faults of
    chip_smoke's phase 3 are visible to its f32 comparison)."""
    rng = np.random.default_rng(m + n)
    a = (rng.standard_normal((m, k)) / np.sqrt(k)).astype(np.float32)
    b = rng.standard_normal((k, n)).astype(np.float32)
    exact = a.astype(np.float64) @ b.astype(np.float64)
    share = {name: float((np.abs(p - exact) / (2e-4 * (1 + np.abs(exact)))).max())
             for name, p in _tf32_products(a, b).items()}
    assert share["3xTF32"] < 0.01, share
    assert share["1xTF32"] > 2 and share["cross term dropped"] > 2, share


def test_tf32_rounding_splits_exactly():
    """hi and lo are TF32 values (13 low bits clear), hi + lo is x to within
    2^-22 |x|, and ties round away from zero."""
    x = np.random.default_rng(0).standard_normal(10_000).astype(np.float32)
    hi = _tf32(x)
    lo = _tf32(x - hi)
    for part in (hi, lo):
        assert not (part.view(np.uint32) & np.uint32(0x1FFF)).any()
    assert np.all(np.abs((hi.astype(np.float64) + lo) - x) <= 2.0 ** -22 * np.abs(x))
    tie = np.array([1 + 2.0 ** -11, -(1 + 2.0 ** -11)], np.float32)
    assert list(_tf32(tie)) == [1 + 2.0 ** -10, -(1 + 2.0 ** -10)]


# The split's NaN guard. Bit patterns: torch's host-made NaN, CUDA's
# canonical NaN (what 0/0 gives on the device) and its negative, +-inf, and
# a finite value within 2^-11 of FLT_MAX.
SPECIAL = {"0x7fc00000": 0x7FC00000, "0x7fffffff": 0x7FFFFFFF, "0xffffffff": 0xFFFFFFFF,
           "+inf": 0x7F800000, "-inf": 0xFF800000, "0x7f7ff000": 0x7F7FF000}


def _bits(pattern):
    return np.array([pattern], np.uint32).view(np.float32)


@pytest.mark.parametrize("name", list(SPECIAL))
def test_guarded_split_keeps_a_nan_a_nan(name):
    """Through the guarded split a NaN gives hi = x and lo = 0, so it stays
    NaN in hi + lo and in a 3xTF32 product as the tensor core reads it (13
    low bits ignored); without the guard CUDA's canonical NaN splits to
    hi = lo = -0 or +0 and vanishes. An inf gives hi = inf and lo = 0 (a
    product with an exactly TF32 operand, whose lo is 0, is then NaN: the
    divergence gemm.cu's note accepts); 0x7f7ff000 rounds hi to inf and lo
    to -inf, recorded here as it is."""
    x = _bits(SPECIAL[name])
    hi, lo = _split(x)
    with np.errstate(invalid="ignore", over="ignore"):
        whole = hi.astype(np.float64) + lo
        b = np.float32(0.75)
        product = _read(lo) * np.float64(b) + _read(hi) * 0.0 + _read(hi) * np.float64(b)
    if np.isnan(x).all():
        assert np.isnan(whole).all() and np.isnan(product).all()
        hi_u, lo_u = _split(x, guard=False)
        vanished = SPECIAL[name] in (0x7FFFFFFF, 0xFFFFFFFF)
        assert (hi_u == 0).all() == vanished and (lo_u == 0).all()
    elif np.isinf(x).all():
        assert (hi == x).all() and (lo == 0).all() and np.isnan(product).all()
    else:  # within 2^-11 of FLT_MAX
        assert np.isposinf(hi).all() and np.isneginf(lo).all() and np.isnan(whole).all()


def test_guarded_split_equals_the_unguarded_one_on_finite_values():
    """The guard changes nothing for a finite x below 0x7f7ff000, so the
    3xTF32 accuracy tests above hold for the guarded kernel unchanged."""
    x = np.random.default_rng(1).standard_normal(100_000).astype(np.float32) * 1e3
    x = np.concatenate([x, _bits(0x7F7FEFFF), _bits(0x00000001), np.float32([0.0, -0.0])])
    for guard in (True, False):
        assert np.array_equal(_split(x, guard)[0].view(np.uint32), _split(x)[0].view(np.uint32))
        assert np.array_equal(_split(x, guard)[1].view(np.uint32), _split(x)[1].view(np.uint32))


def test_kernel_to_tf32_carries_the_nan_guard():
    """gemm.cu's to_tf32 passes an x whose exponent is all ones as it is,
    before the rounding add, and chip_smoke.py's TF32_GUARD names that line
    (the build without it that phases 3 and 4 measure)."""
    src = kmod.SOURCE.read_text()
    body = re.search(r"uint32_t to_tf32\(float x\) \{(.*?)\n\}", src, re.S).group(1)
    assert "if (!(fabsf(x) < __uint_as_float(0x7f800000u))) return bits;" in body
    assert body.index("return bits;") < body.index("return round_tf32(x);")
    assert src.count(_chip_smoke().TF32_GUARD) == 1


# ------------------------------------------------------ copy widths ----

def _widths(m, k, n, dtype=torch.float32):
    a, b = torch.empty(m, k, dtype=dtype), torch.empty(k, n, dtype=dtype)
    c = torch.empty(m, n, dtype=dtype)
    return kmod.copy_bytes(a, b, c), [kmod.copy_bytes(t) for t in (a, b, c)]


@pytest.mark.parametrize("m,k,n", [(1000, 1000, 1000), (1024, 1024, 1024), (128, 128, 128),
                                   (4096, 4096, 4096), (256, 128, 1024)])
def test_copy_bytes_is_16_where_every_row_is_16_byte_aligned(m, k, n):
    assert _widths(m, k, n) == (16, [16, 16, 16])


@pytest.mark.parametrize("m,k,n,which", [
    (497, 854, 338, [4, 4, 4]),    # anomaly_331's first product: rows of 3416, 1352 bytes
    (497, 338, 331, [4, 4, 4]),    # ... 331 and 279 f32 wide further on
    (497, 331, 279, [4, 4, 4]),
    (75, 75, 75, [4, 4, 4]),       # fig3_75: rows of 300 bytes
    (75, 8, 75, [16, 4, 4]),       # k = 8: only A's rows are aligned
    (17, 23, 13, [4, 4, 4]),       # the property shapes 17i x 23j x 13k
    (34, 46, 26, [4, 4, 4]),
    (51, 69, 39, [4, 4, 4]),
    (300, 200, 450, [16, 4, 4]),   # chip_smoke's sweep: b and c 450 wide
])
def test_copy_bytes_is_4_where_a_row_is_not(m, k, n, which):
    assert _widths(m, k, n) == (4, which)


def test_copy_bytes_reads_the_base_address_too():
    """A contiguous view one element into its storage starts 4 bytes past
    a 16-byte boundary: 4-byte copies, whatever its rows."""
    storage = torch.empty(1 + 64 * 64)
    view = storage[1:].view(64, 64)
    assert kmod.copy_bytes(storage[:64 * 64].view(64, 64)) == 16
    assert kmod.copy_bytes(view) == 4
    assert kmod.copy_bytes(torch.empty(64, 64, dtype=torch.bfloat16)) == 16
    assert kmod.copy_bytes(torch.empty(64, 60, dtype=torch.bfloat16)) == 4  # 120-byte rows


# ------------------------------------------------------- copy modes ----

#: the first chain of gemm-chain-rank's pool (dims U[1000, 2000])
POOL_FIRST_CHAIN = (1851, 1637, 1511, 1270, 1308)


def _modes_of_chain(dims):
    """copy_mode of every GEMM of every algorithm of the chain ``dims``, on
    fresh f32 CPU tensors (as the card's allocator hands them out, each base
    on a 16-byte boundary)."""
    from repro_torch.expressions import generate_chain_algorithms as port_algorithms
    from repro_torch.expressions.algorithms import execute_steps

    modes = []

    def gemm(a, b):
        c = torch.empty(a.shape[0], b.shape[1])
        modes.append(kmod.copy_mode(a, b, c))
        return c

    mats = [torch.empty(dims[i], dims[i + 1]) for i in range(len(dims) - 1)]
    for alg in port_algorithms(dims):
        execute_steps(alg.steps, {f"M{i}": m for i, m in enumerate(mats)}, gemm)
    return modes


@pytest.mark.parametrize("dims", [POOL_FIRST_CHAIN, (497, 854, 338, 331, 279), (75, 75, 75, 75, 75)],
                         ids=["pool_first_chain", "anomaly_331", "fig3_75"])
def test_copy_mode_shifts_every_unaligned_f32_gemm_of_a_chain(dims):
    """The pool's first chain, anomaly_331's widths and fig3_75: every GEMM
    of every algorithm has a row stride off a 16-byte boundary, and every
    one takes the shifted mode, none 4-byte copies."""
    modes = _modes_of_chain(dims)
    assert len(modes) == 18 and set(modes) == {kmod.SHIFT}


@pytest.mark.parametrize("m,k,n", [(1000, 1000, 1000), (1024, 1024, 1024), (4096, 4096, 4096),
                                   (256, 128, 1024), (1000, 1024, 1000)])
def test_copy_mode_keeps_aligned_shapes_at_16(m, k, n):
    a, b, c = torch.empty(m, k), torch.empty(k, n), torch.empty(m, n)
    assert kmod.copy_mode(a, b, c) == 16


@pytest.mark.parametrize("m,k,n", [(1851, 1637, 1511), (497, 854, 338), (75, 8, 75),
                                   (300, 200, 450), (17, 23, 13), (1000, 1000, 1022)])
def test_copy_mode_shifts_f32_rows_off_a_boundary(m, k, n):
    a, b, c = torch.empty(m, k), torch.empty(k, n), torch.empty(m, n)
    assert kmod.copy_bytes(a, b, c) == 4 and kmod.copy_mode(a, b, c) == kmod.SHIFT


def test_copy_mode_keeps_a_base_off_a_boundary_at_4():
    """A view one element into a storage that starts on a boundary: its row 0
    would need the bytes before it, so 4-byte copies, as copy_bytes says;
    whichever operand it is. A base 4 elements in is on a boundary again."""
    storage = torch.empty(4 + 64 * 65)
    off = storage[1:1 + 64 * 65].view(64, 65)
    on = storage[4:4 + 64 * 65].view(64, 65)
    b, c = torch.empty(65, 64), torch.empty(64, 64)
    assert kmod.copy_mode(off, b, c) == 4
    assert kmod.copy_mode(torch.empty(64, 64), off, torch.empty(64, 65)) == 4
    assert kmod.copy_mode(on, b, c) == kmod.SHIFT
    # C is stored element by element outside mode 16: its base does not matter
    assert kmod.copy_mode(on, b, storage[1:1 + 64 * 64].view(64, 64)) == kmod.SHIFT


@pytest.mark.parametrize("m,k,n", [(64, 64, 64), (64, 60, 64), (1851, 1637, 1511), (497, 854, 338),
                                   (17, 23, 13)])
def test_copy_mode_leaves_bf16_as_copy_bytes_has_it(m, k, n):
    """bf16 has no shifted mode (ldmatrix wants its shared rows on 16-byte
    boundaries): 16 or 4, as copy_bytes gives."""
    a, b = torch.empty(m, k, dtype=torch.bfloat16), torch.empty(k, n, dtype=torch.bfloat16)
    for c in (torch.empty(m, n, dtype=torch.bfloat16), torch.empty(m, n)):
        assert kmod.copy_mode(a, b, c) == kmod.copy_bytes(a, b, c)


def test_copy_modes_are_the_launch_counters_keys():
    assert kmod.COPY_WIDTHS == (16, kmod.SHIFT, 4)
    assert set(kmod.KERNEL.launches_by) == set(kmod.COPY_WIDTHS)


# The shifted loader (gemm.cu's load_tile_shifted and the fragment shifts),
# emulated in numpy on a flat f32 memory whose element 0 is on a 16-byte
# boundary: an address is an element index, a 16-byte chunk four of them.

def _tile_geometry(tile, operand):
    """(rows, cols, pitch, threads) of one stage's A or B tile, as
    gemm.cu's Layout gives them for f32."""
    bm, bn, bk = tile
    wm, wn, _ = _tile_table(kmod.SOURCE.read_text())[tile]
    threads = 32 * wm * wn
    return (bm, bk, bk + 4, threads) if operand == "A" else (bk, bn, bn + 8, threads)


def _shifted_copies(rows, cols, threads, base, ld, r0, c0, rmax, cmax):
    """The chunks load_tile_shifted issues: (source, column in the stage
    row, elements read, stage row), per thread in the kernel's order. A row
    off a boundary has one chunk more: the thread in chunk column q copies
    it for the q-th of its rows."""
    per_row, step = cols // 4, threads // (cols // 4)
    sweeps = -(-rows // step)
    width = min(cmax - c0, cols)
    copies = []
    for tid in range(threads):
        q, r = tid % per_row, tid // per_row
        c = 4 * q
        row = base + (r0 + r) * ld + c0
        sh = row % 4
        n = min(max(sh + width - c, 0), 4)
        src = row - sh + c
        mine = r + q * step
        if sh > 0 and q < sweeps and mine < rows:
            valid = max(sh + width - cols, 0) if r0 + mine < rmax else 0
            copies.append((src + q * step * ld + cols - c if valid else base, cols, valid, mine))
        for _ in range(sweeps):
            if r < rows:
                valid = n if r0 + r < rmax else 0
                copies.append((src if valid else base, c, valid, r))
            r += step
            src += step * ld
    return copies


def _emulate(tile, operand, ld_mod, offset, last):
    """One stage of the operand's tile through the shifted loader: the
    memory, the stage, the copies and the origin. The operand is R x ld,
    contiguous (ld = its width, ld % 4 = ld_mod), ``offset`` elements into
    its storage; ``last`` takes the last tile along both axes (ragged)."""
    rows, cols, pitch, threads = _tile_geometry(tile, operand)
    ld, height = 2 * cols + 4 + ld_mod, 2 * rows + 3  # the last tiles are ragged
    mem = np.full(offset + height * ld + 8, np.nan, np.float32)
    view = np.random.default_rng(ld * 7 + offset + rows).standard_normal((height, ld)).astype(np.float32)
    mem[offset:offset + height * ld] = view.ravel()
    r0 = (height // rows) * rows if last else 0
    c0 = (ld // cols) * cols if last else 0
    copies = _shifted_copies(rows, cols, threads, offset, ld, r0, c0, height, ld)
    stage = np.full(rows * pitch, np.nan, np.float32)
    for src, col, valid, r in copies:
        dst = r * pitch + col
        stage[dst:dst + 4] = 0.0
        stage[dst:dst + valid] = mem[src:src + valid]
    return dict(mem=mem, view=view, stage=stage.reshape(rows, pitch), copies=copies, rows=rows,
                cols=cols, pitch=pitch, threads=threads, ld=ld, r0=r0, c0=c0, offset=offset,
                height=height)


def _fragment_shifts(e, tile, operand):
    """Each fragment row's shift as the kernel's threads compute it, once
    before the loop: A's from row row0 + g, B's from row t (lane = 4 g + t)."""
    shifts = {}
    for lane in range(32):
        g, t = lane >> 2, lane & 3
        row = e["r0"] + g if operand == "A" else t
        shifts[lane] = (e["offset"] + row * e["ld"]) % 4
    return shifts


CASES = [(tile, operand, ld_mod, offset, last) for tile in kmod.SUPPORTED_TILES
         for operand in "AB" for ld_mod in range(4) for offset in (0, 4) for last in (False, True)]


@pytest.mark.parametrize("tile,operand,ld_mod,offset,last", CASES)
def test_shifted_loader_reads_the_tile_in_aligned_chunks_within_the_operand(tile, operand, ld_mod,
                                                                             offset, last):
    """Every chunk starts on a 16-byte boundary and lands on one; no element
    outside the operand is read (the head of row 0 is empty: its base is on
    a boundary); read back through the threads' shifts, the stage holds the
    tile's slice, zeros past the ragged edges; and each thread's fragment
    rows (A: g, g + 8 of every m16 block; B: t, t + 4 of every k8 step) have
    one shift, the one the thread computes."""
    e = _emulate(tile, operand, ld_mod, offset, last)
    lo, hi = e["offset"], e["offset"] + e["height"] * e["ld"]
    for src, col, valid, r in e["copies"]:
        assert src % 4 == 0 and (r * e["pitch"] + col) % 4 == 0
        assert valid == 0 or (lo <= src and src + valid <= hi), (src, valid)
    row_shift = [(e["offset"] + (e["r0"] + r) * e["ld"] + e["c0"]) % 4 for r in range(e["rows"])]
    for r in range(e["rows"]):
        want = np.zeros(e["cols"], np.float32)
        if e["r0"] + r < e["height"]:
            part = e["view"][e["r0"] + r, e["c0"]:e["c0"] + e["cols"]]
            want[:part.size] = part
        got = e["stage"][r, row_shift[r]:row_shift[r] + e["cols"]]
        np.testing.assert_array_equal(got, want, err_msg=f"row {r}")
    bm, bn, bk = tile
    wm, wn, _ = _tile_table(kmod.SOURCE.read_text())[tile]
    for lane, sh in _fragment_shifts(e, tile, operand).items():
        g, t = lane >> 2, lane & 3
        if operand == "A":
            rows = {w * (bm // wm) + 16 * i + g + 8 * h for w in range(wm)
                    for i in range(bm // wm // 16) for h in (0, 1)}
        else:
            rows = {kk + t + 4 * h for kk in range(0, bk, 8) for h in (0, 1)}
        assert {row_shift[r] for r in rows} == {sh}
        if ld_mod == 0:
            assert sh == 0  # aligned rows: the 16-byte path's reads


@pytest.mark.parametrize("tile", kmod.SUPPORTED_TILES)
@pytest.mark.parametrize("ld_mod", range(4))
def test_shifted_fragment_reads_take_at_most_two_wavefronts(tile, ld_mod):
    """What the shift costs the fragment reads: rows of differing shifts
    cannot tile the 32 banks, so one LDS of a warp meets at most 2 addresses
    on a bank (conflict free, 1, where every row is aligned)."""
    _, _, bk = tile
    worst = 1
    for operand in "AB":
        rows, cols, pitch, _ = _tile_geometry(tile, operand)
        for ld in (4 * 97 + ld_mod, 4 * 300 + ld_mod):
            sh = [(r * ld) % 4 for r in range(rows)]
            for kk in range(0, bk, 8):
                for hi in (0, 1):  # the fragment's first and second rows (A: + 8, B: + 4)
                    addrs = []
                    for lane in range(32):
                        g, t = lane >> 2, lane & 3
                        if operand == "A":
                            r, col = g + 8 * hi, kk + t
                        else:
                            r, col = kk + t + 4 * hi, g
                        addrs.append(r * pitch + sh[r] + col)
                    banks = {}
                    for x in set(addrs):
                        banks.setdefault(x % 32, set()).add(x)
                    worst = max(worst, max(len(v) for v in banks.values()))
    assert worst == (1 if ld_mod == 0 else 2)


def test_shifted_loader_needs_an_aligned_base():
    """A base one element past a boundary: row 0's first chunk would read
    the element before the operand, which is why copy_mode gives 4 there."""
    rows, cols, pitch, threads = _tile_geometry((64, 64, 64), "A")
    copies = _shifted_copies(rows, cols, threads, 5, 130, 0, 0, 70, 130)
    assert min(src for src, _, valid, _ in copies if valid) == 4 < 5


# ------------------------------------------------- planted faults ----

def _chip_smoke():
    """``chip_smoke.py`` as a module (it imports torch only inside main)."""
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke_for_gemm_tests", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("index", range(4))
def test_planted_gemm_faults_edit_the_source_exactly_once(index):
    """Every planted GEMM fault of chip_smoke.py's phase 3 names a text that
    occurs exactly once in gemm.cu (a rewrite that loses one fails here, not
    on the card): lo forced to 0, a cross term dropped, the last K stage
    skipped, A's row shift dropped (the shifted mode's own)."""
    faults = _chip_smoke().GEMM_FAULTS
    assert [name for name, _, _ in faults] == [
        "lo forced to 0 (1xTF32)", "cross term a_hi*b_lo dropped", "last K stage skipped",
        "A's row shift dropped"]
    assert _chip_smoke().SHIFT_ONLY_FAULTS == ("A's row shift dropped",)
    name, old, new = faults[index]
    src = kmod.SOURCE.read_text()
    assert src.count(old) == 1, name
    assert new != old and src.replace(old, new).count(new) >= 1

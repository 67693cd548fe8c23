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
    before = kmod.matmul_kernel.launches
    out = kmod.matmul_kernel(a, b, block_m=tile[0], block_n=tile[1], block_k=tile[2],
                             out_dtype=out_dtype)
    assert torch.equal(out, matmul_ref(a, b, out_dtype))
    assert out.dtype == (out_dtype or torch.float32)
    assert kmod.matmul_kernel.launches == before  # the plain version is no launch


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


def test_kernel_source_instantiates_exactly_the_supported_tiles():
    src = kmod.SOURCE.read_text()
    tiles = {tuple(int(x) for x in t)
             for t in re.findall(r"^\s*REPRO_TILE\((\d+), (\d+), (\d+)\)\s*$", src, re.M)}
    assert tiles == set(kmod.SUPPORTED_TILES)
    assert kmod.DEFAULT_TILE in kmod.SUPPORTED_TILES
    assert "-gencode=arch=compute_90a,code=sm_90a" in kmod.NVCC_FLAGS
    for bm, bn, bk in kmod.SUPPORTED_TILES:
        # 16 x 16 threads own the tile; the f32 stages fit static shared memory
        assert bm % 16 == 0 and bn % 16 == 0
        assert 4 * (bk * (bm + 4) + bk * bn) <= 48 * 1024


def test_chain_matmul_use_kernel_false_matches_torch_matmul():
    dims = (10, 7, 5, 9)
    mats = [torch.randn(dims[i], dims[i + 1]) for i in range(3)]
    for alg in generate_chain_algorithms(dims):
        out = chain_matmul(alg, mats, use_kernel=False)
        env = {f"M{i}": m for i, m in enumerate(mats)}
        for dest, lhs, rhs in alg.steps:
            env[dest] = env[lhs] @ env[rhs]
        assert torch.equal(out, env[alg.steps[-1][0]])

"""The hand GEMM's copy modes on the card: the shifted mode (16-byte copies
of f32 rows at any 4-byte alignment) against the 4-byte mode on the same
tensors, and the chain ranking's launches by mode. Skips without a CUDA
device; on the card: ``pytest -m cuda tests/test_torch_matmul_card.py``."""

import itertools

import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import (  # noqa: E402
    WallClockTimer,
    flops_discriminant_test,
    initial_hypothesis_by_time,
    measure_and_rank,
)
from repro_torch.expressions import (  # noqa: E402
    build_workloads,
    flops_table,
    generate_chain_algorithms,
    make_chain_inputs,
)
from repro_torch.kernels.matmul import matmul as kmod  # noqa: E402
from repro_torch.kernels.matmul import ops  # noqa: E402
from repro_torch.kernels.matmul.ref import matmul_ref  # noqa: E402

#: the first chain of gemm-chain-rank's pool (dims U[1000, 2000])
POOL_FIRST_CHAIN = (1851, 1637, 1511, 1270, 1308)
#: K tails: k below one BK, and one past a whole tile of 64
K_TAILS = (1, 3, 5, 8, 63, 65)


def needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the GEMM kernel runs only there")
    return torch.device("cuda", 0)


def _bits(x):
    return x.view(torch.int32 if x.dtype == torch.float32 else torch.int16)


@pytest.mark.cuda
@pytest.mark.parametrize("tile", kmod.SUPPORTED_TILES)
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
def test_shifted_mode_is_bitwise_the_4_byte_mode(tile, out_dtype):
    """For each row stride mod 4 of A (k), B (n) and C (its pitch), and each
    K tail, the shifted mode writes the bits the 4-byte mode writes, and
    both are within the f32 (or bf16) tolerance of the plain version."""
    dev = needs_card()
    gen = torch.Generator(device=dev).manual_seed(31)
    cases = [(37 + 8 * i, k, 40 + i, pad) for k, i, pad in itertools.product(
        K_TAILS + (130, 257), range(4), range(4))]  # n and the pitch n + pad at every residue mod 4
    tol = 2e-4 if out_dtype == torch.float32 else 2e-2
    for m, k, n, pad in cases:
        a = torch.randn(m, k, generator=gen, device=dev) / k ** 0.5
        b = torch.randn(k, n, generator=gen, device=dev)
        outs = {}
        for mode in (4, kmod.SHIFT):
            c = torch.full((m, n + pad), float("nan"), device=dev, dtype=out_dtype)[:, :n]
            kmod.launch(a, b, c, tile, mode)
            outs[mode] = c
        torch.cuda.synchronize()
        assert torch.equal(_bits(outs[4]), _bits(outs[kmod.SHIFT])), (tile, m, k, n, pad)
        ref = matmul_ref(a, b)
        err = ((outs[kmod.SHIFT].float() - ref).abs() / (tol * (1 + ref.abs()))).max()
        assert float(err) <= 1.0, (tile, m, k, n, pad, float(err))


@pytest.mark.cuda
def test_a_verdict_of_the_pools_first_chain_copies_no_f32_row_by_4_bytes():
    """One verdict of the pool's first chain on the hand GEMM (graphs,
    single runs, Procedure 4, the discriminant): every GEMM launch takes the
    shifted mode, none 4-byte copies."""
    dev = needs_card()
    dims = POOL_FIRST_CHAIN
    algs = generate_chain_algorithms(dims)
    mats = make_chain_inputs(dims, seed=3, device=dev)
    before = dict(kmod.KERNEL.launches_by)
    workloads = build_workloads(algs, mats, jit=True, gemm=ops.matmul)
    timer = WallClockTimer(workloads)
    single = {name: timer.measure(name) for name in workloads}
    result = measure_and_rank(initial_hypothesis_by_time(single), timer, max_measurements=6)
    flops_discriminant_test(result, flops_table(algs))
    torch.cuda.synchronize()
    counted = {mode: kmod.KERNEL.launches_by[mode] - before[mode] for mode in kmod.COPY_WIDTHS}
    assert counted[4] == 0 and counted[16] == 0 and counted[kmod.SHIFT] > 0, counted

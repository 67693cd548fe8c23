"""The port's chain algorithms (``repro_torch.expressions``) against the JAX
package's: identical enumeration and FLOP tables (exact), and every
algorithm's product on numpy-made inputs equal to the reference's
``reference_product`` within the reference's own tolerance (1e-4, f32)."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import repro.expressions as ref  # noqa: E402
import repro_torch.expressions as port  # noqa: E402

TOL = 1e-4  # repro.expressions.algorithms.verify_algorithms' rtol = atol


def _numpy_chain(dims, seed):
    rng = np.random.default_rng(seed)
    return [
        (rng.standard_normal((dims[i], dims[i + 1])) / np.sqrt(dims[i + 1])).astype(np.float32)
        for i in range(len(dims) - 1)
    ]


def _algs_as_dicts(algs):
    return [dataclasses.asdict(a) for a in algs]


@pytest.mark.parametrize("smoke", [False, True])
@pytest.mark.parametrize("name", sorted(ref.PAPER_INSTANCES))
def test_generate_and_flops_parity(name, smoke):
    r_inst = ref.get_instance(name, smoke=smoke)
    p_inst = port.get_instance(name, smoke=smoke)
    assert p_inst.dims == r_inst.dims
    r_algs, p_algs = r_inst.algorithms(), p_inst.algorithms()
    assert _algs_as_dicts(p_algs) == _algs_as_dicts(r_algs)
    assert port.flops_table(p_algs) == ref.flops_table(r_algs)
    assert min(port.flops_table(p_algs).values()) == port.dp_optimal_flops(p_inst.dims)


@pytest.mark.parametrize("seed", range(3))
def test_random_instance_parity(seed):
    r_inst = ref.random_instance(n_matrices=5, seed=seed)
    p_inst = port.random_instance(n_matrices=5, seed=seed)
    assert (p_inst.name, p_inst.dims) == (r_inst.name, r_inst.dims)
    assert _algs_as_dicts(p_inst.algorithms()) == _algs_as_dicts(r_inst.algorithms())


@pytest.mark.parametrize(
    "name,smoke",
    [(n, True) for n in sorted(ref.PAPER_INSTANCES)] + [("fig3_75", False), ("anomaly_331", False)],
)
def test_algorithms_match_reference_product(name, smoke):
    dims = ref.get_instance(name, smoke=smoke).dims
    arrays = _numpy_chain(dims, seed=3)
    expect = np.asarray(ref.reference_product([jnp.asarray(a) for a in arrays]), np.float64)
    mats = port.inputs_from_reference(arrays, device="cpu")
    for jit in (True, False):
        for alg in port.generate_chain_algorithms(dims):
            out = port.build_algorithm_fn(alg, mats, jit=jit)()
            np.testing.assert_allclose(out.double().numpy(), expect, rtol=TOL, atol=TOL,
                                       err_msg=alg.name)
    port.verify_algorithms(port.generate_chain_algorithms(dims), mats)


def test_build_workloads_feed_the_wallclock_timer():
    from repro_torch.core import WallClockTimer

    dims = port.SMOKE_INSTANCES["fig3_75"]
    algs = port.generate_chain_algorithms(dims)
    mats = port.make_chain_inputs(dims, device="cpu")
    workloads = port.build_workloads(algs, mats)
    assert list(workloads) == [a.name for a in algs]
    timer = WallClockTimer(workloads)
    assert all(timer.measure(a.name) > 0 for a in algs)
    assert set(timer.inner_repeats) == set(workloads)


def test_make_chain_inputs_is_seeded_and_scaled():
    dims = (40, 30, 20, 10)
    a = port.make_chain_inputs(dims, seed=5, device="cpu")
    b = port.make_chain_inputs(dims, seed=5, device="cpu")
    c = port.make_chain_inputs(dims, seed=6, device="cpu")
    assert [tuple(m.shape) for m in a] == [(40, 30), (30, 20), (20, 10)]
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not torch.equal(a[0], c[0])
    assert all(m.dtype == torch.float32 for m in a)
    # entries ~ N(0, 1/cols): the row norms concentrate near 1
    assert abs(float(a[0].pow(2).sum(1).mean()) - 1.0) < 0.2
    bf = port.make_chain_inputs(dims, dtype=torch.bfloat16, seed=5, device="cpu")
    assert torch.equal(bf[0], a[0].to(torch.bfloat16))


def test_inputs_from_reference_is_bit_exact():
    arrays = _numpy_chain((8, 6, 4), seed=1)
    f32 = port.inputs_from_reference(arrays, device="cpu")
    assert all(np.array_equal(t.numpy(), a) for t, a in zip(f32, arrays))
    bf = jnp.asarray(arrays[0]).astype(jnp.bfloat16)
    (t,) = port.inputs_from_reference([np.asarray(bf)], device="cpu")
    assert t.dtype == torch.bfloat16
    assert np.array_equal(t.float().numpy(), np.asarray(bf, np.float32))


def test_default_device_raises_without_cuda():
    """Entry points default to the card and never fall back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device: the default device is valid")
    from repro_torch.autotune import matmul_blocks_site

    with pytest.raises(RuntimeError, match="no CUDA device"):
        port.make_chain_inputs((4, 3, 2))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port.inputs_from_reference(_numpy_chain((4, 3, 2), 0))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        matmul_blocks_site(64, 64, 64)

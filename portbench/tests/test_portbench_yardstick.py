"""The frozen generators and formulas against the port's own at small sizes."""

import pytest
import torch

from portbench import formulas, generators, reference


@pytest.mark.parametrize("seed", [0, 1, 17, 123])
def test_chain_draw_and_flops_match_the_port(seed):
    from repro_torch.expressions import flops_table, make_chain_inputs, random_instance

    inst = random_instance(4, 20, 60, seed=seed)
    assert generators.chain_dims(4, 20, 60, seed) == inst.dims
    ours = {name: flops for name, flops, _ in formulas.chain_algorithms(inst.dims)}
    assert ours == flops_table(inst.algorithms())
    mats = make_chain_inputs(inst.dims, seed=seed, device="cpu")
    for a, b in zip(mats, generators.census_inputs(inst.dims, seed)):
        assert torch.equal(a, b)


def test_chain_gemms_and_bounds():
    algs = formulas.chain_algorithms((1000, 1000, 500, 1000, 1000))
    assert len(algs) == 6 and [a[0] for a in algs] == [f"algorithm{i}" for i in range(6)]
    for _, flops, gemms in algs:
        assert len(gemms) == 3 and flops == sum(2 * m * k * n for m, k, n in gemms)
    assert formulas.gemm_bound_s(4096, 4096, 4096) == 2 * 4096**3 / formulas.PEAK_TF32_FLOPS
    assert formulas.gemm_bound_s(1, 4096, 4096) == (4096 + 4096**2 + 4096) * 4 / 3.35e12


def test_ssd_flops_and_layout_match_the_site():
    from repro_torch.autotune.variants import ssd_chunk_site

    site = ssd_chunk_site(b=2, s=32, h=4, p=8, n=8, chunks=(8, 16), device="cpu")
    assert site.flops_table() == {f"chunk_{q}": formulas.ssd_chunk_flops(2, 32, 4, 8, 8, q)
                                  for q in (8, 16)}
    ours = generators.ssd_inputs(2, 32, 4, 8, 8, seed=5, device=torch.device("cpu"))
    assert [t.shape for t in ours] == [t.shape for t in site.make_inputs(5)]
    assert all(t.dtype == torch.float32 for t in ours) and bool((ours[1] > 0).all())


def test_rounds_give_every_seed_the_same_pool():
    for seed in (0, 2**40 + 3):
        it = generators.rounds(seed, 1, 5)
        for _ in range(3):
            assert sorted(next(it) for _ in range(5)) == list(range(5))
    assert generators.derive(-1, 2) == generators.derive(2**64 - 1, 2) < 2**63


def test_reference_scan_matches_the_model_path():
    from repro_torch.models.mamba2 import ssd_chunked

    x, dt, a_log, bm, cm = generators.ssd_inputs(2, 32, 4, 8, 8, 3, torch.device("cpu"))
    ref = reference.ssd_scan(x, dt, a_log, bm, cm)
    assert reference.rel_max_err(ssd_chunked(x, dt, a_log, bm, cm, 8)[0], ref) < 1e-5
    assert reference.rel_max_err(reference.ssd_scan_tf32(x, dt, a_log, bm, cm), ref) > 1e-4


def test_tf32_rounding_and_verdict_rule():
    x = torch.tensor([1.0 + 2**-11, 1.0 + 3 * 2**-11, -(1.0 + 2**-11), 3.0])
    assert reference.tf32(x).tolist() == [1.0, 1.0 + 2**-9, -1.0, 3.0]
    flops = {"a": 1.0, "b": 1.0, "c": 2.0}
    assert reference.verdict(flops, {"a": 1, "b": 1, "c": 2})["reason"] == "none"
    assert reference.verdict(flops, {"a": 2, "b": 2, "c": 1})["reason"] == "faster_outside_min_flops"
    assert reference.verdict(flops, {"a": 1, "b": 2, "c": 2})["reason"] == "min_flops_split"
    assert reference.verdict(flops, {"c": 1}) is None

"""The port's autotuner (``repro_torch.autotune``): the ``matmul_blocks``
site's plumbing on CPU tensors, and exact parity with the JAX package's
tuner on the deterministic cost-model backend."""

import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.autotune import tuner as ref_tuner  # noqa: E402
from repro_torch.autotune import (  # noqa: E402
    CampaignSite,
    TuneReport,
    matmul_blocks_site,
    rank_site,
    rank_site_costmodel,
    rank_sites,
)
from repro_torch.core import CostModelTimer  # noqa: E402
from repro_torch.kernels.matmul.matmul import SUPPORTED_TILES, matmul_kernel  # noqa: E402

CPU_TILES = ((16, 16, 16), (32, 32, 32))


def test_rank_site_on_cpu_site():
    site = matmul_blocks_site(64, 64, 64, blocks=CPU_TILES, device="cpu")
    before = matmul_kernel.launches
    # rt_threshold keeps every variant in the candidate set on a noisy CPU
    report = rank_site(site, max_measurements=6, rt_threshold=1e9)
    assert isinstance(report, TuneReport)
    names = {"blocks_16x16x16", "blocks_32x32x32", "torch_matmul"}
    assert set(report.discriminant.ranks) == names
    assert set(report.discriminant.relative_flops) == names
    assert set(report.discriminant.relative_flops.values()) == {0.0}
    assert report.selected in names and report.backend == "wall-clock"
    assert "FLOPs discriminant" in report.summary()
    assert matmul_kernel.launches == before  # CPU tensors take the plain version


def test_matmul_blocks_site_workloads_compute_the_product():
    site = matmul_blocks_site(24, 40, 16, blocks=CPU_TILES, device="cpu")
    assert site.flops_table() == {
        "blocks_16x16x16": 2.0 * 24 * 40 * 16,
        "blocks_32x32x32": 2.0 * 24 * 40 * 16,
        "torch_matmul": 2.0 * 24 * 40 * 16,
    }
    a, b = site.make_inputs(3)
    a2, _ = site.make_inputs(3)
    assert torch.equal(a, a2) and tuple(a.shape) == (24, 40) and tuple(b.shape) == (40, 16)
    expect = a @ b
    for name, thunk in site.workloads(seed=3).items():
        torch.testing.assert_close(thunk(), expect, rtol=1e-5, atol=1e-5, msg=name)


def test_matmul_blocks_site_default_tiles_are_supported():
    site = matmul_blocks_site(16, 16, 16, device="cpu")
    tiles = [v.meta["tiles"] for v in site.variants if "tiles" in v.meta]
    assert tiles and all(t in SUPPORTED_TILES for t in tiles)
    assert site.variants[-1].name == "torch_matmul"


def _costs(seed):
    rng = np.random.default_rng(seed)
    names = [f"v{i}" for i in range(5)]
    costs = {n: float(rng.uniform(1e-3, 1.3e-3)) for n in names}
    flops = {n: float(rng.choice([1e9, 1e9, 1.2e9])) for n in names}
    return costs, flops


def _report_dict(r):
    d = dataclasses.asdict(r)
    d.pop("wall_time_s")
    return d


@pytest.mark.parametrize("rel_sigma", [0.0, 0.05])
@pytest.mark.parametrize("seed", [0, 1])
def test_rank_site_costmodel_parity(seed, rel_sigma):
    costs, flops = _costs(seed)
    r_ref = ref_tuner.rank_site_costmodel("site", costs, flops, rel_sigma=rel_sigma)
    r_port = rank_site_costmodel("site", costs, flops, rel_sigma=rel_sigma)
    assert _report_dict(r_port) == _report_dict(r_ref)


def _sites(pkg_site, pkg_timer):
    out = []
    for seed in range(3):
        costs, flops = _costs(seed)
        out.append(pkg_site(name=f"site{seed}", timer=pkg_timer(costs, rel_sigma=0.05, seed=seed),
                            flops=flops, initial_order=sorted(costs), backend="cost-model"))
    return out


def test_rank_sites_campaign_parity_and_resume(tmp_path):
    from repro.core import CostModelTimer as RefCostModelTimer

    kw = dict(max_measurements=12, policy="least_converged_first")
    ref_path, port_path = str(tmp_path / "ref.json"), str(tmp_path / "port.json")
    r_ref = ref_tuner.rank_sites(_sites(ref_tuner.CampaignSite, RefCostModelTimer),
                                 save_path=ref_path, **kw)
    r_port = rank_sites(_sites(CampaignSite, CostModelTimer), save_path=port_path, **kw)
    assert {k: _report_dict(v) for k, v in r_port.items()} == \
        {k: _report_dict(v) for k, v in r_ref.items()}

    def strip_t(path):
        with open(path) as fh:
            d = json.load(fh)
        for s in d["sessions"]:
            s["meta"].pop("t_start")
        return d

    assert strip_t(port_path) == strip_t(ref_path)

    # killed after 4 iterations and resumed: the same reports as uninterrupted
    part = str(tmp_path / "part.json")
    rank_sites(_sites(CampaignSite, CostModelTimer), save_path=part, max_steps=4, **kw)
    resumed = rank_sites(resume_from=part)
    assert {k: _report_dict(v)["ranking"] for k, v in resumed.items()} == \
        {k: _report_dict(v)["ranking"] for k, v in r_port.items()}

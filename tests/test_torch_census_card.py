"""The census's draw-ahead on the card: a wall-clock shard of 3 chains at
dims U[3000, 6000] builds from device matrices bitwise equal to the serial
CPU draw, at least one instance's draw is finished when its build asks for
it, and no draw thread outlives ``run_shard``. Skips without a CUDA device;
on the card: ``pytest -m cuda tests/test_torch_census_card.py``."""

import threading

import pytest

torch = pytest.importorskip("torch")

import repro_torch.core.sweep as sweep  # noqa: E402
import repro_torch.expressions.algorithms as algorithms  # noqa: E402
from repro_torch.core.family import get_family  # noqa: E402


def needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the census draws ahead only for one")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_census_shard_builds_from_the_serial_draw_drawn_ahead(tmp_path, monkeypatch):
    dev = needs_card()
    from torch.profiler import ProfilerActivity, profile

    spec = sweep.SweepSpec(
        backend="wall_clock", n_shards=1, chunk_size=8, max_measurements=6,
        families={"chain": {"count": 3, "n_matrices": [4], "lo": 3000, "hi": 6000}})
    seeds = {tuple(get_family("chain").entry(i)[1]["dims"]): int(i.params["seed"])
             for i in spec.expand()}
    real_build, built = algorithms.build_workloads, []

    def build(algs, mats, **kw):
        assert all(m.device.type == "cuda" for m in mats)
        built.append([m.cpu() for m in mats])  # compared after the shard, not to slow the build
        return real_build(algs, mats, **kw)

    monkeypatch.setattr(algorithms, "build_workloads", build)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        store = sweep.run_shard(spec, str(tmp_path), 0, device=dev)
    assert not [t for t in threading.enumerate() if t.name.startswith("rt-draw")]
    names = [e.name() for e in prof.profiler.kineto_results.events()]
    ready, waited = names.count("rt.inputs.ready"), names.count("rt.inputs.waited")
    assert len(built) == 3
    for mats in built:
        dims = tuple([m.shape[0] for m in mats] + [mats[-1].shape[1]])
        want = algorithms.make_chain_inputs(dims, seed=seeds[dims], device="cpu")
        assert len(mats) == len(want) and all(torch.equal(m, w) for m, w in zip(mats, want))
    assert ready + waited == names.count("rt.inputs") == 3
    assert ready >= 1, (ready, waited)
    assert len(store.records) == 3

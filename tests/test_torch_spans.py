"""The program's ``rt.`` spans (``repro_torch/spans.py``).

On the CPU: one chain verdict and one ``rank_site`` under
``torch.profiler`` carry the ranking path's spans (and the chain its
input draw's), nested as the program runs them, one ``rt.rank.step`` a Procedure-4 iteration; every span is a
``cpu_op`` host event, never a user annotation (which the profiler
projects onto the device's timeline); with no profiler running a span is
a shared no-op that builds nothing.

On the card (marked ``cuda``, skipped without one): a captured graph
keeps the operands it reads when the caller drops them, and a capture is
one ``rt.graph.capture`` span with no ``rt.`` event on the device's side.
"""

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import core, spans
from repro_torch.autotune.tuner import rank_site
from repro_torch.autotune.variants import ssd_chunk_site
from repro_torch.expressions import (
    build_workloads,
    generate_chain_algorithms,
    make_chain_inputs,
)

RANKING_SPANS = {"rt.build", "rt.measure", "rt.rank.step", "rt.rank.update"}
#: spans a path opens besides the ranking's: the chain draws its matrices
INPUT_SPANS = {"chain": {"rt.inputs"}, "site": set()}


def chain_verdict(device="cpu"):
    dims = (24, 40, 16, 32, 20)
    built = build_workloads(generate_chain_algorithms(dims),
                            make_chain_inputs(dims, seed=3, device=device))
    timer = core.WallClockTimer(built)
    single = {name: timer.measure(name) for name in built}
    return core.measure_and_rank(core.initial_hypothesis_by_time(single), timer,
                                 m_per_iteration=3, eps=0.03, max_measurements=9)


def site_verdict():
    site = ssd_chunk_site(b=2, s=32, h=4, p=8, n=8, chunks=(8, 16), device="cpu")
    return rank_site(site, max_measurements=9).ranking


def rt_events(prof):
    return [e for e in prof.profiler.kineto_results.events() if e.name().startswith("rt.")]


@pytest.fixture(scope="module")
def traced():
    """{path: (its rt. events, its ranking result)}, each path profiled alone."""
    out = {}
    for path, run in (("chain", chain_verdict), ("site", site_verdict)):
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            result = run()
        out[path] = (rt_events(prof), result)
    return out


@pytest.mark.parametrize("path", ["chain", "site"])
def test_ranking_path_carries_its_spans_nested(traced, path):
    events, result = traced[path]
    names = {e.name() for e in events}
    expected = RANKING_SPANS | INPUT_SPANS[path]
    assert expected <= names and names <= expected | {"rt.graph.capture"}
    steps = [(e.start_ns(), e.end_ns()) for e in events if e.name() == "rt.rank.step"]
    updates = [(e.start_ns(), e.end_ns()) for e in events if e.name() == "rt.rank.update"]
    assert len(steps) == len(result.history) >= 1
    assert len(updates) == len(steps)
    assert all(any(a <= u0 and u1 <= b for a, b in steps) for u0, u1 in updates)


@pytest.mark.parametrize("path", ["chain", "site"])
def test_spans_are_host_ops_never_user_annotations(traced, path):
    events, _ = traced[path]
    assert events
    assert {e.activity_type() for e in events} == {"cpu_op"}
    assert not any(e.is_user_annotation() or "CUDA" in str(e.device_type()) for e in events)


def test_span_off_is_one_shared_noop(monkeypatch):
    def refuse(name):
        raise AssertionError(f"a span was built with no profiler running: {name}")

    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", refuse)
    assert not torch.autograd.profiler._is_profiler_enabled
    first = spans.span("rt.build")
    assert all(spans.span(name) is first for name in sorted(RANKING_SPANS))
    with first:
        pass
    assert chain_verdict().history and site_verdict().history


def needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the port captures CUDA graphs only there")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_graph_keeps_the_operands_its_caller_dropped():
    from repro_torch import graphs

    dev = needs_card()
    gen = torch.Generator(device=dev).manual_seed(11)
    a = torch.randn((512, 384), generator=gen, device=dev)
    b = torch.randn((384, 256), generator=gen, device=dev)
    ref = (a.double() @ b.double()).cpu()
    replay = graphs.measured_thunk(torch.matmul, a, b)  # captures a closure over (a, b)
    del a, b  # only the replay holds them now; freed, the allocator would hand them out again
    over = [torch.full(shape, float("nan"), device=dev)
            for shape in ((512, 384), (384, 256)) for _ in range(4)]
    out = replay().double().cpu()
    del over
    err = (out - ref).abs().max() / ref.abs().max()
    assert err < 1e-5, err


@pytest.mark.cuda
def test_capture_is_one_host_span_and_nothing_on_the_device():
    dev = needs_card()
    dims = (256, 192, 128, 160, 96)
    algs = generate_chain_algorithms(dims)
    mats = make_chain_inputs(dims, seed=5, device=dev)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        built = build_workloads(algs, mats, jit=True)
        built[algs[0].name]()
    events = rt_events(prof)
    captures = [e for e in events if e.name() == "rt.graph.capture"]
    assert len(captures) == len(algs)
    assert not any("CUDA" in str(e.device_type()) or e.is_user_annotation() for e in events)

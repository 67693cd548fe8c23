"""The readers of the program's ``rt.`` spans on hand-built traces with
known answers: spans clipped to the window, nested and overlapping spans
counted once, no capture read as 0.0, no ``rt.`` event read as nothing."""

import pytest

from portbench.harness import Calls, RunData, Verdict, load_module
from portbench.trace import TraceData, Tracer

READERS = ("capture_ms_per_verdict", "rank_host_ms_per_verdict", "unspanned_idle_share")
MS = 1_000_000  # ns


def run_of(host, device=(), verdicts=2, window=(0, 100 * MS)):
    trace = TraceData(window=window, host=[(a, b, name, 0) for a, b, name in host],
                      device=[(a, b, "kernel", 0) for a, b in device])
    return RunData(window_s=trace.window_s, calls=Calls(Tracer(on=False, cuda=False)),
                   verdicts=[Verdict(latency_s=None, measurements=1, build_s=None)] * verdicts,
                   trace=trace)


def read(name, run):
    return load_module("metrics", name).read(run)


def test_spans_crossing_the_window_are_clipped():
    run = run_of([(-20 * MS, 10 * MS, "rt.graph.capture"), (90 * MS, 130 * MS, "rt.graph.capture"),
                  (95 * MS, 120 * MS, "rt.rank.update"), (200 * MS, 210 * MS, "rt.rank.update")])
    assert read("capture_ms_per_verdict", run) == pytest.approx((10 + 10) / 2)
    assert read("rank_host_ms_per_verdict", run) == pytest.approx(5 / 2)
    assert read("unspanned_idle_share", run) == pytest.approx(80.0)


def test_nested_and_overlapping_spans_and_busy_time_count_once():
    host = [(10 * MS, 50 * MS, "rt.rank.step"), (20 * MS, 30 * MS, "rt.rank.update"),
            (40 * MS, 60 * MS, "rt.measure"), (70 * MS, 80 * MS, "pb.rank"),
            (70 * MS, 75 * MS, "cudaFree")]
    run = run_of(host, device=[(45 * MS, 65 * MS), (90 * MS, 95 * MS)])
    # covered: [10, 65] by spans and busy time, [90, 95] busy: 60 of 100 ms
    assert read("unspanned_idle_share", run) == pytest.approx(40.0)
    assert read("rank_host_ms_per_verdict", run) == pytest.approx(10 / 2)


def test_no_capture_reads_zero_where_the_program_ran():
    run = run_of([(0, 30 * MS, "rt.rank.step")], verdicts=3)
    assert read("capture_ms_per_verdict", run) == 0.0
    assert read("rank_host_ms_per_verdict", run) == 0.0
    assert read("unspanned_idle_share", run) == pytest.approx(70.0)


@pytest.mark.parametrize("name", READERS)
def test_no_rt_event_reads_nothing(name):
    host = [(0, 50 * MS, "pb.rank"), (10 * MS, 20 * MS, "cudaMalloc"), (0, 100 * MS, "pb.window")]
    assert read(name, run_of(host, device=[(20 * MS, 40 * MS)])) is None
    assert read(name, RunData(window_s=1.0, verdicts=[], calls=Calls(Tracer(False, False)),
                              trace=None)) is None

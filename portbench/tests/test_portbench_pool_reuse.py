"""The reader of ``pool_reuse_share`` on hand-built traces with known
answers: reused pools over all pools taken, 0.0 where nothing was
captured, nothing where captures open no pool span or no ``rt.`` event
was recorded."""

import pytest

from portbench.tests.test_portbench_spans import MS, read, run_of


def test_reused_pools_over_all_pools_taken():
    host = [(0, MS, "rt.graph.pool.new")]
    host += [(k * 10 * MS, k * 10 * MS + 1000, "rt.graph.pool.reused") for k in range(1, 6)]
    host += [(200 * MS, 201 * MS, "rt.graph.pool.new"), (0, 90 * MS, "rt.graph.capture")]
    share = read("pool_reuse_share", run_of(host))
    assert share == pytest.approx(100 * 5 / 6) and round(share, 1) == 83.3


def test_captures_without_pool_spans_read_nothing():
    host = [(0, 30 * MS, "rt.graph.capture"), (0, 50 * MS, "rt.rank.step")]
    assert read("pool_reuse_share", run_of(host)) is None


def test_no_capture_reads_zero_where_the_program_ran():
    assert read("pool_reuse_share", run_of([(0, 30 * MS, "rt.rank.step")])) == 0.0


def test_no_rt_event_reads_nothing():
    host = [(0, 50 * MS, "pb.rank"), (10 * MS, 20 * MS, "cudaMalloc")]
    assert read("pool_reuse_share", run_of(host, device=[(20 * MS, 40 * MS)])) is None

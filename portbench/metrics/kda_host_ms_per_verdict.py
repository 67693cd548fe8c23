"""kda_host_ms_per_verdict: ms per verdict the host spent issuing the KDA
core's chunked algorithm, its chunk loop included: the program's
``rt.kda.chunk`` spans in the window (eager calls, graph warm-ups and
captures; a graph's replay opens none), summed, over the window's verdicts.
Nothing where the program opens no such span (a program without it)."""

from ._spans import rt_spans


def read(run):
    spans = rt_spans(run.trace)
    if spans is None or not run.verdicts:
        return None
    chunk = [b - a for a, b, name in spans if name == "rt.kda.chunk"]
    if not chunk:
        return None
    return sum(chunk) / 1e6 / len(run.verdicts)

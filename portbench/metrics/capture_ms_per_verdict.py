"""capture_ms_per_verdict: ms per verdict the program spent capturing CUDA
graphs, eager warm-up on the side stream to the streams' join: the
program's ``rt.graph.capture`` spans in the window, summed, over the
window's verdicts; 0.0 where the program ran but captured nothing."""

from ._spans import ms_per_verdict


def read(run):
    return ms_per_verdict(run, "rt.graph.capture")

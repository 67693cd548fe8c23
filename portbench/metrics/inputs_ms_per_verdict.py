"""inputs_ms_per_verdict: ms per verdict the program spent drawing chain
instances' matrices on the host and copying them to the device: its
``rt.inputs`` spans in the window, summed, over the window's verdicts.
Nothing where the program opens no such span (a program without it)."""

from ._spans import rt_spans


def read(run):
    spans = rt_spans(run.trace)
    if spans is None or not run.verdicts:
        return None
    inputs = [b - a for a, b, name in spans if name == "rt.inputs"]
    if not inputs:
        return None
    return sum(inputs) / 1e6 / len(run.verdicts)

"""The program's ``rt.`` spans in a traced window, for the readers of
``capture_ms_per_verdict``, ``rank_host_ms_per_verdict`` and
``unspanned_idle_share``. The spans are host events the program opens
under any profiler (``repro_torch/spans.py``); nothing here imports it."""


def rt_spans(trace):
    """(start, end, name) in ns of every ``rt.`` host event, clipped to the
    window; None when the trace holds no ``rt.`` event at all."""
    if trace is None:
        return None
    events = [(a, b, name) for a, b, name, _ in trace.host if name.startswith("rt.")]
    if not events:
        return None
    lo, hi = trace.window
    return [(max(a, lo), min(b, hi), name) for a, b, name in events if min(b, hi) > max(a, lo)]


def ms_per_verdict(run, name):
    """The durations of the spans called ``name`` in the window, summed, in
    ms per verdict of the window."""
    spans = rt_spans(run.trace)
    if spans is None or not run.verdicts:
        return None
    return sum(b - a for a, b, n in spans if n == name) / 1e6 / len(run.verdicts)


def covered_ns(intervals):
    """Length of the union of ``intervals`` (start, end)."""
    total, reach = 0, None
    for a, b in sorted(intervals):
        if reach is None or a > reach:
            total += b - a
            reach = b
        elif b > reach:
            total += b - reach
            reach = b
    return total

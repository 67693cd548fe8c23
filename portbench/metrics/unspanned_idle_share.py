"""unspanned_idle_share: % of the traced window in which the device ran
nothing and no stage of the program was running: the window less the union
of the device's activity and the program's ``rt.`` spans. What is left is
the caller's: its glue between verdicts and its release of cached memory."""

from ._spans import covered_ns, rt_spans


def read(run):
    spans = rt_spans(run.trace)
    if spans is None:
        return None
    lo, hi = run.trace.window
    covered = covered_ns([(a, b) for a, b, _ in spans] + run.trace.busy())
    return 100.0 * (1.0 - covered / (hi - lo))

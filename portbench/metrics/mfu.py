"""mfu: the useful FLOPs of every call the window made to the program's
workloads (the frozen formulas, times the calls the harness's wrappers
counted) over the window's seconds at the H100's dense TF32 peak, in %."""

from ..formulas import PEAK_TF32_FLOPS


def read(run):
    if run.calls.flops <= 0:
        return None
    return 100.0 * run.calls.flops / (run.window_s * PEAK_TF32_FLOPS)

"""measurements_per_verdict: Procedure 4's runs per verdict, N times the
algorithms kept, averaged over the window's verdicts."""


def read(run):
    if not run.verdicts:
        return None
    return sum(v.measurements for v in run.verdicts) / len(run.verdicts)

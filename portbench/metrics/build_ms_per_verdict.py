"""build_ms_per_verdict: ms per verdict of instance set-up, the workloads
built (inputs, graph capture, warm-up) and their single runs: the census's
``build_s`` over its records, elsewhere the benchmark's own span. Verdicts
whose set-up the driver could not span are left out."""


def read(run):
    spans = [v.build_s for v in run.verdicts if v.build_s is not None]
    if not spans:
        return None
    return 1000.0 * sum(spans) / len(spans)

"""pool_reuse_share: % of the window's graph captures that took a memory
pool a dropped graph had grown, not a new one: the program's
``rt.graph.pool.reused`` spans over those and its ``rt.graph.pool.new``
spans together. 0.0 where the program ran but captured nothing (CPU
tensors are never captured); nothing where it captured graphs but opened
neither span (a program without the free list)."""

from ._spans import rt_spans


def read(run):
    spans = rt_spans(run.trace)
    if spans is None:
        return None
    names = [n for _, _, n in spans]
    reused, new = names.count("rt.graph.pool.reused"), names.count("rt.graph.pool.new")
    if reused + new == 0:
        return None if "rt.graph.capture" in names else 0.0
    return 100.0 * reused / (reused + new)

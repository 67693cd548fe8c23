"""rank_host_ms_per_verdict: ms per verdict of Procedure 4's host work
after each batch of samples (store, shuffle, mean ranks, convergence norm,
record): the program's ``rt.rank.update`` spans in the window, summed,
over the window's verdicts."""

from ._spans import ms_per_verdict


def read(run):
    return ms_per_verdict(run, "rt.rank.update")

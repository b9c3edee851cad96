"""Host ms a one-query select waited in the dynbatch queue: the mean
`dynbatch.wait` span of the window, from enqueue to its result (served by
another's dispatch) or to its election as the leader."""
from statistics import fmean

from h100bench.harness import program

PROBES = ("program.dynbatch.wait",)


def read(r):
    waits = program.spans_in(r, "dynbatch.wait")
    if not waits:
        return None
    return 1e3 * fmean(s[2] - s[1] for s in waits)

"""Host ms a request of the window waited to take its namespace's lock:
the mean over the window's requests (their `Reindexer.Query` or
`Reindexer.knn_batch` spans) of the `ns.lock_wait` spans of their trace,
on every path (the executor's entry, a re-take after the lock was let go,
knn_batch's two). A dynbatch leader's waits inside its dispatch count for
the leader's request."""
from statistics import fmean

from h100bench.harness import program

PROBES = ("program.ns.lock_wait", "program.Reindexer.Query",
          "program.Reindexer.knn_batch")


def read(r):
    roots = (program.spans_in(r, "Reindexer.Query")
             + program.spans_in(r, "Reindexer.knn_batch"))
    waits = program.spans("ns.lock_wait")
    if not roots or not waits:
        return None
    held: dict = {}
    for w in waits:
        held[w[6]] = held.get(w[6], 0.0) + (w[2] - w[1])
    return 1e3 * fmean(held.get(root[6], 0.0) for root in roots)

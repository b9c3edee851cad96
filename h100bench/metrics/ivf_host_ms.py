"""Host ms of IVF's stage 1 and K6's plan a dispatch: the window's
`ivf.probe` (the centroid scores and top-nprobe on the host) and `ivf.plan`
(the probed lists expanded to K6's segments) spans over its
`engine.dispatch` spans. `engine_ms` less this is the rest of a dispatch:
the copies, K6, the segment top-k and the wait for the answer.

Probes program.ivf.probe and program.ivf.plan check the two spans' names,
but the reader does not require them: a program without them (the port
before it had them) reads nothing here and the metric is left out. It
requires only the dispatch span, which both have."""
from h100bench.harness import program

PROBES = ("program.engine.dispatch",)


def read(r):
    dispatches = program.spans_in(r, "engine.dispatch")
    host = program.spans_in(r, "ivf.probe") + program.spans_in(r, "ivf.plan")
    if not dispatches or not host:
        return None
    return 1e3 * sum(s[2] - s[1] for s in host) / len(dispatches)

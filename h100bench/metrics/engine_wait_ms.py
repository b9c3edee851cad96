"""Host ms an engine dispatch spent blocked on the device: the window's
`engine.device_wait` (the result's copy to the host) and `hnsw.stop_read`
(each read of a beam's or a descent's stop flag) spans, over its
`engine.dispatch` spans. `engine_ms` less this is the engine's own host
work."""
from h100bench.harness import program

PROBES = ("program.engine.device_wait", "program.hnsw.stop_read",
          "program.engine.dispatch")


def read(r):
    dispatches = program.spans_in(r, "engine.dispatch")
    if not dispatches:
        return None
    waits = (program.spans_in(r, "engine.device_wait")
             + program.spans_in(r, "hnsw.stop_read"))
    return 1e3 * sum(s[2] - s[1] for s in waits) / len(dispatches)

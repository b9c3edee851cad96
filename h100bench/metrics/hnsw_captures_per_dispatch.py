"""CUDA graphs of a beam block captured per engine dispatch over the
window: the change of the program's `hnsw.graph_captures` over that of
`engine.dispatches`. A count: it repeats exactly from run to run."""

PROBES = ("program.hnsw.graph_captures", "program.engine.dispatches")


def read(r):
    captures = r.delta("program.hnsw.graph_captures")
    dispatches = r.delta("program.engine.dispatches")
    if captures is None or not dispatches:
        return None
    return captures / dispatches

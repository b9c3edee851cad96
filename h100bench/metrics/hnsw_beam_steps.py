"""HNSW beam steps a dispatch ran: the change of
ops.hnsw_kernels.beam_steps over the engine dispatches of the window."""

PROBES = ("beam_steps", "engine")


def read(r):
    steps = r.delta("beam_steps")
    engine = r.spans_in("engine")
    if not steps or not engine:
        return None
    return steps / len(engine)

"""Queries a dynbatch dispatch carried over the window: the change of
#perfstats' batched_queries over that of batched_dispatches."""

PROBES = ("batched_queries", "batched_dispatches")


def read(r):
    dq, dd = r.delta("batched_queries"), r.delta("batched_dispatches")
    if not dq or not dd:
        return None
    return dq / dd

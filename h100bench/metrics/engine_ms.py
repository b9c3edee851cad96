"""Host ms from the vector engine's select_batch_async entry to the
return of its drain, per dispatch (dispatch, device work, copy back)."""
from statistics import fmean

PROBES = ("engine",)


def read(r):
    engine = r.spans_in("engine")
    if not engine:
        return None
    return 1e3 * fmean(b - a for a, b, _ in engine)

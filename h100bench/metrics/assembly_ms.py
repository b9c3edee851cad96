"""Host ms a `knn_batch` call spends outside the engine: the call's time
less the engine's span inside it (select_batch_async's entry to its
drain's return). That is the facade's lock, copy and result assembly."""
from statistics import fmean

PROBES = ("engine",)


def read(r):
    if r.traffic["entry"] != "knn_batch":
        return None
    engine = r.spans_in("engine")
    if not r.requests or not engine:
        return None
    own = []
    for s, e, _, ok in r.requests:
        inside = sum(b - a for a, b, _ in engine if s <= a and b <= e)
        own.append(e - s - inside)
    return 1e3 * fmean(own)

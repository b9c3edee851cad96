"""95th percentile of every request's latency in the traced run's window
(the profiled phase after it left out), as the end-to-end p95_ms computes
it: a whole `select` or `knn_batch` call, failed ones infinitely late. The
traced run's probes are installed around the window, so it reads a little
above an untraced run's tail and is compared only with itself."""
from h100bench.harness.load import p95_ms

PROBES = ()


def read(r):
    if not r.requests:
        return None
    return p95_ms(r.requests)

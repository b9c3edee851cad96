"""K1 (csrc/bf_scan.cu) against its roofline, in %: the frozen bound of
one launch at the cell's shape over K1's mean device time a launch.

One launch of a `knn_batch` of Q <= 64 queries scans the N rows of D
floats: it reads the queries, the rows and their squared norms once and
writes the scores [Q, N] and the block maxima [Q, N / 64], all float32,
and forms 3 x 2 Q N D operations on the TF32 tensor cores (three TF32
products make K1's fp32 one). N is the configuration's rows, not the
keeper's padded capacity, so the padding the kernel also scans counts
against it. Only cells whose every launch has the same Q (one client's
`knn_batch` of at most 64 queries) read it."""
from statistics import fmean

from h100bench.harness.measure import bound

PROBES = ()

KERNEL = "bf_scan_kernel"
BLOCK = 64


def read(r):
    tr = r.trace
    q = r.traffic["queries_per_call"]
    if (tr is None or r.traffic["entry"] != "knn_batch" or q > 64
            or r.traffic["clients"] != 1):
        return None
    times = [e - s for s, e, name in tr.events
             if KERNEL in name and tr.t0_ns <= s < tr.t1_ns]
    if not times:
        return None
    n, d = r.config["rows"], r.config["dims"]
    b = bound(4 * (q * d + n * d + n + q * n + q * n // BLOCK),
              3 * 2 * q * n * d, "tf32")
    return 100.0 * b["bound_ms"] / (fmean(times) / 1e6)

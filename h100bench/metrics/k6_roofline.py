"""K6 (csrc/ivf_seg_scan.cu) against its roofline, in %: the frozen bound
of the window's mean segment-route call over the mean device event of
K6's scan kernel (`ivf_seg_scan_kernel`; the grouping kernels before it
are left out) in the profiled phase.

A call scores the live segments of a `knn_batch` of Q queries, each a
query and one probed block of up to 128 rows of D floats. It needs the
rows of every distinct probed list once for all the batch's queries (K6
reads a whole block in one box and a list's ragged last block in 32-row
boxes, so the padding of a block is not what a call needs), and the
queries once, and writes 128 float32 scores a live segment; it forms 3 x 2
x 128 x D operations a live segment on the TF32 tensor cores (three TF32
products make its fp32 one). Per call, from the window's changes of the
program's counters over that of `ivf.segment_scans`:

    bytes = 4 D seg_rows + 4 D Q + 4 x 128 seg_live
    ops   = 3 x 2 x 128 D seg_live

with seg_rows the rows of the distinct probed lists (`ivf.seg_rows`) and
seg_live the live segments (`ivf.seg_live`). Only cells whose every call
has the same Q (one client's `knn_batch`) read it. A program without the
two counters (the port before it had them) reads nothing here and the
metric is left out, so the reader requires only `ivf.segment_scans`."""
from statistics import fmean

from h100bench.harness.measure import bound

PROBES = ("program.ivf.segment_scans",)

KERNEL = "ivf_seg_scan_kernel"
SEG_BLK = 128


def read(r):
    tr = r.trace
    if (tr is None or r.traffic["entry"] != "knn_batch"
            or r.traffic["clients"] != 1):
        return None
    calls = r.delta("program.ivf.segment_scans")
    rows = r.delta("program.ivf.seg_rows")
    live = r.delta("program.ivf.seg_live")
    if not calls or not rows or not live:
        return None
    times = [e - s for s, e, name in tr.events
             if KERNEL in name and tr.t0_ns <= s < tr.t1_ns]
    if not times:
        return None
    d, q = r.config["dims"], r.traffic["queries_per_call"]
    rows, live = rows / calls, live / calls
    b = bound(4 * (rows * d + q * d + SEG_BLK * live),
              3 * 2 * SEG_BLK * d * live, "tf32")
    return 100.0 * b["bound_ms"] / (fmean(times) / 1e6)

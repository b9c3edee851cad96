"""Share of the profiled phase's device idle time that the program's spans
of work do not explain: the idle gaps (measure.DeviceTrace.gaps) at whose
middle no thread's innermost open program span is a span of work, over
all the idle time. A request's root (`Reindexer.Query`,
`Reindexer.knn_batch`) and a wait on the namespace lock or in the
dynbatch queue (`ns.lock_wait`, `dynbatch.wait`) are no work: they say
that a request is in flight, not what the host does; a dynbatch leader
parked on the lock inside its dispatch waits. What is left is the
harness's client loop and the program's host work that has no span of
its own: the facade and the executor around the layers' spans. The run's
log splits the idle time by the shortest of the threads' innermost spans
of work at each gap's middle."""
import heapq
import sys

from h100bench.harness import program

ROOTS = ("Reindexer.Query", "Reindexer.knn_batch")
WAITS = ("ns.lock_wait", "dynbatch.wait")
PROBES = tuple("program." + name for name in ROOTS + WAITS)


def read(r):
    tr = r.trace
    if tr is None or not program.spans():
        return None
    spans = sorted(program.spans(), key=lambda s: s[1])
    gaps = sorted((((g0 + g1) / 2 - r.trace_offset_ns) / 1e9,
                   (g1 - g0) / 1e9) for g0, g1 in tr.gaps())
    open_spans: list = []     # (end, start, name, thread), open at the middle
    split: dict = {}
    j = 0
    for mid, idle in gaps:
        while j < len(spans) and spans[j][1] <= mid:
            s = spans[j]
            heapq.heappush(open_spans, (s[2], s[1], s[0], s[3]))
            j += 1
        while open_spans and open_spans[0][0] < mid:
            heapq.heappop(open_spans)
        inner: dict = {}      # thread -> its innermost (latest opened) span
        for s in open_spans:
            if s[3] not in inner or s[1] > inner[s[3]][1]:
                inner[s[3]] = s
        work = [s for s in inner.values() if s[2] not in ROOTS + WAITS]
        name = (min(work, key=lambda s: s[0] - s[1])[2] if work
                else "(no span of work)")
        split[name] = split.get(name, 0.0) + idle
    total = sum(split.values())
    if not total:
        return None
    print("[program] device idle s by the innermost span at each gap's "
          "middle: " + ", ".join(f"{k} {v:.6f}" for k, v in sorted(
              split.items(), key=lambda kv: -kv[1])),
          file=sys.stderr, flush=True)
    return split.get("(no span of work)", 0.0) / total

"""Device kernels launched per query answered, over the profiled phase:
the trace's kernel events plus its lost kernel launches, over the queries
answered in it."""

# the trace reader takes HNSW graph captures out of the lost launches
PROBES = ("graph_capture",)


def read(r):
    tr = r.trace
    if tr is None or not r.trace_queries:
        return None
    kernels = sum(1 for s, _, name in tr.events
                  if tr.t0_ns <= s < tr.t1_ns
                  and not name.startswith(("Memcpy", "Memset")))
    kernels += tr.lost.get("kernel", 0)
    return kernels / r.trace_queries if kernels else None

"""Share of the profiled phase in which the device ran nothing:
1 - busy / window, busy corrected for lost events (measure.DeviceTrace)."""

# the trace reader takes HNSW graph captures out of the lost launches
PROBES = ("graph_capture",)


def read(r):
    tr = r.trace
    if tr is None or tr.window_s <= 0 or tr.busy_s <= 0:
        return None
    return 1.0 - tr.busy_s / tr.window_s

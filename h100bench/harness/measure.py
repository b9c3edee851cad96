"""The H100's peaks, a kernel's bound, and the reading of a profiler trace.

`bound` (with PEAK_BYTES_S and PEAK_OPS_S) is a frozen copy of
chip_smoke.py's (repository root), kept here so that later changes to the
program cannot move the yardstick. `read_trace` reads every device event
of a window from torch.profiler's Kineto results; its correction for lost
events is chip_smoke.py's `profile_device`'s, made per kind of event.
"""
from __future__ import annotations

import statistics

import torch

# the H100 SXM's published peaks (NVIDIA H100 datasheet); frozen copy of
# chip_smoke.py's
PEAK_BYTES_S = 3.35e12
PEAK_OPS_S = {"fp32": 67e12, "tf32": 495e12, "bf16": 989e12,
              "int8": 1979e12}


def bound(n_bytes: float, ops: float, kind: str) -> dict:
    """The least time the card could take: the larger of n_bytes over the
    memory rate and ops over the peak rate of their type."""
    t_bytes = 1e3 * n_bytes / PEAK_BYTES_S
    t_ops = 1e3 * ops / PEAK_OPS_S[kind]
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


# runtime calls that put work on the device, by the kind of device event
# each makes
_LAUNCH_KIND = {"cudaLaunchKernel": "kernel", "cudaLaunchKernelExC": "kernel",
                "cuLaunchKernel": "kernel", "cuLaunchKernelEx": "kernel",
                "cudaMemcpyAsync": "memcpy", "cudaMemcpy": "memcpy",
                "cudaMemsetAsync": "memset", "cudaMemset": "memset"}


def _event_kind(name: str) -> str:
    if name.startswith("Memcpy"):
        return "memcpy"
    if name.startswith("Memset"):
        return "memset"
    return "kernel"


class DeviceTrace:
    """The device events of one profiled window, on the host's wall clock
    (time.time_ns, which Kineto's time stamps follow).

    `events`: (start_ns, end_ns, name) of every kernel, copy and set the
    device ran. `lost`: {kind: runtime launches with no device event}, less
    those issued while a CUDA graph was being captured (a captured launch
    runs only when the graph replays, under the replay's own events).
    `busy_s`: the union of the events' intervals within the window, plus,
    for each lost launch, the mean duration of the kept events of its kind:
    the correction chip_smoke.py's profile_device makes, here per kind of
    event, since a lost launch's kernel name is not in the trace."""

    def __init__(self, events: list, lost: dict, t0_ns: int, t1_ns: int):
        self.events = sorted(events)
        self.lost = lost
        self.t0_ns, self.t1_ns = t0_ns, t1_ns
        self.window_s = (t1_ns - t0_ns) / 1e9
        union = sum(b - a for a, b in self._busy_intervals())
        by_kind: dict = {}
        for s, e, name in self.events:
            by_kind.setdefault(_event_kind(name), []).append(e - s)
        extra = sum(n * statistics.fmean(by_kind[k])
                    for k, n in lost.items() if by_kind.get(k))
        self.busy_s = (union + extra) / 1e9

    def _busy_intervals(self) -> list:
        """The union of the events' intervals, clipped to the window."""
        out: list = []
        for s, e, _ in self.events:
            s, e = max(s, self.t0_ns), min(e, self.t1_ns)
            if e <= s:
                continue
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return out

    def by_name(self) -> dict:
        """{device event name: (count, seconds)} of the events that start
        in the window."""
        out: dict = {}
        for s, e, name in self.events:
            if self.t0_ns <= s < self.t1_ns:
                c, t = out.get(name, (0, 0.0))
                out[name] = (c + 1, t + (e - s) / 1e9)
        return out

    def gaps(self) -> list:
        """(start_ns, end_ns) of every stretch of the window in which the
        device ran nothing."""
        out, cur = [], self.t0_ns
        for s, e in self._busy_intervals():
            if s > cur:
                out.append((cur, s))
            cur = e
        if cur < self.t1_ns:
            out.append((cur, self.t1_ns))
        return out


def read_trace(prof, t0_ns: int, t1_ns: int,
               capture_spans_ns: list) -> DeviceTrace:
    """A DeviceTrace of the window [t0_ns, t1_ns] (wall-clock ns) from a
    finished torch.profiler.profile. `capture_spans_ns`: (start, end) of
    each CUDA graph capture in the window."""
    events, launches, dev_corr = [], [], set()
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            start = e.start_ns()
            events.append((start, start + e.duration_ns(), name))
            dev_corr.add(e.correlation_id())
        elif name in _LAUNCH_KIND and t0_ns <= e.start_ns() <= t1_ns:
            launches.append((e.correlation_id(), name, e.start_ns()))
    lost: dict = {}
    for corr, name, start in launches:
        if corr in dev_corr or any(a <= start <= b
                                   for a, b in capture_spans_ns):
            continue
        kind = _LAUNCH_KIND[name]
        lost[kind] = lost.get(kind, 0) + 1
    return DeviceTrace(events, lost, t0_ns, t1_ns)

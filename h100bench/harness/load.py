"""Closed-loop load: each client sends its next request when the previous
one has returned. The same client threads warm up and then run the
measured window, so nothing a thread sets up on first use lands in it.

With `profile`, a second phase of `profile_s` follows the window: once
every client's last request of the window has returned, profile.start()
runs, the clients go on for profile_s, and profile.stop() runs once every
client has returned again; both are given the Window. Neither runs while
a client is inside the program: stopping torch.profiler while another
thread replays a CUDA graph can hang (seen on the card).

A request is one call of the traffic's entry (one `knn_batch` of
`queries_per_call` queries, or one `select` of one query). Client c's j-th
request takes the pool's queries from offset (c * stride + j *
queries_per_call) mod pool, so clients send different queries. The
answers of a sample of each client's requests, drawn from the seed by
reservoir sampling, are kept for the comparison.
"""
from __future__ import annotations

import random
import threading
import time

import numpy as np


class Window:
    """What the window produced: per request (start, end, queries, ok) on
    time.perf_counter's clock; the kept answers as (pool offset,
    QueryResults list); the window's opening and closing times (the return
    of its last request); errors seen; the profiled phase's requests."""

    def __init__(self):
        self.requests: list = []
        self.kept: list = []
        self.errors: list = []
        self.t0 = 0.0
        self.t1 = 0.0
        self.profiled: list = []


def qps(requests: list, t0: float) -> float:
    """Queries answered over the window, from its opening to the return of
    its last request."""
    end = max(r[1] for r in requests)
    return sum(r[2] for r in requests if r[3]) / (end - t0)


def p95_ms(requests: list) -> float:
    """95th percentile of every request's latency (linear interpolation,
    as numpy's default); a failed request counts as infinitely late."""
    lat = sorted((r[1] - r[0]) if r[3] else float("inf") for r in requests)
    pos = 0.95 * (len(lat) - 1)
    lo = int(pos)
    if pos == lo:
        return 1e3 * lat[lo]
    if lat[lo + 1] == float("inf"):
        return float("inf")
    return 1e3 * (lat[lo] + (lat[lo + 1] - lat[lo]) * (pos - lo))


def run(call, queries: np.ndarray, traffic: dict, seed: int, seconds: float,
        warm_s: float, profile=None) -> Window:
    """Warm up for warm_s, measure for `seconds`, then, with `profile`,
    run the profiled phase; profile.open(win) runs right before the window
    opens, once every client is ready."""
    clients = traffic["clients"]
    per_call = traffic["queries_per_call"]
    pool = len(queries)
    stride = pool // clients
    keep_n = max(1, traffic["checked_requests"] // clients)
    win = Window()
    lock = threading.Lock()
    state = {"deadline": 0.0}

    def open_window():
        if profile is not None:
            profile.open(win)
        win.t0 = time.perf_counter()
        state["deadline"] = win.t0 + seconds

    barrier = threading.Barrier(clients + 1, action=open_window)
    closing = threading.Barrier(clients + 1)
    resume = threading.Barrier(clients + 1)

    def client(c: int) -> None:
        pick = random.Random(seed * 1_000_003 + c)
        j = 0

        def one():
            nonlocal j
            at = (c * stride + j * per_call) % (pool - per_call + 1)
            j += 1
            t = time.perf_counter()
            try:
                out = call(queries[at:at + per_call])
                ok = True
            except Exception as e:            # a failed request counts
                out, ok = None, False
                with lock:
                    win.errors.append(repr(e)[:300])
            return (t, time.perf_counter(), per_call, ok), (at, out)

        warm_until = time.perf_counter() + warm_s
        while time.perf_counter() < warm_until:
            one()
        barrier.wait()
        mine, kept, n = [], [], 0
        while time.perf_counter() < state["deadline"]:
            req, ans = one()
            mine.append(req)
            if ans[1] is not None:
                if len(kept) < keep_n:
                    kept.append(ans)
                else:
                    slot = pick.randrange(n + 1)
                    if slot < keep_n:
                        kept[slot] = ans
                n += 1
        with lock:
            win.requests.extend(mine)
            win.kept.extend(kept)
        if profile is None:
            return
        closing.wait()
        resume.wait()
        mine = []
        while time.perf_counter() < state["deadline"]:
            mine.append(one()[0])
        with lock:
            win.profiled.extend(mine)

    threads = [threading.Thread(target=client, args=(c,), daemon=True)
               for c in range(clients)]
    for t in threads:
        t.start()
    barrier.wait()
    if profile is not None:
        # the profiler starts and stops on this thread: torch.profiler
        # cannot stop a profile another thread started
        closing.wait()
        profile.start(win)
        state["deadline"] = time.perf_counter() + traffic["profile_s"]
        resume.wait()
    for t in threads:
        t.join()
    win.t1 = max(r[1] for r in win.requests)
    if profile is not None:
        profile.stop(win)
    return win

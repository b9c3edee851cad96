"""The yardstick's arithmetic: generators repeat from a seed, the NumPy
reference's top-k, qps and p95 over every request, the comparison's
numbers, the roofline's bound."""
import numpy as np
import pytest

from h100bench import reference
from h100bench.harness import check, load, measure, runner, spec
from h100bench.harness.system import Data


@pytest.mark.parametrize("name", ["sift-bf", "deep-hnsw"])
def test_data_repeats_from_a_seed(name):
    config = {**spec.config(name), "rows": 500}
    traffic = {"query_pool": 64, "queries_per_call": 8}
    a, b = Data(config, traffic, 2 ** 31 + 5), Data(config, traffic,
                                                    2 ** 31 + 5)
    c = Data(config, traffic, 2 ** 31 + 6)
    for attr in ("rows", "groups", "queries", "warm"):
        np.testing.assert_array_equal(getattr(a, attr), getattr(b, attr))
    assert not np.array_equal(a.rows, c.rows)
    assert a.rows.dtype == np.float32 and a.rows.shape == (500,
                                                           config["dims"])
    # queries are never rows
    assert not (a.queries[:, None, :] == a.rows[None, :, :]).all(2).any()


def test_sift_like_rows_are_integers_in_range():
    d = Data({**spec.config("sift-bf"), "rows": 300},
             {"query_pool": 16, "queries_per_call": 4}, 7)
    assert d.rows.min() >= 0 and d.rows.max() <= 255
    np.testing.assert_array_equal(d.rows, np.rint(d.rows))


@pytest.mark.parametrize("metric", ["l2", "inner_product", "cosine"])
def test_reference_topk_against_a_full_sort(metric):
    rng = np.random.default_rng(3)
    rows = rng.normal(size=(200, 6)).astype(np.float32)
    qs = rng.normal(size=(5, 6)).astype(np.float32)
    ids, ranks = reference.exact_topk(rows, qs, 7, metric)
    for j, q in enumerate(qs.astype(np.float64)):
        r = reference.ranks64(rows.astype(np.float64), q, np.arange(200),
                              metric)
        order = np.argsort(r if metric == "l2" else -r, kind="stable")[:7]
        np.testing.assert_array_equal(ids[j], order)
        np.testing.assert_allclose(ranks[j], r[order], rtol=1e-12)


def test_reference_ties_go_to_the_lower_id():
    rows = np.array([[1.0], [0.0], [1.0], [1.0]], dtype=np.float32)
    ids, _ = reference.exact_topk(rows, np.array([[0.0]], np.float32), 3,
                                  "l2")
    assert ids.tolist() == [[1, 0, 2]]


def test_qps_and_p95_over_every_request():
    # 100 requests: latencies 1..100 ms, 4 queries each, window 10 s
    reqs = [(1.0 + i * 0.1, 1.0 + i * 0.1 + (i + 1) / 1e3, 4, True)
            for i in range(100)]
    end = max(r[1] for r in reqs)
    assert load.qps(reqs, 1.0) == pytest.approx(400 / (end - 1.0))
    assert load.p95_ms(reqs) == pytest.approx(
        np.percentile(np.arange(1, 101), 95))
    # chunked medians would hide one slow request; the tail keeps it
    reqs[-1] = (reqs[-1][0], reqs[-1][0] + 5.0, 4, True)
    assert load.p95_ms(reqs) == pytest.approx(
        np.percentile(list(range(1, 100)) + [5000], 95))
    # a failed request counts as missing any latency limit
    failed = [(r[0], r[1], r[2], i >= 94) for i, r in enumerate(reqs)]
    assert load.p95_ms(failed) == float("inf")
    assert load.qps(failed, 1.0) == pytest.approx(6 * 4 / (
        max(r[1] for r in failed) - 1.0))



def test_request_p95_reads_the_window_alone():
    # the traced run's tail: the window's requests, not the profiled phase's
    reqs = [(1.0 + i * 0.1, 1.0 + i * 0.1 + (i + 1) / 1e3, 1, True)
            for i in range(100)]
    slow = [(20.0, 25.0, 1, True)] * 50
    reader = spec.metric_reader("request_p95_ms")
    r = runner.Reading(requests=reqs, profiled=slow)
    assert reader.read(r) == pytest.approx(load.p95_ms(reqs))
    assert reader.read(runner.Reading(requests=[], profiled=slow)) is None

def test_compare_numbers():
    rng = np.random.default_rng(1)
    rows = rng.normal(size=(100, 4)).astype(np.float32)
    qs = rng.normal(size=(3, 4)).astype(np.float32)
    groups = rng.integers(0, 10, size=100)
    ids, ranks = reference.exact_topk(rows, qs, 5, "l2")
    docs = [[reference.document(i, groups) for i in row] for row in ids]
    limits = {"answers_short": 0, "fields_wrong": 0, "misordered": 0,
              "gap": 1e-6, "rank_err": 1e-6, "recall_min": 0.99}
    good = [(j, ids[j], ranks[j], docs[j]) for j in range(3)]
    n = check.compare(good, rows, qs, groups, "l2", 5, limits)
    assert check.passed(n) and n["recall_min"]["value"] == 1.0
    swapped = [(j, ids[2 - j], ranks[2 - j], docs[2 - j]) for j in range(3)]
    n = check.compare(swapped, rows, qs, groups, "l2", 5, limits)
    assert not check.passed(n) and n["gap"]["value"] > 1e-3
    wrong_doc = [(0, ids[0], ranks[0], [{**docs[0][0], "grp": -1}]
                  + docs[0][1:])]
    n = check.compare(wrong_doc, rows, qs, groups, "l2", 5, limits)
    assert n["fields_wrong"]["value"] == 1
    short = [(0, ids[0][:4], ranks[0][:4], docs[0][:4])]
    assert check.compare(short, rows, qs, groups, "l2", 5,
                         limits)["answers_short"]["value"] == 1
    flipped = [(0, ids[0][::-1], ranks[0][::-1], docs[0][::-1])]
    assert check.compare(flipped, rows, qs, groups, "l2", 5,
                         limits)["misordered"]["value"] == 1


def test_k1_bound_is_the_byte_bound_at_the_cell_shape():
    q, n, d = 64, 100_000, 128
    b = measure.bound(4 * (q * d + n * d + n + q * n + q * n // 64),
                      3 * 2 * q * n * d, "tf32")
    assert b["bound_by"] == "bytes"
    assert b["bound_ms"] == pytest.approx(
        1e3 * 4 * (q * d + n * d + n + q * n + q * n // 64) / 3.35e12)


def test_trace_busy_union_and_loss_correction():
    ev = [(0, 10, "k"), (5, 15, "k"), (20, 30, "Memcpy DtoH"),
          (40, 50, "k")]
    tr = measure.DeviceTrace(ev, {"kernel": 2}, 0, 100)
    # union 15 + 10 + 10; two lost kernels at the kernels' mean (10)
    assert tr.busy_s == pytest.approx((35 + 20) / 1e9)
    assert tr.gaps() == [(15, 20), (30, 40), (50, 100)]
    assert tr.by_name()["k"] == (3, pytest.approx(30 / 1e9))


def breakdown_by_loop(reading) -> dict:
    """runner._breakdown as it was first written: every gap's middle
    tested against every span, the reference for the bisecting one."""
    tr = reading.trace
    ops = sorted(tr.by_name().items(), key=lambda kv: -kv[1][1])[:10]
    labels = (("gc", "gc"), ("graph_capture", "hnsw graph capture"),
              ("engine", "engine host work (dispatch, drain)"))
    idle: dict = {}
    for g0, g1 in tr.gaps():
        mid = ((g0 + g1) / 2 - reading.trace_offset_ns) / 1e9
        what = None
        for probe, label in labels:
            if any(s <= mid <= e
                   for s, e, _ in reading.spans.get(probe, ())):
                what = label
                break
        if what is None:
            busy = any(s <= mid <= e for s, e, _, _ in reading.profiled)
            what = (("result assembly and facade"
                     if reading.traffic["entry"] == "knn_batch"
                     else "executor, dynbatch and assembly") if busy
                    else "client loop")
        idle[what] = idle.get(what, 0.0) + (g1 - g0) / 1e9
    return {"device_ops": [[name[:200], sec] for name, (_, sec) in ops],
            "idle_gaps": sorted(([k, v] for k, v in idle.items()),
                                key=lambda kv: -kv[1])[:10]}


@pytest.mark.parametrize("entry", ["knn_batch", "select"])
def test_breakdown_bisects_as_the_loop_tested(entry):
    """Overlapping, nested, touching and unsorted spans from 4 threads,
    gaps whose middles fall on a span's edge, inside, between and
    outside all spans: the same labels, seconds and order."""
    rng = np.random.default_rng(11)
    off = 1_000_000_000_000
    t0 = 50_000_000_000       # ns after the offset: 50 s on perf_counter
    starts = np.sort(rng.integers(t0, t0 + 10**9, size=3000))
    events = [(int(s) + off, int(s) + off + int(rng.integers(1, 200_000)),
               f"k{i % 13}") for i, s in enumerate(starts)]
    tr = measure.DeviceTrace(events, {}, t0 + off, t0 + 10**9 + off)

    def spans(n, longest):
        a = 50.0 + rng.uniform(0, 1.0, size=n)
        out = [(float(s), float(s + rng.uniform(0, longest)),
                int(rng.integers(4))) for s in a]
        out += [(out[0][1], out[0][1] + 1e-4, 0),     # touching
                (out[1][0] + 1e-6, out[1][1], 1)]     # nested
        rng.shuffle(out)
        return out

    gaps = tr.gaps()
    # a span that ends on the first gap's middle, one that starts on the
    # second's
    mids = [((g0 + g1) / 2 - off) / 1e9 for g0, g1 in gaps[:2]]
    reading = runner.Reading(
        trace=tr, trace_offset_ns=off, traffic={"entry": entry},
        spans={"gc": spans(40, 2e-4) + [(mids[0] - 1e-5, mids[0], 2)],
               "graph_capture": [(mids[1], mids[1] + 1e-5, 3)],
               "engine": spans(400, 1e-3)},
        profiled=[(s, e, 64, True) for s, e, _ in spans(300, 3e-3)])
    got, want = runner._breakdown(reading), breakdown_by_loop(reading)
    assert got == want
    assert {k for k, _ in got["idle_gaps"]} == {
        "gc", "hnsw graph capture", "engine host work (dispatch, drain)",
        "result assembly and facade" if entry == "knn_batch"
        else "executor, dynbatch and assembly", "client loop"}

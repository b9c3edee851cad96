"""Persistence of reindexer_tpu_torch vs reindexer_tpu, on the CPU.

Both storage engines of the port (the JSONL engine behind a plain path or
`builtin://`, the sqlite engine behind `sqlite://`) are driven through the
public API: flush and reopen, WAL replay after a crash (the database object
dropped without `close()`), a torn WAL tail, `repair_storage`, drop and
rename, a stale ANN cache stamp, `drop_ann_storage_cache`, and a storage
root written by one package and opened by the other (directly and through
`convert.storage_from_reference`).

The namespace holds every engine: scalar indexes, a `text` index, a fp32
`vec_bf` field, an SQ8 `vec_bf` field, an HNSW field and an IVF field,
N = 240 rows of dimension 8 made from a seed.

Tolerances, with their reasons:
  - one package before and after a restart: the same code on the same
    rows, so ids equal (tied ranks as sets) and ranks within rtol 1e-5, the
    issue's bound for fp32 rounding;
  - the port against the reference: ids equal except between near-ties
    at the k-th rank, ranks within rtol 1e-5 / atol 1e-6, except the IVF
    field (rtol / atol 1e-4, tests/test_torch_ivf.py's bound for the
    reference's masked sweep) and the text field (atol 1e-4 on the 0-255
    scale: the same BM25 sums in another order, tests/test_torch_ft.py);
  - the SQ8 field runs mode "approx" across packages (ranks are quantized
    scores, the same integer dots), because the reference's mode "exact"
    is not exact off a TPU (tests/test_torch_sq8.py
    ::test_reference_exact_sq8_off_tpu_is_not_exact);
  - an HNSW index loaded from the ANN cache has the saved link tables, equal
    row for row; one rebuilt because the cache was disabled must reach
    recall@10 >= 0.95 at ef 64 against the float64 oracle (PERF.md §2).
"""
import json
import os
import shutil

import numpy as np
import pytest
import torch

import reindexer_tpu_torch as port
from reindexer_tpu_torch.convert import storage_from_reference
from reindexer_tpu_torch.storage import ann_cache as port_ann_cache
from reindexer_tpu_torch.storage.engine import (FileStorage, SqliteStorage,
                                                repair_storage)

torch.set_num_threads(2)

RTOL, ATOL = 1e-5, 1e-6
IVF_TOL = 1e-4
FT_ATOL = 1e-4
HNSW_MIN_RECALL = 0.95
N, D, K = 240, 8, 10
ENGINES = ("file", "builtin", "sqlite")
FIELDS = ("scalar", "bf", "sq", "hn", "iv", "txt", "hybrid")
# every field but SQ8 approx. Its quantization grid is not in the ANN cache
# (in either package), so a restart quantizes the rows afresh, and the
# packages' approx scans differ off a TPU (the reference's public API scores
# fp32 queries against the codes, the port's int8 queries, as the reference
# does on a TPU): a reopened SQ8 field is held against a fresh database of
# its own package over the same documents
EXACT_FIELDS = ("scalar", "bf", "hn", "iv", "txt", "hybrid")


def _ref():
    import reindexer_tpu
    return reindexer_tpu


def _pkg(name):
    return port if name == "port" else _ref()


def _dsn(engine, path):
    return {"file": str(path), "builtin": f"builtin://{path}",
            "sqlite": f"sqlite://{path}"}[engine]


def _open(pkg, dsn):
    return pkg.Reindexer(dsn, device="cpu") if pkg is port \
        else pkg.Reindexer(dsn)


def _defs(pkg, sq_mode="approx"):
    vo, L2 = pkg.FloatVectorOpts, pkg.VectorMetric.L2
    return [
        pkg.IndexDef("id", "hash", "int", opts=pkg.IndexOpts(is_pk=True)),
        pkg.IndexDef("grp", "hash", "int"),
        pkg.IndexDef("name", "tree", "string"),
        pkg.IndexDef("txt", "text", "string"),
        pkg.IndexDef("bf", "vec_bf", vector_opts=vo(dims=D, metric=L2)),
        pkg.IndexDef("sq", "vec_bf", vector_opts=vo(
            dims=D, metric=L2, quantization=pkg.QuantizationConfig(
                enabled=True, min_elements=16, mode=sq_mode))),
        pkg.IndexDef("hn", "hnsw", vector_opts=vo(
            dims=D, metric=pkg.VectorMetric.INNER_PRODUCT, m=8,
            ef_construction=32)),
        pkg.IndexDef("iv", "ivf", vector_opts=vo(
            dims=D, metric=pkg.VectorMetric.COSINE, centroids_count=4))]


def _data(seed=0, n=N):
    rng = np.random.default_rng(seed)
    base = rng.normal(size=(n, D)).astype(np.float32)
    words = [f"w{i}" for i in range(12)]
    texts = [" ".join(words[j] for j in rng.integers(0, 12, size=4))
             for _ in range(n)]
    return base, texts, rng.normal(size=(4, D)).astype(np.float32)


def _doc(i, vec, text):
    v = [float(x) for x in vec]
    return {"id": i, "grp": i % 5, "name": f"n{i:03d}", "txt": text,
            "bf": v, "sq": v, "hn": v, "iv": v}


def _fill(db, base, texts, sq_mode="approx", pkg=port):
    db.open_namespace("ns", _defs(pkg, sq_mode))
    for i in range(len(base)):
        db.upsert("ns", _doc(i, base[i], texts[i]))


def _after_flush_writes(db, base, texts):
    """Writes that land only in the WAL: upserts of existing rows (moved
    vectors and new texts), deletes, new rows, meta."""
    rng = np.random.default_rng(99)
    for i in range(0, 30, 3):
        db.upsert("ns", _doc(i, base[i] + 3.0, texts[i] + " w0"))
    for i in range(1, 30, 5):
        db.delete("ns", {"id": i})
    for i in range(N, N + 12):
        db.upsert("ns", _doc(i, rng.normal(size=D), "w1 w2"))
    db.put_meta("ns", "k", "v")


def _warm_vectors(pkg, db, queries):
    """Build and quantize every vector field before a flush. The text
    field is left unbuilt: a text index built before later writes scores
    them in incremental steps with their own statistics (the reference's
    design, index/text.py commit), so its ranks would differ from the full
    rebuild a restart makes."""
    for f in ("bf", "sq", "hn", "iv"):
        db.select(pkg.Query("ns").where_knn(f, queries[0],
                                            pkg.KnnSearchParams(k=K)))


def _answers(pkg, db, queries):
    """{tag: [(ids, ranks)]} of every engine's select for each query."""
    Q, params = pkg.Query, {
        "bf": pkg.KnnSearchParams(k=K), "sq": pkg.KnnSearchParams(k=K),
        "hn": pkg.HnswSearchParams(k=K, ef=64),
        "iv": pkg.IvfSearchParams(k=K, nprobe=2)}

    def pair(res):
        return [d["id"] for d in res.docs()], np.asarray(res.ranks(), float)

    out = {"scalar": [pair(db.select(Q("ns").where("grp", "=", 2)
                                     .sort("name").limit(15)))],
           "txt": [pair(db.select(Q("ns").match("txt", w)))
                   for w in ("w3", "w5 w7", "w0")]}
    for f, p in params.items():
        out[f] = [pair(db.select(Q("ns").where_knn(f, q, p)))
                  for q in queries]
    out["hybrid"] = [pair(db.select(
        Q("ns").match("txt", "w3").where_knn("bf", queries[0],
                                             pkg.KnnSearchParams(k=20))
        .sort("RRF()", desc=True).limit(10)))]
    return out


def assert_same(want, got, rtol=RTOL, atol=ATOL, tag=""):
    """ids equal up to permutations of tied ranks and near-ties at the
    k-th rank; ranks within rtol / atol, position by position and id by
    id."""
    ids_w, r_w = want
    ids_g, r_g = got
    assert len(ids_g) == len(ids_w), (tag, ids_w, ids_g)
    np.testing.assert_allclose(r_g, r_w, rtol=rtol, atol=atol, err_msg=tag)
    if np.isnan(r_w).all():          # no ranks (a scalar query): same order
        assert ids_g == ids_w, tag
        return
    rank_w, rank_g = dict(zip(ids_w, r_w)), dict(zip(ids_g, r_g))
    for i in set(ids_w) & set(ids_g):
        assert abs(rank_w[i] - rank_g[i]) <= rtol * abs(rank_w[i]) + atol, \
            (tag, i)
    if ids_w:
        edge = r_w[-1]
        for i in set(ids_w) ^ set(ids_g):
            r = rank_w.get(i, rank_g.get(i))
            assert abs(r - edge) <= rtol * abs(edge) + atol, (tag, i)


def assert_same_answers(want, got, fields=FIELDS, cross=False):
    for f in fields:
        rtol, atol = RTOL, ATOL
        if cross and f == "iv":
            rtol = atol = IVF_TOL
        if f in ("txt", "hybrid"):
            atol = FT_ATOL if cross else atol
        for j, (w, g) in enumerate(zip(want[f], got[f], strict=True)):
            assert_same(w, g, rtol, atol, f"{f}[{j}]")


LINKS_AT_LOAD = {}     # index name -> its links0 just after a cache load


def spy_ann_loads(monkeypatch, cache_cls):
    """Spy on cache_cls.load: returns [(namespace, index, applied)], and
    keeps an applied HNSW index's layer-0 links, as loaded, in
    LINKS_AT_LOAD."""
    calls = []
    orig = cache_cls.load
    LINKS_AT_LOAD.clear()

    def load(self, ns_name, index, items_count):
        ok = orig(self, ns_name, index, items_count)
        calls.append((ns_name, index.name, ok))
        if ok and hasattr(index, "_links0"):
            LINKS_AT_LOAD[index.name] = np.array(index._links0)
        return ok
    monkeypatch.setattr(cache_cls, "load", load)
    return calls


@pytest.fixture
def ann_loads(monkeypatch):
    return spy_ann_loads(monkeypatch, port_ann_cache.AnnStorageCache)


def _recall(pkg, db, base_alive, ids_alive, queries, field="hn"):
    """recall@K of the HNSW field against the float64 inner-product
    oracle over the live rows."""
    hits = 0
    for q in queries:
        s = base_alive.astype(np.float64) @ q.astype(np.float64)
        want = set(ids_alive[np.argsort(-s, kind="stable")[:K]].tolist())
        res = db.select(pkg.Query("ns").where_knn(
            field, q, pkg.HnswSearchParams(k=K, ef=64)))
        hits += len(want & {d["id"] for d in res.docs()})
    return hits / (K * len(queries))


# --- 1. each engine: flush and reopen, crash and WAL replay ---------------

@pytest.mark.parametrize("engine", ENGINES)
def test_flush_and_reopen(tmp_path, engine, ann_loads):
    base, texts, qs = _data()
    dsn = _dsn(engine, tmp_path / "db")
    db = _open(port, dsn)
    assert isinstance(db.storage, SqliteStorage if engine == "sqlite"
                      else FileStorage)
    _fill(db, base, texts)
    live = _answers(port, db, qs)
    db.close()
    db2 = _open(port, dsn)
    assert db2.get_meta("ns", "k") is None
    assert_same_answers(live, _answers(port, db2, qs))
    assert sorted(i for _, i, ok in ann_loads if ok) == ["bf", "hn", "iv",
                                                         "sq"]
    assert db2.storage.load_report["ns"]["ann_applied"] == ["bf", "sq", "hn",
                                                            "iv"]
    db2.close()


@pytest.mark.parametrize("engine", ENGINES)
def test_wal_replay_after_crash(tmp_path, engine, ann_loads):
    """A flush, then WAL-only writes (upserts of existing rows included),
    then the database object is dropped without close(): the reopened
    database answers as the live one did, with the ANN cache applied under
    the replayed WAL."""
    base, texts, qs = _data()
    dsn = _dsn(engine, tmp_path / "db")
    db = _open(port, dsn)
    _fill(db, base, texts)
    _warm_vectors(port, db, qs)
    db.flush()
    _after_flush_writes(db, base, texts)
    live = _answers(port, db, qs)
    del db                          # a crash: no close(), no flush
    db2 = _open(port, dsn)
    assert db2.get_meta("ns", "k") == "v"
    assert all(ok for _, _, ok in ann_loads) and len(ann_loads) == 4
    assert_same_answers(live, _answers(port, db2, qs))


def test_torn_wal_tail_and_snapshot_line(tmp_path):
    """A torn WAL append and a corrupt snapshot line are skipped, counted in
    the load report, and the rest loads (reference: repair_tool
    semantics)."""
    path = tmp_path / "db"
    db = _open(port, str(path))
    db.open_namespace("t", [port.IndexDef("id", "hash", "int",
                                          opts=port.IndexOpts(is_pk=True))])
    for i in range(5):
        db.upsert("t", {"id": i})
    db.flush()
    db.upsert("t", {"id": 5})
    db.storage.close()
    with open(path / "t" / "wal.jsonl", "a", encoding="utf-8") as f:
        f.write('{"op": "upsert", "doc": {"id": 6')
    with open(path / "t" / "items.jsonl", "a", encoding="utf-8") as f:
        f.write('{"id": 7, broken\n')
    db2 = _open(port, str(path))
    got = sorted(d["id"] for d in db2.select(port.Query("t")).docs())
    assert got == [0, 1, 2, 3, 4, 5]
    assert db2.storage.load_report["t"]["skipped"] == 2


@pytest.mark.parametrize("pkg_name", ["ref", "port"])
def test_repair_storage_matches_reference(tmp_path, pkg_name):
    """The same broken storage (a quarantined meta.json, a torn WAL line, a
    corrupt snapshot line), written by either package, is repaired by the
    port's repair_storage to the reference's report and files."""
    from reindexer_tpu.storage.engine import repair_storage as ref_repair
    pkg = _pkg(pkg_name)
    src = tmp_path / "src"
    db = _open(pkg, str(src))
    db.open_namespace("t", [pkg.IndexDef("id", "hash", "int",
                                         opts=pkg.IndexOpts(is_pk=True))])
    db.upsert("t", {"id": 1})
    db.flush()
    db.upsert("t", {"id": 2})
    db.storage.close()
    with open(src / "t" / "wal.jsonl", "a", encoding="utf-8") as f:
        f.write('{"op": "upsert", "doc": {"id": 3')
    with open(src / "t" / "items.jsonl", "a", encoding="utf-8") as f:
        f.write("not json\n")
    with open(src / "t" / "meta.json", "w", encoding="utf-8") as f:
        f.write("{broken")
    shutil.copytree(src, tmp_path / "a")
    shutil.copytree(src, tmp_path / "b")
    got = repair_storage(str(tmp_path / "a"))
    want = ref_repair(str(tmp_path / "b"))
    assert got == want and not got["t"]["ok"]
    assert got["t"]["quarantined"] == ["meta.json"]
    for name in ("items.jsonl", "wal.jsonl", "meta.json.broken"):
        assert (tmp_path / "a" / "t" / name).read_text() == \
            (tmp_path / "b" / "t" / name).read_text()
    db2 = _open(port, str(tmp_path / "a"))
    assert sorted(d["id"] for d in db2.select(port.Query("t")).docs()) == \
        [1, 2]


@pytest.mark.parametrize("engine", ENGINES)
def test_drop_and_rename(tmp_path, engine):
    dsn = _dsn(engine, tmp_path / "db")
    db = _open(port, dsn)
    for name in ("a", "c"):
        db.open_namespace(name, [port.IndexDef(
            "id", "hash", "int", opts=port.IndexOpts(is_pk=True))])
        db.upsert(name, {"id": 1})
    db.flush()
    db.rename_namespace("a", "b")
    db.upsert("b", {"id": 2})
    db.drop_namespace("c")
    del db
    db2 = _open(port, dsn)
    assert db2.namespace_names() == ["b"]
    assert sorted(d["id"] for d in db2.select(port.Query("b")).docs()) == \
        [1, 2]


@pytest.mark.reference_divergence
@pytest.mark.parametrize("engine", ["file", "sqlite"])
def test_reference_rename_keeps_the_old_wal_name(tmp_path, engine):
    """The reference's WAL hook binds the namespace's name when it is
    attached (reindexer_tpu/storage/engine.py attach_namespace), so a write
    to a renamed namespace goes under the old name: the JSONL engine fails
    to open the moved directory's WAL, the sqlite engine logs the write
    under the old name, and the database then fails to reopen (a WAL-only
    namespace with no index definitions). The port's hook reads the
    current name (test_drop_and_rename)."""
    ref = _ref()
    dsn = _dsn(engine, tmp_path / "db")
    db = ref.Reindexer(dsn)
    db.open_namespace("a", [ref.IndexDef("id", "hash", "int",
                                         opts=ref.IndexOpts(is_pk=True))])
    db.upsert("a", {"id": 1})
    db.flush()
    db.rename_namespace("a", "b")
    if engine == "file":
        with pytest.raises(FileNotFoundError):
            db.upsert("b", {"id": 2})
        return
    db.upsert("b", {"id": 2})
    del db
    with pytest.raises(ref.ParamsError, match="'a' has no PK index"):
        ref.Reindexer(dsn)


@pytest.mark.parametrize("engine", ENGINES)
def test_stale_ann_stamp_dropped(tmp_path, engine, ann_loads):
    """A cache whose stamp no longer matches the snapshot (its item count
    changed under it) is dropped and the index rebuilds: the new row is
    found and the file is gone."""
    base, texts, qs = _data()
    dsn = _dsn(engine, tmp_path / "db")
    db = _open(port, dsn)
    _fill(db, base, texts)
    db.flush()
    cache = db.storage.ann_cache
    cache_file = cache._path("ns", "hn")
    db.upsert("ns", _doc(N, np.full(D, 9.0), "w1"))
    db.flush()                       # snapshot of N + 1 rows
    # the older state comes back: its stamp says N rows
    db2_src = _open(port, _dsn(engine, tmp_path / "old"))
    _fill(db2_src, base, texts)
    db2_src.flush()
    shutil.copy(db2_src.storage.ann_cache._path("ns", "hn"), cache_file)
    del db, db2_src
    ann_loads.clear()
    db3 = _open(port, dsn)
    assert ("ns", "hn", False) in ann_loads
    assert not os.path.exists(cache_file)
    res = db3.select(port.Query("ns").where_knn(
        "hn", np.full(D, 9.0, np.float32), port.HnswSearchParams(k=1, ef=32)))
    assert res.docs()[0]["id"] == N


@pytest.mark.parametrize("engine", ENGINES)
def test_drop_ann_storage_cache(tmp_path, engine, ann_loads):
    """The drop_ann_storage_cache action removes one index's cache file or
    a namespace's; the next open rebuilds those indexes and answers the
    same."""
    base, texts, qs = _data()
    dsn = _dsn(engine, tmp_path / "db")
    db = _open(port, dsn)
    _fill(db, base, texts)
    db.flush()
    live = _answers(port, db, qs)
    cache = db.storage.ann_cache
    files = sorted(os.listdir(cache.dir))
    assert files == [f"ns__{f}.npz" for f in ("bf", "hn", "iv", "sq")]
    db.upsert("#config", {"type": "action", "action": {
        "command": "drop_ann_storage_cache", "namespace": "ns",
        "index": "iv"}})
    assert sorted(os.listdir(cache.dir)) == [f for f in files
                                             if f != "ns__iv.npz"]
    db.upsert("#config", {"type": "action", "action": {
        "command": "drop_ann_storage_cache", "namespace": "ns"}})
    assert os.listdir(cache.dir) == []
    del db
    db2 = _open(port, dsn)
    assert ann_loads and not any(ok for _, _, ok in ann_loads)
    assert db2.storage.load_report["ns"]["ann_applied"] == []
    assert_same_answers(live, _answers(port, db2, qs),
                        fields=("scalar", "bf", "txt", "hybrid"))
    for j, (w, g) in enumerate(zip(live["iv"], _answers(port, db2, qs)["iv"])):
        assert len(g[0]) == len(w[0]), j  # IVF retrained: same size answers


def test_ann_cache_disabled_rebuilds_hnsw_to_recall(tmp_path, monkeypatch,
                                                    ann_loads):
    """With RX_TPU_DISABLE_ANN_CACHE=1 nothing is written or loaded; the
    HNSW index rebuilt on reopen reaches the recall@10 gate."""
    monkeypatch.setenv("RX_TPU_DISABLE_ANN_CACHE", "1")
    base, texts, qs = _data()
    db = _open(port, str(tmp_path / "db"))
    _fill(db, base, texts)
    db.close()
    assert not os.path.exists(tmp_path / "db" / "ann_cache")
    db2 = _open(port, str(tmp_path / "db"))
    assert ann_loads and not any(ok for _, _, ok in ann_loads)
    queries = np.random.default_rng(5).normal(size=(16, D)).astype(np.float32)
    assert _recall(port, db2, base, np.arange(N), queries) >= HNSW_MIN_RECALL


# --- 2. the ANN cache and restart state on the device -------------------

@pytest.mark.parametrize("engine", ["file", "sqlite"])
def test_hnsw_cache_restores_link_tables(tmp_path, engine, ann_loads):
    base, texts, qs = _data()
    dsn = _dsn(engine, tmp_path / "db")
    db = _open(port, dsn)
    _fill(db, base, texts)
    saved = db.get_namespace("ns").get_index("hn").state_dict()
    db.close()
    db2 = _open(port, dsn)
    ix = db2.get_namespace("ns").get_index("hn")
    assert ("ns", "hn", True) in ann_loads and not ix._pending
    np.testing.assert_array_equal(ix._links0, saved["links0"])
    assert len(ix._upper) == len(saved["upper"])
    for a, b in zip(ix._upper, saved["upper"]):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(ix._levels, saved["levels"])
    assert (ix._entry, ix._max_level) == (saved["entry"], saved["max_level"])


@pytest.mark.parametrize("mode", ["exact", "approx", "approx_rerank"])
@pytest.mark.parametrize("kind", ["vec_bf", "hnsw"])
def test_sq8_codes_fresh_after_restart_and_wal_upsert(tmp_path, kind, mode):
    """An SQ8 field queried (so quantized) before the flush, then a WAL
    upsert of an existing row (the count unchanged): the live database and
    the restarted one both answer from fresh codes, and find the moved row
    first. The reference keeps stale codes there, live
    (test_reference_sq8_keeps_stale_codes_on_upsert)."""
    rng = np.random.default_rng(3)
    base = rng.normal(size=(300, D)).astype(np.float32)
    target = np.full(D, 1.5, np.float32)
    dsn = str(tmp_path / "db")
    db = _open(port, dsn)
    db.open_namespace("v", [
        port.IndexDef("id", "hash", "int", opts=port.IndexOpts(is_pk=True)),
        port.IndexDef("q", kind, vector_opts=port.FloatVectorOpts(
            dims=D, metric=port.VectorMetric.L2,
            quantization=port.QuantizationConfig(enabled=True,
                                                 min_elements=16,
                                                 mode=mode)))])
    for i in range(300):
        db.upsert("v", {"id": i, "q": base[i].tolist()})

    def top(d):
        res = d.select(port.Query("v").where_knn("q", target,
                                                 port.KnnSearchParams(k=3)))
        return [x["id"] for x in res.docs()], np.asarray(res.ranks(), float)

    before = top(db)
    assert 7 not in before[0]
    db.flush()
    db.upsert("v", {"id": 7, "q": target.tolist()})
    live = top(db)
    del db
    db2 = _open(port, dsn)
    assert live[0][0] == 7
    assert_same(live, top(db2))


@pytest.mark.reference_divergence
def test_reference_sq8_keeps_stale_codes_on_upsert():
    """The reference's SQ8 store re-encodes only when the keeper's count
    moved (reindexer_tpu/index/vector/quantization.py need_refresh), so an
    approx field queried before an upsert of an existing row keeps the old
    codes and misses the moved row; the port's keeper version makes it
    re-encode (test_sq8_codes_fresh_after_restart_and_wal_upsert)."""
    ref = _ref()
    rng = np.random.default_rng(3)
    base = rng.normal(size=(300, D)).astype(np.float32)
    target = np.full(D, 1.5, np.float32)
    tops = {}
    for name, pkg in (("ref", ref), ("port", port)):
        db = _open(pkg, "")
        db.open_namespace("v", [
            pkg.IndexDef("id", "hash", "int", opts=pkg.IndexOpts(is_pk=True)),
            pkg.IndexDef("q", "vec_bf", vector_opts=pkg.FloatVectorOpts(
                dims=D, metric=pkg.VectorMetric.L2,
                quantization=pkg.QuantizationConfig(
                    enabled=True, min_elements=16, mode="approx")))])
        for i in range(300):
            db.upsert("v", {"id": i, "q": base[i].tolist()})
        q = pkg.Query("v").where_knn("q", target, pkg.KnnSearchParams(k=3))
        db.select(q)
        db.upsert("v", {"id": 7, "q": target.tolist()})
        tops[name] = [d["id"] for d in db.select(q).docs()]
    assert tops["port"][0] == 7
    assert 7 not in tops["ref"]


@pytest.mark.parametrize("field", ["iv", "hn"])
def test_ivf_and_hnsw_state_after_cache_load_and_wal(tmp_path, field):
    """IVF's CSR (`_csr_dirty`) and HNSW's device mirrors (`_full_sync`)
    are rebuilt after the cache load and the WAL's upserts of existing rows
    and new rows: the restarted index answers as the live one."""
    base, texts, qs = _data()
    dsn = str(tmp_path / "db")
    db = _open(port, dsn)
    _fill(db, base, texts)
    _warm_vectors(port, db, qs)
    db.flush()
    _after_flush_writes(db, base, texts)
    moved = base[0] + 3.0
    queries = np.concatenate([qs, moved[None], base[N - 1:N]])
    live = _answers(port, db, queries)
    if field == "iv":               # cosine: the moved row is its own best
        assert live[field][len(qs)][0][0] == 0
    del db
    db2 = _open(port, dsn)
    ix = db2.get_namespace("ns").get_index(field)
    assert getattr(ix, "_csr_dirty" if field == "iv" else "_full_sync")
    assert_same_answers(live, _answers(port, db2, queries), fields=(field,))


# --- 3. across packages ---------------------------------------------------

def _fresh_copy(pkg, base, texts):
    """An in-memory database of `pkg` that took the writes of
    _write_and_crash, first queried after the last of them."""
    fresh = _open(pkg, "")
    _fill(fresh, base, texts, pkg=pkg)
    _after_flush_writes(fresh, base, texts)
    return fresh


def _write_and_crash(pkg, dsn, base, texts, qs):
    """Fill, query, flush, write to the WAL, then drop without close().
    Returns the live answers taken before the drop and the HNSW state."""
    db = _open(pkg, dsn)
    _fill(db, base, texts, pkg=pkg)
    _warm_vectors(pkg, db, qs)
    db.flush()
    hn_state = db.get_namespace("ns").get_index("hn").state_dict()
    _after_flush_writes(db, base, texts)
    return _answers(pkg, db, qs), hn_state


@pytest.mark.parametrize("via", ["direct", "convert"])
@pytest.mark.parametrize("engine", ["file", "sqlite"])
def test_reference_storage_opens_in_port(tmp_path, engine, via, ann_loads):
    ref = _ref()
    base, texts, qs = _data()
    src = tmp_path / "ref_db"
    live, hn_state = _write_and_crash(ref, _dsn(engine, src), base, texts, qs)
    again = tmp_path / "ref_again"
    shutil.copytree(src, again)
    path = src
    if via == "convert":
        path = tmp_path / "port_db"
        report = storage_from_reference(str(src), str(path))
        assert report["dropped"] == {}
        assert sorted(report["kept"]) == [
            os.path.join("ann_cache", f"ns__{f}.npz")
            for f in ("bf", "hn", "iv", "sq")]
    db = _open(port, _dsn(engine, path))
    assert sorted((i, ok) for _, i, ok in ann_loads) == [
        ("bf", True), ("hn", True), ("iv", True), ("sq", True)]
    np.testing.assert_array_equal(LINKS_AT_LOAD["hn"], hn_state["links0"])
    assert db.get_meta("ns", "k") == "v"
    got = _answers(port, db, qs)
    assert_same_answers(live, got, fields=EXACT_FIELDS, cross=True)
    assert_same_answers(_answers(ref, _open(ref, _dsn(engine, again)), qs),
                        got, fields=EXACT_FIELDS, cross=True)
    assert_same_answers(_answers(port, _fresh_copy(port, base, texts), qs), got,
                        fields=("sq",))


@pytest.mark.parametrize("engine", ["file", "sqlite"])
def test_port_storage_opens_in_reference(tmp_path, engine, monkeypatch):
    ref = _ref()
    from reindexer_tpu.storage import ann_cache as ref_ann_cache
    applied = spy_ann_loads(monkeypatch, ref_ann_cache.AnnStorageCache)
    base, texts, qs = _data()
    dsn = _dsn(engine, tmp_path / "db")
    live, hn_state = _write_and_crash(port, dsn, base, texts, qs)
    again = tmp_path / "port_again"
    shutil.copytree(tmp_path / "db", again)
    db = ref.Reindexer(dsn)
    assert sorted((i, ok) for _, i, ok in applied) == [
        ("bf", True), ("hn", True), ("iv", True), ("sq", True)]
    np.testing.assert_array_equal(LINKS_AT_LOAD["hn"], hn_state["links0"])
    assert db.get_meta("ns", "k") == "v"
    got = _answers(ref, db, qs)
    assert_same_answers(live, got, fields=EXACT_FIELDS, cross=True)
    assert_same_answers(_answers(port, _open(port, _dsn(engine, again)), qs),
                        got, fields=EXACT_FIELDS, cross=True)
    assert_same_answers(_answers(ref, _fresh_copy(ref, base, texts), qs), got,
                        fields=("sq",))


def test_ann_cache_files_are_the_references(tmp_path):
    """The same rows through both packages write cache files with the same
    arrays and the same metadata (stamp included) for vec_bf and HNSW."""
    ref = _ref()
    base, texts, _ = _data()
    files = {}
    for name, pkg in (("ref", ref), ("port", port)):
        db = _open(pkg, str(tmp_path / name))
        _fill(db, base, texts, pkg=pkg)
        db.close()
        files[name] = tmp_path / name / "ann_cache"
    for f in ("ns__bf.npz", "ns__hn.npz"):
        with np.load(files["ref"] / f) as a, np.load(files["port"] / f) as b:
            assert sorted(a.files) == sorted(b.files)
            assert json.loads(bytes(a["__meta__"])) == \
                json.loads(bytes(b["__meta__"]))
            for key in a.files:
                if key != "__meta__":
                    np.testing.assert_array_equal(b[key], a[key],
                                                  err_msg=key)


def test_storage_from_reference_drops_a_bad_cache(tmp_path):
    """A cache file whose state fails its converter's check (HNSW links
    outside the table) or does not parse is removed; the others are kept;
    the port then rebuilds that index and answers."""
    ref = _ref()
    base, texts, qs = _data()
    src = tmp_path / "src"
    db = _open(ref, str(src))
    _fill(db, base, texts, pkg=ref)
    db.close()
    hn = src / "ann_cache" / "ns__hn.npz"
    with np.load(hn) as z:
        arrays = {k: z[k] for k in z.files}
    arrays["links0"] = np.full_like(arrays["links0"], 10 ** 6)
    np.savez(hn, **arrays)
    (src / "ann_cache" / "ns__iv.npz").write_bytes(b"not an npz")
    report = storage_from_reference(str(src), str(tmp_path / "dst"))
    assert sorted(report["dropped"]) == [
        os.path.join("ann_cache", "ns__hn.npz"),
        os.path.join("ann_cache", "ns__iv.npz")]
    assert "ParamsError" in report["dropped"][os.path.join("ann_cache",
                                                          "ns__hn.npz")]
    assert sorted(os.listdir(tmp_path / "dst" / "ann_cache")) == [
        "ns__bf.npz", "ns__sq.npz"]
    db2 = _open(port, str(tmp_path / "dst"))
    assert db2.storage.load_report["ns"]["ann_applied"] == ["bf", "sq"]
    assert _recall(port, db2, base, np.arange(N), qs) >= HNSW_MIN_RECALL


def test_dsn_and_storage_args_open_storage(tmp_path):
    """Reindexer(dsn) and Reindexer(storage=...) persist; an empty DSN is an
    in-memory database; the storage error of the removed seam is gone."""
    db = port.Reindexer(device="cpu")
    assert db.storage is None
    db.flush()
    st = FileStorage(str(tmp_path / "x"))
    db = port.Reindexer(storage=st, device="cpu")
    db.open_namespace("t", [port.IndexDef("id", "hash", "int",
                                          opts=port.IndexOpts(is_pk=True))])
    db.upsert("t", {"id": 4})
    db.close()
    assert [d["id"] for d in _open(port, str(tmp_path / "x")).select(
        port.Query("t")).docs()] == [4]


# --- 4. a namespace with deleted rows at the flush ------------------------

def _fill_with_holes(pkg, dsn, base, texts, qs):
    """Fill, delete every 7th row (rows the snapshot drops), build every
    vector index, flush; returns the database and its live answers."""
    db = _open(pkg, dsn)
    _fill(db, base, texts, pkg=pkg)
    for i in range(0, N, 7):
        db.delete("ns", {"id": i})
    _warm_vectors(pkg, db, qs)
    db.flush()
    return db, _answers(pkg, db, qs)


@pytest.mark.parametrize("engine", ["file", "sqlite"])
def test_deleted_rows_before_flush_keep_the_cache_aligned(tmp_path, engine,
                                                          ann_loads):
    """The snapshot renumbers the rows of a namespace that had deleted
    rows; the cache written beside it is renumbered the same way
    (ann_cache.compact_rows), so every index's cache is applied and answers
    with the right documents, the HNSW graph included."""
    base, texts, qs = _data()
    dsn = _dsn(engine, tmp_path / "db")
    db, live = _fill_with_holes(port, dsn, base, texts, qs)
    del db
    db2 = _open(port, dsn)
    assert sorted(i for _, i, ok in ann_loads if ok) == ["bf", "hn", "iv",
                                                         "sq"]
    assert_same_answers(live, _answers(port, db2, qs), fields=EXACT_FIELDS)


@pytest.mark.reference_divergence
def test_reference_cache_after_deleted_rows_answers_wrong_documents(
        tmp_path):
    """The reference writes its cache with the live row numbers and the
    snapshot without the deleted rows, so after a reload the cached vector
    of row r answers for the document now at row r: the nearest document to
    row 5's vector comes back as document 6 (one row deleted before it).
    The port answers document 5 (test_deleted_rows_before_flush_...)."""
    got = {}
    for name in ("ref", "port"):
        pkg = _pkg(name)
        dsn = str(tmp_path / name)
        db = _open(pkg, dsn)
        db.open_namespace("v", [
            pkg.IndexDef("id", "hash", "int", opts=pkg.IndexOpts(is_pk=True)),
            pkg.IndexDef("vec", "vec_bf", vector_opts=pkg.FloatVectorOpts(
                dims=2, metric=pkg.VectorMetric.L2))])
        for i in range(10):
            db.upsert("v", {"id": i, "vec": [float(i), 0.0]})
        db.delete("v", {"id": 2})
        db.flush()
        del db
        res = _open(pkg, dsn).select(pkg.Query("v").where_knn(
            "vec", np.array([5.0, 0.0], np.float32),
            pkg.KnnSearchParams(k=1)))
        got[name] = [d["id"] for d in res.docs()]
    assert got == {"ref": [6], "port": [5]}


def test_reference_cache_after_deleted_rows_is_dropped_by_the_port(
        tmp_path, ann_loads):
    """A reference storage root whose caches were written with the live row
    numbers (deleted rows before the flush) opens in the port with every
    vector cache dropped as stale (its rows holding a vector are not the
    snapshot's) and rebuilt: the exact answers are the live reference's, the
    rebuilt HNSW reaches its recall gate."""
    ref = _ref()
    base, texts, qs = _data()
    db, live = _fill_with_holes(ref, str(tmp_path / "db"), base, texts, qs)
    del db
    db2 = _open(port, str(tmp_path / "db"))
    assert ann_loads and not any(ok for _, _, ok in ann_loads)
    assert_same_answers(live, _answers(port, db2, qs),
                        fields=("scalar", "bf", "txt", "hybrid"), cross=True)
    alive = np.ones(N, bool)
    alive[::7] = False
    assert _recall(port, db2, base[alive], np.flatnonzero(alive), qs) >= \
        HNSW_MIN_RECALL


@pytest.mark.parametrize("engine", ["file", "sqlite"])
def test_port_cache_after_deleted_rows_opens_right_in_reference(
        tmp_path, engine, monkeypatch):
    """The port's renumbered cache is in the reference's format: the
    reference applies it and answers as the live port did."""
    ref = _ref()
    from reindexer_tpu.storage import ann_cache as ref_ann_cache
    applied = spy_ann_loads(monkeypatch, ref_ann_cache.AnnStorageCache)
    base, texts, qs = _data()
    dsn = _dsn(engine, tmp_path / "db")
    db, live = _fill_with_holes(port, dsn, base, texts, qs)
    del db
    db2 = ref.Reindexer(dsn)
    assert sorted(i for _, i, ok in applied if ok) == ["bf", "hn", "iv",
                                                       "sq"]
    assert_same_answers(live, _answers(ref, db2, qs),
                        fields=EXACT_FIELDS, cross=True)

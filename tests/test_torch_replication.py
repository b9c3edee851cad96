"""Async replication of reindexer_tpu_torch vs reindexer_tpu's, on the CPU.

Every replication test of tests/test_replication_events.py has a
counterpart here that runs the same scenario in each package (the port's
databases on `device="cpu"`) and holds the two outcomes equal: documents,
meta, data hashes (the port's item hash is the reference's, byte for byte)
and the replicator's `stats()` counts. The events tests of that file are
held in tests/test_torch_server.py, its resharding test in
tests/test_torch_sharding.py, and tests/test_cluster_tcp.py's cascade in
tests/test_torch_cluster.py.

Across packages: a port follower of a reference leader and a reference
follower of a port leader, over the in-process channel, HTTP and the
binary RPC, must end with the leader's documents, data hashes and KNN
answers (ids equal, ranks within rtol 1e-5: the same fp32 sums on the CPU).
Two faults of the reference follower that the port does not copy (a
dropped namespace stays, a renamed one takes its writes under the old name)
are shown on the reference and held fixed in the port
(`reference_divergence`).

Waits poll a deadline (`wait_sync`, `wait_until`) with generous limits; no test
sleeps for a fixed time to let a thread act.
"""
import threading

import numpy as np
import pytest
import torch
from _torch_pkgs import PKGS, Pkg, both, docs, hashes, wait_until

torch.set_num_threads(2)

RTOL = 1e-5
WAIT_S = 30.0
D = 4


def make_leader(pkg):
    db = pkg.db()
    state = pkg.mod("replication").ReplicationState(db)
    db.open_namespace("t", [
        pkg.IndexDef("id", "hash", "int", opts=pkg.IndexOpts(is_pk=True)),
        pkg.IndexDef("name", "hash", "string"),
    ])
    return db, state


def stats(repl):
    return {**repl.stats(), "chunks": repl.force_sync_chunks,
            "mismatches": repl.data_hash_mismatches}


# --- the reference's scenarios, in each package ---------------------------

def test_online_replication():
    def run(pkg):
        r = pkg.mod("replication")
        leader, state = make_leader(pkg)
        follower = pkg.db()
        repl = r.AsyncReplicator(follower, r.LeaderChannel(state))
        leader.upsert("t", {"id": 1, "name": "a"})
        leader.upsert("t", {"id": 2, "name": "b"})
        repl.sync_once()
        assert repl.wait_sync(state, timeout=WAIT_S)
        first = docs(follower, "t")
        assert [d["id"] for d in first] == [1, 2]
        leader.delete("t", {"id": 1})
        leader.put_meta("t", "k", "v")
        repl.sync_once()
        assert [d["id"] for d in docs(follower, "t")] == [2]
        assert follower.get_meta("t", "k") == "v"
        assert hashes(follower) == hashes(leader)
        return first, docs(follower, "t"), hashes(follower), stats(repl)
    both(run)


def test_force_sync_of_preexisting_leader_data():
    def run(pkg):
        r = pkg.mod("replication")
        db = pkg.db()
        db.open_namespace("t", [pkg.IndexDef(
            "id", "hash", "int", opts=pkg.IndexOpts(is_pk=True))])
        for i in range(5):
            db.upsert("t", {"id": i})
        state = r.ReplicationState(db)        # attached late
        follower = pkg.db()
        repl = r.AsyncReplicator(follower, r.LeaderChannel(state))
        repl.sync_once()
        assert repl.force_syncs == 1 and len(docs(follower, "t")) == 5
        db.upsert("t", {"id": 100})
        repl.sync_once()
        repl.sync_once()
        assert repl.force_syncs == 1 and len(docs(follower, "t")) == 6
        return docs(follower, "t"), hashes(follower), stats(repl)
    both(run)


def test_force_sync_after_ring_overflow():
    def run(pkg):
        r = pkg.mod("replication")
        leader, state = make_leader(pkg)
        state.wal.capacity = 10
        for i in range(50):
            leader.upsert("t", {"id": i, "name": str(i)})
        follower = pkg.db()
        repl = r.AsyncReplicator(follower, r.LeaderChannel(state))
        repl.sync_once()
        assert repl.force_syncs == 1 and len(docs(follower, "t")) == 50
        leader.upsert("t", {"id": 100, "name": "x"})
        repl.sync_once()
        assert repl.force_syncs == 1 and len(docs(follower, "t")) == 51
        return docs(follower, "t"), hashes(follower), stats(repl)
    both(run)


def test_replication_thread_and_cascade():
    def run(pkg):
        r = pkg.mod("replication")
        leader, state = make_leader(pkg)
        mid = pkg.db()
        mid_state = r.ReplicationState(mid)
        r1 = r.AsyncReplicator(mid, r.LeaderChannel(state), poll_interval=0.01)
        leaf = pkg.db()
        r2 = r.AsyncReplicator(leaf, r.LeaderChannel(mid_state),
                               poll_interval=0.01)
        r1.start()
        r2.start()
        try:
            for i in range(10):
                leader.upsert("t", {"id": i, "name": f"n{i}"})
            assert r1.wait_sync(state, timeout=WAIT_S)
            assert r2.wait_sync(mid_state, timeout=WAIT_S)
            assert wait_until(lambda: "t" in leaf.namespace_names()
                              and len(docs(leaf, "t")) == 10, WAIT_S)
            assert r1.stats()["applied"] > 0
        finally:
            r1.stop()
            r2.stop()
        assert hashes(leaf) == hashes(mid) == hashes(leader)
        return docs(leaf, "t"), hashes(leaf), stats(r1), stats(r2)
    both(run)


def test_replication_over_http():
    def run(pkg):
        r = pkg.mod("replication")
        srv = pkg.http_server()
        srv.start()
        try:
            leader = srv.mgr.create("rdb")
            r.ReplicationState(leader)
            leader.open_namespace("t", [pkg.IndexDef(
                "id", "hash", "int", opts=pkg.IndexOpts(is_pk=True))])
            leader.upsert("t", {"id": 1})
            leader.upsert("t", {"id": 2})
            follower = pkg.db()
            repl = r.AsyncReplicator(follower, r.HttpLeaderChannel(
                f"http://127.0.0.1:{srv.port}", "rdb"))
            repl.sync_once()
            assert [d["id"] for d in docs(follower, "t")] == [1, 2]
            return docs(follower, "t"), hashes(follower), stats(repl)
        finally:
            srv.stop()
    both(run)


def test_replicationstats_system_ns():
    def run(pkg):
        db = pkg.db()
        pkg.mod("replication").ReplicationState(db, server_id=5)
        db.open_namespace("r", [pkg.IndexDef(
            "id", "hash", "int", opts=pkg.IndexOpts(is_pk=True))])
        for i in range(4):
            db.upsert("r", {"id": i})
        rows = db.select(pkg.Query("#replicationstats")).docs()
        assert rows and rows[0]["server_id"] == 5
        assert rows[0]["last_lsn"] >= 4 and "r" in rows[0]["namespaces"]
        return rows
    both(run)


def test_chunked_force_sync_over_http_and_rpc():
    def run(pkg):
        r = pkg.mod("replication")
        srv = pkg.http_server()
        srv.start()
        rpc = pkg.rpc_server(srv.mgr)
        rpc.start()
        try:
            db = srv.mgr.create("repldb")
            db.open_namespace("t", [pkg.IndexDef(
                "id", "hash", "int", opts=pkg.IndexOpts(is_pk=True))])
            for i in range(2500):
                db.upsert("t", {"id": i})
            f1 = pkg.db()
            r1 = r.AsyncReplicator(f1, r.HttpLeaderChannel(
                f"http://127.0.0.1:{srv.port}", "repldb"))
            r1.SNAPSHOT_CHUNK = 400
            r1.sync_once()
            assert r1.force_syncs == 1 and r1.force_sync_chunks == 7
            f2 = pkg.db()
            r2 = r.AsyncReplicator(f2, r.RpcLeaderChannel(
                "127.0.0.1", rpc.port, "repldb"))
            r2.SNAPSHOT_CHUNK = 1000
            r2.sync_once()
            assert r2.force_sync_chunks == 3
            db.upsert("t", {"id": 9999})
            r1.sync_once()
            r2.sync_once()
            assert len(docs(f1, "t")) == len(docs(f2, "t")) == 2501
            assert r1.force_syncs == 1 and r2.force_syncs == 1
            assert hashes(f1) == hashes(f2) == hashes(db)
            return hashes(f1), stats(r1), stats(r2)
        finally:
            rpc.stop()
            srv.stop()
    both(run)


def test_snapshot_force_sync_under_load():
    """A force sync racing a writer thread converges in each package (the
    interleaving is the threads', so only the convergence is held, not
    equal outcomes)."""
    for name in PKGS:
        pkg = Pkg(name)
        r = pkg.mod("replication")
        db = pkg.db()
        db.open_namespace("t", [
            pkg.IndexDef("id", "hash", "int", opts=pkg.IndexOpts(is_pk=True)),
            pkg.IndexDef("name", "hash", "string")])
        for i in range(200):
            db.upsert("t", {"id": i, "name": f"n{i}"})
        state = r.ReplicationState(db)
        stop, errors = threading.Event(), []

        def writer():
            j = 200
            while not stop.is_set():
                try:
                    db.upsert("t", {"id": j % 400, "name": f"w{j}"})
                    if j % 7 == 0:
                        db.delete("t", {"id": (j * 13) % 200})
                    j += 1
                except Exception as e:          # surfaced below
                    errors.append(e)
                    return

        th = threading.Thread(target=writer, daemon=True)
        th.start()
        try:
            follower = pkg.db()
            repl = r.AsyncReplicator(follower, r.LeaderChannel(state))
            repl.sync_once()
            assert repl.force_syncs >= 1
            for _ in range(50):
                repl.sync_once()
        finally:
            stop.set()
            th.join(timeout=WAIT_S)
        assert not th.is_alive() and not errors, (name, errors)

        def converged():
            repl.sync_once()
            return ({d["id"]: d["name"] for d in docs(db, "t")}
                    == {d["id"]: d["name"] for d in docs(follower, "t")})
        assert wait_until(converged, WAIT_S), name
        assert hashes(follower) == hashes(db), name


def test_data_hash_divergence_forces_resync():
    def run(pkg):
        r = pkg.mod("replication")
        leader, state = make_leader(pkg)
        follower = pkg.db()
        repl = r.AsyncReplicator(follower, r.LeaderChannel(state))
        leader.upsert("t", {"id": 1, "name": "a"})
        leader.upsert("t", {"id": 2, "name": "b"})
        repl.sync_once()
        assert hashes(follower) == hashes(leader)
        follower.get_namespace("t").upsert({"id": 2, "name": "CORRUPT"})
        assert hashes(follower) != hashes(leader)
        repl.sync_once()
        repl.sync_once()
        assert repl.data_hash_mismatches == 1
        assert {d["id"]: d["name"] for d in docs(follower, "t")} == {
            1: "a", 2: "b"}
        assert hashes(follower) == hashes(leader)
        return docs(follower, "t"), hashes(follower), stats(repl)
    both(run)


def test_wal_query_matches_reference():
    """The WAL as a query (`#lsn > n`) reads the same records in each
    package, the replication state made lazily as the reference makes it."""
    def run(pkg):
        db = pkg.db()
        db.open_namespace("w", [pkg.IndexDef(
            "id", "hash", "int", opts=pkg.IndexOpts(is_pk=True))])
        pkg.mod("replication").ReplicationState(db)
        for i in range(4):
            db.upsert("w", {"id": i, "x": i * i})
        db.delete("w", {"id": 2})
        res = db.select(pkg.Query("w").where("#lsn", ">", 1))
        return res.docs()
    got = both(run)
    assert [d.get("op") for d in got][-1] == "delete", got


# --- across packages --------------------------------------------------------

def _vec_rows(n=60):
    rng = np.random.default_rng(3)
    v = rng.normal(size=(n, D)).astype(np.float32)
    return [{"id": i, "grp": i % 3, "vec": [float(x) for x in v[i]]}
            for i in range(n)]


def _vec_defs(pkg):
    return [pkg.IndexDef("id", "hash", "int", opts=pkg.IndexOpts(is_pk=True)),
            pkg.IndexDef("grp", "tree", "int"),
            pkg.IndexDef("vec", "vec_bf", vector_opts=pkg.FloatVectorOpts(
                dims=D, metric=pkg.VectorMetric.L2))]


def _leader_writes(pkg, db, step):
    """Writes of the leader: step 0 before the follower's first sync (it
    force-syncs them), step 1 after it (it replays them online)."""
    rows = _vec_rows()
    if step == 0:
        db.open_namespace("v", _vec_defs(pkg))
        for doc in rows[:40]:
            db.upsert("v", doc)
        return
    for doc in rows[40:]:
        db.upsert("v", doc)
    for i in (3, 7, 11):
        db.delete("v", {"id": i})
    db.upsert("v", {**rows[5], "grp": 9})
    db.put_meta("v", "k", "v1")
    db.add_index("v", pkg.IndexDef("name", "hash", "string"))
    db.upsert("v", {**rows[6], "name": "six"})
    db.open_namespace("s", [pkg.IndexDef(
        "id", "hash", "int", opts=pkg.IndexOpts(is_pk=True))])
    db.upsert("s", {"id": 1, "body": "x"})
    db.truncate_namespace("s")
    db.upsert("s", {"id": 2, "body": "y"})


def _answers(pkg, db):
    out = {}
    for qi, qv in enumerate(np.random.default_rng(5).normal(
            size=(4, D)).astype(np.float32)):
        res = db.select(pkg.Query("v").where_knn(
            "vec", qv, pkg.KnnSearchParams(k=7)))
        out[qi] = ([d["id"] for d in res.docs()], np.asarray(res.ranks()))
    return out


def _same_answers(got, want):
    for qi in want:
        assert got[qi][0] == want[qi][0], (qi, got[qi], want[qi])
        np.testing.assert_allclose(got[qi][1], want[qi][1], rtol=RTOL)


def _leader(leader_pkg, transport, stack):
    """The leader's database: in memory, or behind the package's HTTP
    server (and its RPC server) whose port is given."""
    if transport == "inproc":
        return leader_pkg.db(), None
    srv = leader_pkg.http_server()
    srv.start()
    stack.append(srv.stop)
    if transport == "http":
        return srv.mgr.create("ldb"), srv.port
    rpc = leader_pkg.rpc_server(srv.mgr)
    rpc.start()
    stack.append(rpc.stop)
    return srv.mgr.create("ldb"), rpc.port


def _channel(leader_pkg, follower_pkg, transport, db, port_no):
    """The follower package's channel to the leader's database; its
    replication state is made now, after the leader's first writes (over
    HTTP and RPC lazily, by the first request, as the reference makes it),
    so the follower force-syncs them."""
    r = follower_pkg.mod("replication")
    if transport == "inproc":
        return r.LeaderChannel(
            leader_pkg.mod("replication").ReplicationState(db))
    if transport == "http":
        return r.HttpLeaderChannel(f"http://127.0.0.1:{port_no}", "ldb")
    return r.RpcLeaderChannel("127.0.0.1", port_no, "ldb")


@pytest.mark.parametrize("transport", ["inproc", "http", "rpc"])
@pytest.mark.parametrize("leader,follower", [("ref", "port"),
                                             ("port", "ref")])
def test_follower_of_the_other_package(leader, follower, transport):
    """A follower of one package replicates a leader of the other: a
    chunked force sync, then online replay of upserts, deletes, meta, a new
    index, a truncate; its documents, meta, data hashes and KNN answers are
    the leader's."""
    lp, fp = Pkg(leader), Pkg(follower)
    stack = []
    try:
        ldb, port_no = _leader(lp, transport, stack)
        _leader_writes(lp, ldb, 0)
        chan = _channel(lp, fp, transport, ldb, port_no)
        fdb = fp.db()
        repl = fp.mod("replication").AsyncReplicator(fdb, chan)
        repl.SNAPSHOT_CHUNK = 16
        repl.sync_once()
        assert repl.force_syncs == 1 and repl.force_sync_chunks == 3
        _leader_writes(lp, ldb, 1)
        target = ldb._replication_state.wal.last_lsn
        repl.start()
        try:
            assert repl.wait_sync(target, timeout=WAIT_S)
        finally:
            repl.stop()
        assert repl.stats()["error"] is None and repl.force_syncs == 1
        assert sorted(fdb.namespace_names()) == sorted(ldb.namespace_names())
        for ns in ("v", "s"):
            assert docs(fdb, ns) == docs(ldb, ns), ns
            assert [d.to_dict() for d in fdb.get_namespace(ns).index_defs()] \
                == [d.to_dict() for d in ldb.get_namespace(ns).index_defs()]
        assert fdb.get_meta("v", "k") == "v1"
        assert hashes(fdb) == hashes(ldb)
        _same_answers(_answers(fp, fdb), _answers(lp, ldb))
    finally:
        for stop in reversed(stack):
            stop()


# --- the reference's faults, not copied -------------------------------------

def _drop_rename(pkg):
    """A leader with namespaces a, b; the follower syncs; the leader drops
    b, renames a to c and writes to c; the follower replays that."""
    r = pkg.mod("replication")
    idx = [pkg.IndexDef("id", "hash", "int", opts=pkg.IndexOpts(is_pk=True))]
    leader = pkg.db()
    state = r.ReplicationState(leader)
    for name in ("a", "b"):
        leader.open_namespace(name, idx)
        leader.upsert(name, {"id": 1, "ns": name})
    follower = pkg.db()
    repl = r.AsyncReplicator(follower, r.LeaderChannel(state))
    repl.sync_once()
    leader.drop_namespace("b")
    leader.rename_namespace("a", "c")
    leader.upsert("c", {"id": 99})
    for _ in range(3):
        repl.sync_once()
    return leader, follower, state, repl


@pytest.mark.reference_divergence
def test_reference_follower_keeps_dropped_and_renamed_namespaces():
    """The reference: the drop never reaches the follower, and the renamed
    namespace's writes ship under its old name, with no data-hash
    mismatch (replication.py `_REPLICATED_OPS`, `_hook`'s bound name)."""
    leader, follower, state, repl = _drop_rename(Pkg("ref"))
    assert sorted(leader.namespace_names()) == ["c"]
    assert sorted(follower.namespace_names()) == ["a", "b"]
    assert [d["id"] for d in docs(follower, "a")] == [1, 99]
    assert state.wal.since(0)[-1]["ns"] == "a"
    assert repl.data_hash_mismatches == 0


@pytest.mark.reference_divergence
def test_port_follower_equals_its_leader_after_drop_and_rename():
    """The port: the leader ships the drop and the rename as WAL records
    and the writes under the current name; after wait_sync the follower's
    namespace set, index definitions, documents and hashes are the
    leader's, without a force sync."""
    leader, follower, state, repl = _drop_rename(Pkg("port"))
    assert repl.wait_sync(state, timeout=WAIT_S)
    assert follower.namespace_names() == leader.namespace_names() == ["c"]
    assert docs(follower, "c") == docs(leader, "c") == [
        {"id": 1, "ns": "a"}, {"id": 99}]
    assert [d.to_dict() for d in follower.get_namespace("c").index_defs()] \
        == [d.to_dict() for d in leader.get_namespace("c").index_defs()]
    assert hashes(follower) == hashes(leader)
    assert [(r["ns"], r["op"]) for r in state.wal.since(0)[-3:]] == [
        ("b", "drop_namespace"), ("a", "rename_namespace"), ("c", "upsert")]
    assert repl.force_syncs == 0 and repl.data_hash_mismatches == 0


@pytest.mark.reference_divergence
def test_port_follower_of_reference_leader_converges_after_drop_and_rename():
    """A reference leader ships neither; the port follower counts the
    namespaces it took that the leader's data-hash map lacks as a mismatch
    and force-syncs (after two rounds, as any mismatch), dropping them."""
    ref, port = Pkg("ref"), Pkg("port")
    idx = [ref.IndexDef("id", "hash", "int", opts=ref.IndexOpts(is_pk=True))]
    leader = ref.db()
    state = ref.mod("replication").ReplicationState(leader)
    for name in ("a", "b"):
        leader.open_namespace(name, idx)
        leader.upsert(name, {"id": 1, "ns": name})
    follower = port.db()
    repl = port.mod("replication").AsyncReplicator(
        follower, port.mod("replication").LeaderChannel(state))
    repl.sync_once()
    leader.drop_namespace("b")
    leader.rename_namespace("a", "c")
    leader.upsert("c", {"id": 99})
    assert wait_until(lambda: repl.sync_once() or
                      sorted(follower.namespace_names()) == ["c"], WAIT_S)
    assert repl.data_hash_mismatches == 1 and repl.force_syncs == 1
    assert docs(follower, "c") == docs(leader, "c")
    assert hashes(follower) == hashes(leader)


def test_leader_hooks_namespaces_of_every_entry_point():
    """add_namespace, the HTTP route and a transaction reach the leader's
    log: its wrapper serves open_namespace and add_namespace alike, and a
    write to a namespace the database dropped ships nothing."""
    port = Pkg("port")
    r = port.mod("replication")
    db = port.db()
    state = r.ReplicationState(db)
    idx = [port.IndexDef("id", "hash", "int", opts=port.IndexOpts(
        is_pk=True))]
    db.add_namespace("n1", idx)
    tx = db.new_transaction("n1")
    tx.upsert({"id": 1})
    tx.commit()
    stale = db.get_namespace("n1")
    db.drop_namespace("n1")
    stale.upsert({"id": 2})
    assert [(r["ns"], r["op"]) for r in state.wal.since(0)] == [
        ("n1", "add_index"), ("n1", "upsert"), ("n1", "drop_namespace")]

"""The RAFT cluster of reindexer_tpu_torch vs reindexer_tpu's, on the CPU.

Every test of tests/test_cluster.py (in-process nodes) and of
tests/test_cluster_tcp.py (nodes over localhost sockets) has a counterpart
here that runs the same scenario in each package, the port's nodes built by
`make_cluster(3, device="cpu")` / `make_tcp_cluster(3, device="cpu")`.
Which node wins an election is the timers' choice, so the outcomes held
equal are the ones the scenario fixes: each node's documents after the
writes, roles, which writes a quorum refused. The RAFT frames are the
reference's, so a port `RpcPeer` drives a reference `ClusterServer` and a
reference `RpcPeer` a port one: the same verbs (raft_info, request_vote,
append_record, records_since, client_write) on nodes that are not started
(no timer runs) give the same answers.

Waits poll a deadline (`wait_leader`, `wait_until`) with limits well above
an election's 0.15-0.3 s, for a loaded test host.
"""
import threading
import time

import pytest
import torch
from _torch_pkgs import PKGS, Pkg, both, docs, wait_until

torch.set_num_threads(2)

WAIT_S = 30.0


def _idx(pkg):
    return [pkg.IndexDef("id", "hash", "int", opts=pkg.IndexOpts(is_pk=True))]


def _ids(node, ns):
    return [d["id"] for d in docs(node, ns)]


def _local(pkg, fn):
    """Run fn(pkg, nodes) on a started 3-node in-process cluster."""
    c = pkg.mod("cluster")
    nodes = c.make_cluster(3, **pkg.cpu())
    try:
        return fn(pkg, c, nodes)
    finally:
        for n in nodes:
            n.stop()


def _tcp(pkg, fn):
    """Run fn(pkg, nodes, servers) on a started 3-node socket cluster."""
    t = pkg.mod("net.cluster_transport")
    nodes, servers = t.make_tcp_cluster(3, **pkg.cpu())
    try:
        return fn(pkg, pkg.mod("cluster"), nodes, servers)
    finally:
        for n in nodes:
            n.stop()
        for s in servers:
            s.stop()


def _leader(c, nodes):
    leader = c.wait_leader(nodes, timeout=WAIT_S)
    assert leader is not None
    return leader


def _all_applied(nodes, ns, want):
    def ok():
        try:
            return all(_ids(n, ns) == want for n in nodes if n.alive)
        except Exception:
            return False
    return wait_until(ok, WAIT_S)


# --- tests/test_cluster.py, in each package ---------------------------------

def test_single_leader_elected():
    def run(pkg, c, nodes):
        leader = _leader(c, nodes)
        assert sum(1 for n in nodes if n.role == c.Role.LEADER) == 1
        info = leader.raft_info()
        assert info["role"] == "leader" and info["term"] >= 1
        return sorted(info), info["role"], info["alive"]
    both(lambda pkg: _local(pkg, run))


def test_write_through_any_node():
    def run(pkg, c, nodes):
        leader = _leader(c, nodes)
        follower = next(n for n in nodes if n.role != c.Role.LEADER)
        follower.open_namespace("c", _idx(pkg))
        follower.upsert("c", {"id": 1})
        leader.upsert("c", {"id": 2})
        got = [_ids(n, "c") for n in nodes]
        assert got == [[1, 2]] * 3, got
        return got, [n.commit_index for n in nodes]
    both(lambda pkg: _local(pkg, run))


def test_failover_reelection():
    def run(pkg, c, nodes):
        leader = _leader(c, nodes)
        leader.open_namespace("f", _idx(pkg))
        leader.upsert("f", {"id": 1})
        leader.kill()
        survivors = [n for n in nodes if n.alive]
        new_leader = _leader(c, survivors)
        assert new_leader is not leader
        new_leader.upsert("f", {"id": 2})
        got = [_ids(n, "f") for n in survivors]
        assert got == [[1, 2]] * 2
        return got
    both(lambda pkg: _local(pkg, run))


def test_no_quorum_rejects_writes():
    def run(pkg, c, nodes):
        leader = _leader(c, nodes)
        leader.open_namespace("q", _idx(pkg))
        for n in nodes:
            if n is not leader:
                n.kill()
        with pytest.raises(pkg.ReindexerError, match="quorum"):
            leader.upsert("q", {"id": 1})
        assert leader.select(pkg.Query("q")).docs() == []
        assert leader.applied_index == leader.commit_index
        return leader.commit_index, len(leader.log)
    both(lambda pkg: _local(pkg, run))


def test_stale_term_append_rejected():
    def run(pkg, c, nodes):
        leader = _leader(c, nodes)
        leader.open_namespace("s", _idx(pkg))
        leader.upsert("s", {"id": 1})
        follower = next(n for n in nodes if n.role != c.Role.LEADER)
        stale = c.LogRecord(index=len(follower.log) + 1,
                            term=follower.term - 1, ns="s", op="upsert",
                            payload={"doc": {"id": 99}})
        assert follower.append_record(stale) is False
        assert 99 not in _ids(follower, "s")
        return _ids(follower, "s")
    both(lambda pkg: _local(pkg, run))


def test_revived_node_catches_up():
    def run(pkg, c, nodes):
        leader = _leader(c, nodes)
        follower = next(n for n in nodes if n.role != c.Role.LEADER)
        leader.open_namespace("r", _idx(pkg))
        follower.kill()
        for i in range(5):
            leader.upsert("r", {"id": i})
        follower.revive()
        assert _all_applied([follower], "r", list(range(5)))
        return _ids(follower, "r")
    both(lambda pkg: _local(pkg, run))


def test_manual_leader_transfer():
    def run(pkg, c, nodes):
        old = _leader(c, nodes)
        target = next(n for n in nodes if n.server_id != old.server_id)
        old.db.upsert("#config", {"type": "action", "action": {
            "command": "set_leader_node", "server_id": target.server_id}})
        assert wait_until(lambda: target.role == c.Role.LEADER, WAIT_S)
        target.open_namespace("m", _idx(pkg))
        target.upsert("m", {"id": 1})
        assert _all_applied(nodes, "m", [1])
        assert wait_until(lambda: sum(
            n.role == c.Role.LEADER for n in nodes) == 1, WAIT_S)
        return [_ids(n, "m") for n in nodes]
    both(lambda pkg: _local(pkg, run))


def test_set_leader_unknown_node():
    def run(pkg, c, nodes):
        leader = _leader(c, nodes)
        with pytest.raises(pkg.ParamsError) as e:
            leader.db.upsert("#config", {"type": "action", "action": {
                "command": "set_leader_node", "server_id": 99}})
        return str(e.value)
    both(lambda pkg: _local(pkg, run))


# --- tests/test_cluster_tcp.py, in each package ------------------------------

def test_tcp_election_and_writes():
    def run(pkg, c, nodes, servers):
        leader = _leader(c, nodes)
        follower = next(n for n in nodes if n.role != c.Role.LEADER)
        follower.open_namespace("t", _idx(pkg))
        follower.upsert("t", {"id": 1})
        leader.upsert("t", {"id": 2})
        assert _all_applied(nodes, "t", [1, 2])
        return [_ids(n, "t") for n in nodes]
    both(lambda pkg: _tcp(pkg, run))


def test_tcp_leader_socket_kill_failover():
    def run(pkg, c, nodes, servers):
        leader = _leader(c, nodes)
        leader.open_namespace("f", _idx(pkg))
        leader.upsert("f", {"id": 1})
        assert _all_applied(nodes, "f", [1])
        servers[leader.server_id].stop()
        leader.kill()
        survivors = [n for n in nodes if n.alive]
        new_leader = _leader(c, survivors)
        assert new_leader is not leader
        new_leader.upsert("f", {"id": 2})
        assert _all_applied(survivors, "f", [1, 2])
        return [_ids(n, "f") for n in survivors]
    both(lambda pkg: _tcp(pkg, run))


def test_tcp_leader_kill_under_write_load():
    """Every acknowledged write survives on the surviving quorum; which
    writes were acknowledged is the threads' timing, so each package is
    held to its own acknowledgements. The port's writer finishes within
    the wait; the reference's may not (its catch-up stalls, ROADMAP C),
    so, as in its own test, its acknowledgements are held as they stand
    when the wait ends."""
    def run(pkg, c, nodes, servers):
        leader = _leader(c, nodes)
        leader.open_namespace("w", _idx(pkg))
        acked, errors = [], []
        started, stop = threading.Event(), threading.Event()

        def writer():
            follower = next(n for n in nodes if n is not leader)
            for i in range(60):
                if stop.is_set():
                    return
                try:
                    follower.upsert("w", {"id": i})
                    acked.append(i)
                except pkg.ReindexerError as e:
                    errors.append(str(e))
                started.set()

        th = threading.Thread(target=writer, daemon=True)
        th.start()
        try:
            assert started.wait(WAIT_S)
            servers[leader.server_id].stop()
            leader.kill()
            th.join(timeout=2 * WAIT_S)
            assert pkg.name == "ref" or not th.is_alive()
            done = list(acked)
            survivors = [n for n in nodes if n.alive]
            assert _leader(c, survivors) is not None and done
            assert wait_until(lambda: all(
                set(done) <= set(_ids(n, "w")) for n in survivors), WAIT_S), \
                [set(done) - set(_ids(n, "w")) for n in survivors]
        finally:
            stop.set()
        return True
    both(lambda pkg: _tcp(pkg, run))


def test_tcp_frozen_node_refuses_verbs():
    def run(pkg, c, nodes, servers):
        leader = _leader(c, nodes)
        leader.open_namespace("z", _idx(pkg))
        follower = next(n for n in nodes if n is not leader)
        follower.kill()
        for i in range(5):
            leader.upsert("z", {"id": i})
        follower.revive()
        assert _all_applied([follower], "z", list(range(5)))
        return _ids(follower, "z")
    both(lambda pkg: _tcp(pkg, run))


def test_cascade_replication_chain():
    """leader -> mid -> leaf, each hop an async replicator; the mid's state
    attached after its data (a seeded ring: the leaf force-syncs)."""
    def run(pkg):
        r = pkg.mod("replication")
        top = pkg.db()
        top_state = r.ReplicationState(top)
        top.open_namespace("c", _idx(pkg))
        mid = pkg.db()
        r1 = r.AsyncReplicator(mid, r.LeaderChannel(top_state))
        for i in range(10):
            top.upsert("c", {"id": i})
        r1.sync_once()
        mid_state = r.ReplicationState(mid)
        leaf = pkg.db()
        r2 = r.AsyncReplicator(leaf, r.LeaderChannel(mid_state))
        r2.sync_once()
        assert len(docs(leaf, "c")) == 10
        top.upsert("c", {"id": 100})
        r1.sync_once()
        r2.sync_once()
        assert len(docs(leaf, "c")) == 11
        return _ids(leaf, "c"), r1.stats(), r2.stats()
    both(run)


# --- the wire across packages -------------------------------------------------

def _peer_session(server_pkg, peer_pkg):
    """The cluster verbs of a peer of one package against a node of the
    other behind its ClusterServer (neither started: no timer runs)."""
    node = server_pkg.mod("cluster").ClusterNode(0, **server_pkg.cpu())
    srv = server_pkg.mod("net.cluster_transport").ClusterServer(node)
    srv.start()
    t = peer_pkg.mod("net.cluster_transport")
    LogRecord = peer_pkg.mod("cluster").LogRecord
    peer = t.RpcPeer(0, "127.0.0.1", srv.port)
    try:
        out = {"info": peer.raft_info()}
        out["vote"] = peer.request_vote(1, 5, 0)
        out["vote again"] = peer.request_vote(1, 6, 0)
        idx = [d.to_dict() for d in _idx(peer_pkg)]
        out["append"] = [
            peer.append_record(LogRecord(1, 1, "p", "open_namespace",
                                         {"indexes": idx}), 0),
            peer.append_record(LogRecord(2, 1, "p", "upsert",
                                         {"doc": {"id": 7}}), 2),
            peer.append_record(LogRecord(4, 1, "p", "upsert",
                                         {"doc": {"id": 8}}), 2),
            peer.append_record(LogRecord(3, 0, "p", "upsert",
                                         {"doc": {"id": 9}}), 2)]
        out["since"] = [(r.index, r.term, r.ns, r.op, r.payload)
                        for r in peer.records_since(1)]
        peer.heartbeat(1, 5, 2, 2)
        out["after"] = peer.raft_info()
        out["docs"] = _ids(node.db, "p")
        # a write to a node that does not lead fails as a lost peer does
        # (RpcPeer._call reads every error frame as a ConnectionError)
        with pytest.raises(ConnectionError):
            peer.client_write("p", "upsert", {"doc": {"id": 10}})
        node.kill()
        out["dead vote"] = peer.request_vote(2, 5, 2)
        return out
    finally:
        peer._drop()
        srv.stop()


@pytest.mark.parametrize("server,peer", [("ref", "port"), ("port", "ref")])
def test_rpc_peer_against_the_other_package(server, peer):
    """A peer of one package and a ClusterServer of the other answer every
    verb as two of the same package do."""
    got = _peer_session(Pkg(server), Pkg(peer))
    same = _peer_session(Pkg(server), Pkg(server))
    assert got == same
    assert got["vote"] and not got["vote again"]
    assert got["append"] == [True, True, False, False]
    assert got["docs"] == [7] and got["after"]["leader_id"] == 5
    assert not got["dead vote"]


def test_make_cluster_defaults_to_cuda():
    """A node, make_cluster and make_tcp_cluster build their databases on
    `cuda` unless told otherwise, and so raise where there is no card."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: cuda opens")
    port = Pkg("port")
    c = port.mod("cluster")
    t = port.mod("net.cluster_transport")
    for make in (lambda: c.ClusterNode(0), lambda: c.make_cluster(3),
                 lambda: t.make_tcp_cluster(3)):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make()


# --- the reference's fault, not copied --------------------------------------

def _write_while_a_follower_lags(pkg):
    """Three nodes over sockets, not started (no timer runs): node 0 leads
    term 1 by hand, node 1 misses one write while it is down; then a client
    writes through node 0's server. The write's heartbeat sends node 1 to
    catch up from node 0, whose server is inside that write. Returns the
    client's error (None if the write was acknowledged), the write's
    seconds, node 0's and node 1's ids after it and RpcPeer.TIMEOUT."""
    c = pkg.mod("cluster")
    t = pkg.mod("net.cluster_transport")
    nodes = [c.ClusterNode(i, **pkg.cpu()) for i in range(3)]
    servers = [t.ClusterServer(n) for n in nodes]
    for srv in servers:
        srv.start()
    client = t.RpcPeer(0, "127.0.0.1", servers[0].port)
    try:
        for i, node in enumerate(nodes):
            node.peers = {j: t.RpcPeer(j, "127.0.0.1", srv.port)
                          for j, srv in enumerate(servers) if j != i}
            node.term, node.leader_id = 1, 0
        nodes[0].role = c.Role.LEADER
        nodes[0].open_namespace("s", _idx(pkg))
        nodes[1].kill()
        nodes[0].upsert("s", {"id": 1})
        nodes[1].revive()
        t0 = time.monotonic()
        try:
            client.client_write("s", "upsert", {"doc": {"id": 2}})
            err = None
        except ConnectionError as e:
            err = str(e)
        secs = time.monotonic() - t0
        assert wait_until(lambda: _ids(nodes[0], "s") == [1, 2], WAIT_S)
        return err, secs, _ids(nodes[1], "s"), t.RpcPeer.TIMEOUT
    finally:
        for peer in [client] + [p for n in nodes for p in n.peers.values()]:
            peer._drop()
        for srv in servers:
            srv.stop()


@pytest.mark.reference_divergence
def test_reference_tcp_catch_up_stalls_a_write():
    """The reference's server runs one verb at a time on its event loop and
    its peer calls share one socket: the catch-up waits on the server that
    is inside the write until RpcPeer.TIMEOUT ends it, and the follower
    stays behind; the client waits the timeout out (its own call, timed
    out at the same 2 s, often fails although the leader applied the
    write)."""
    _, secs, ids, timeout = _write_while_a_follower_lags(Pkg("ref"))
    assert secs >= 0.9 * timeout
    assert ids == []


@pytest.mark.reference_divergence
def test_port_tcp_catch_up_runs_beside_the_write():
    """The port's server answers the catch-up while the write waits on its
    heartbeats: the write returns well within RpcPeer.TIMEOUT and the
    follower holds both records."""
    err, secs, ids, timeout = _write_while_a_follower_lags(Pkg("port"))
    assert err is None and secs < timeout
    assert ids == [1, 2]


def _catch_up_after_an_election(pkg):
    """In process, nodes not started: node 0 leads term 1 and writes 3
    rows while node 1 is down; node 2 then leads term 2 (set by hand, as an
    election would) and node 1, revived, takes its heartbeat. Returns node
    1's log length and its rows (None without the namespace)."""
    c = pkg.mod("cluster")
    nodes = [c.ClusterNode(i, **pkg.cpu()) for i in range(3)]
    for node in nodes:
        node.connect(nodes)
        node.term, node.leader_id = 1, 0
    nodes[0].role = c.Role.LEADER
    nodes[1].kill()
    nodes[0].open_namespace("s", _idx(pkg))
    for i in range(3):
        nodes[0].upsert("s", {"id": i})
    nodes[0].role = c.Role.FOLLOWER
    for node in nodes:
        node.term, node.leader_id = 2, 2
    nodes[2].role = c.Role.LEADER
    nodes[1].revive()
    nodes[2]._send_heartbeats()
    rows = _ids(nodes[1], "s") if "s" in nodes[1].db.namespace_names() \
        else None
    return len(nodes[1].log), rows


@pytest.mark.reference_divergence
def test_reference_follower_never_catches_up_across_an_election():
    """The reference's catch-up appends through append_record, which
    refuses a record whose own term is older than the follower's; the
    heartbeat of the term-2 leader has just raised the follower's term, so
    every term-1 record it lacks is refused, at every heartbeat."""
    assert _catch_up_after_an_election(Pkg("ref")) == (0, None)


@pytest.mark.reference_divergence
def test_port_follower_catches_up_across_an_election():
    """The port appends the leader's records under the heartbeat's term:
    the follower takes the 4 records of term 1 and applies them."""
    assert _catch_up_after_an_election(Pkg("port")) == (4, [0, 1, 2])


def test_catch_up_is_batched():
    """A heartbeat's catch-up takes at most CATCH_UP_BATCH records; the
    next heartbeats bring the rest."""
    port = Pkg("port")
    c = port.mod("cluster")
    nodes = [c.ClusterNode(i, device="cpu") for i in range(3)]
    for node in nodes:
        node.connect(nodes)
        node.term, node.leader_id = 1, 0
    nodes[0].role = c.Role.LEADER
    nodes[1].kill()
    nodes[0].open_namespace("s", _idx(port))
    n = c.CATCH_UP_BATCH + 10
    for i in range(n):
        nodes[0].upsert("s", {"id": i})
    nodes[1].revive()
    nodes[0]._send_heartbeats()
    assert len(nodes[1].log) == c.CATCH_UP_BATCH
    nodes[0]._send_heartbeats()
    assert len(nodes[1].log) == n + 1 and _ids(nodes[1], "s") == list(
        range(n))


def test_rpc_peer_calls_from_threads():
    """16 threads share one port RpcPeer (each call in flight takes a
    socket of its own): every call gets its own answer (the node grants
    its vote of term 0 to one candidate only, and reports its own id), and
    no socket outlives the peer's close."""
    import sys
    port = Pkg("port")
    t = port.mod("net.cluster_transport")
    node = port.mod("cluster").ClusterNode(0, device="cpu")
    srv = t.ClusterServer(node)
    srv.start()
    peer = t.RpcPeer(0, "127.0.0.1", srv.port)
    got, granted, errors = [], set(), []

    def worker(k):
        try:
            for _ in range(20):
                if peer.request_vote(0, 100 + k, 0):
                    granted.add(100 + k)
                got.append(peer.raft_info()["server_id"])
        except Exception as e:          # surfaced below
            errors.append(e)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=worker, args=(k,))
                   for k in range(16)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=WAIT_S)
    finally:
        sys.setswitchinterval(interval)
        peer._drop()
        srv.stop()
    assert not any(th.is_alive() for th in threads) and not errors, errors
    assert got == [0] * 320 and len(granted) == 1 and not peer._idle

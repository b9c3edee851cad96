"""Port of reindexer_tpu/net/cluster_transport.py: a copy of the
reference's module (host only; the same frames, so a port `RpcPeer` talks
to a reference `ClusterServer` and the other way round);
`make_tcp_cluster` builds its nodes on the torch `device` it is given
(default `cuda`).

It differs in two places, both so that a verb that calls another node
(a write's heartbeats, a follower's catch-up) never waits on a call it
made itself:
  - a `ClusterServer` runs each verb that calls other nodes on a thread
    of its own pool, off its event loop; the reference's runs every verb
    on the loop, one at a time;
  - an `RpcPeer` calls over a pool of sockets, one for each call in
    flight; the reference's calls over one socket under one lock.
In the reference a follower that must catch up while its leader is inside
a write asks that leader for the missing records, and the calls wait on
each other until `RpcPeer.TIMEOUT` (2 s) ends one of them, the records
still missing: writes through a follower stall for seconds (ROADMAP C).

The reference's notes follow.

RAFT cluster transport: the sync-cluster verbs over real TCP sockets.

Semantic equivalent of the reference's networked RAFT plane — cluster verbs
ride the binary RPC protocol (cpp_src/server/rpcserver.cc:1387-1389
SuggestLeader/LeadersPing/GetRaftInfo; append stream via the cluster
replicator) instead of in-process method calls. `ClusterServer` exposes one
`cluster.ClusterNode` on a TCP port; `RpcPeer` is the client side used as a
peer channel by other nodes; `make_tcp_cluster` builds an N-node localhost
topology (the ServerControl pattern, gtests fixtures/servercontrol.h:66-211).

Partition testing: `ClusterServer.stop()` kills the socket (network
partition / process death), while `node.kill()` keeps the socket up but the
node refuses all verbs (frozen process).
"""
from __future__ import annotations

import asyncio
import dataclasses
import json
import socket
import struct
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Optional

from .protocol import Cmd, HEADER_SIZE, Status, pack_frame, unpack_header
from .serializer import decode_args, encode_args


class ClusterServer:
    """Serves one ClusterNode's RAFT verbs over TCP."""

    VERB_THREADS = 8
    # the verbs that call other nodes (a write's fan-out and heartbeats, a
    # follower's catch-up, an election) run on the pool; the others answer
    # from the node's own state, on the loop
    CALLING_VERBS = (Cmd.RAFT_HEARTBEAT, Cmd.RAFT_CLIENT_WRITE,
                     Cmd.RAFT_SET_LEADER)

    def __init__(self, node, host: str = "127.0.0.1", port: int = 0):
        self.node = node
        self.host = host
        self._port = port
        # verbs run here, so one that waits on a peer (a write's heartbeats,
        # a catch-up) never keeps the node from serving the others
        self._pool = ThreadPoolExecutor(max_workers=self.VERB_THREADS,
                                        thread_name_prefix="cluster-verb")
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._server: Optional[asyncio.AbstractServer] = None
        self._thread: Optional[threading.Thread] = None
        self._started = threading.Event()

    @property
    def port(self) -> int:
        return self._port

    def start(self) -> None:
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()
        self._started.wait(timeout=10)

    def _run(self) -> None:
        self._loop = asyncio.new_event_loop()
        asyncio.set_event_loop(self._loop)

        async def boot():
            self._server = await asyncio.start_server(
                self._handle, self.host, self._port)
            self._port = self._server.sockets[0].getsockname()[1]
            self._started.set()

        self._loop.run_until_complete(boot())
        try:
            self._loop.run_forever()
        finally:
            self._loop.close()

    def stop(self) -> None:
        """Socket-level kill (network partition / crashed process).
        Idempotent — test teardowns may stop an already-killed server."""
        if self._loop is not None and not self._loop.is_closed():
            async def shutdown():
                if self._server is not None:
                    self._server.close()
                tasks = [t for t in asyncio.all_tasks(self._loop)
                         if t is not asyncio.current_task()]
                for task in tasks:
                    task.cancel()
                # let the connection handlers run their finally blocks
                # before the loop stops
                await asyncio.gather(*tasks, return_exceptions=True)
                self._loop.stop()
            try:
                asyncio.run_coroutine_threadsafe(shutdown(), self._loop)
            except RuntimeError:         # the loop closed meanwhile
                pass
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
        self._pool.shutdown(wait=False, cancel_futures=True)

    async def _handle(self, reader: asyncio.StreamReader,
                      writer: asyncio.StreamWriter) -> None:
        try:
            while True:
                head = await reader.readexactly(HEADER_SIZE)
                seq, cmd, _, length = unpack_header(head)
                body = await reader.readexactly(length) if length else b""
                try:
                    args = decode_args(body) if body else []
                    if Cmd(cmd) in self.CALLING_VERBS:
                        result = await asyncio.get_running_loop() \
                            .run_in_executor(self._pool, self._dispatch,
                                             Cmd(cmd), args)
                    else:
                        result = self._dispatch(Cmd(cmd), args)
                    out = pack_frame(seq, cmd, Status.OK, encode_args(result))
                except Exception as e:
                    out = pack_frame(seq, cmd, Status.INTERNAL,
                                     encode_args([str(e)]))
                writer.write(out)
                await writer.drain()
        except (asyncio.IncompleteReadError, ConnectionError):
            pass
        finally:
            writer.close()

    def _dispatch(self, cmd: Cmd, args: list) -> list:
        from ..cluster import LogRecord
        node = self.node
        if cmd == Cmd.RAFT_INFO:
            info = node.raft_info()
            info["alive"] = node.alive
            return [json.dumps(info)]
        if not node.alive:
            raise ConnectionError("node is down")   # frozen-process semantics
        if cmd == Cmd.RAFT_VOTE:
            return [1 if node.request_vote(int(args[0]), int(args[1]),
                                           int(args[2])) else 0]
        if cmd == Cmd.RAFT_HEARTBEAT:
            node.heartbeat(int(args[0]), int(args[1]), int(args[2]),
                           int(args[3]))
            return []
        if cmd == Cmd.RAFT_APPEND:
            rec = LogRecord(**json.loads(args[0]))
            rec.payload = rec.payload or {}
            return [1 if node.append_record(rec, int(args[1])) else 0]
        if cmd == Cmd.RAFT_RECORDS_SINCE:
            # the limit is the port's; a reference peer sends none
            recs = node.records_since(
                int(args[0]), int(args[1]) if len(args) > 1 else None)
            return [json.dumps([dataclasses.asdict(r) for r in recs])]
        if cmd == Cmd.RAFT_CLIENT_WRITE:
            node._replicate(args[0], args[1], json.loads(args[2]))
            return []
        if cmd == Cmd.RAFT_SET_LEADER:
            # manual leadership transfer (reference: set_leader_node)
            node.set_desired_leader(int(args[0]))
            return []
        raise ValueError(f"unknown cluster verb {cmd}")


class RpcPeer:
    """Client-side peer channel: the duck-type the ClusterNode peers dict
    expects (request_vote/heartbeat/append_record/records_since/raft_info/
    client_write), over TCP. Connection failures read as a dead peer."""

    TIMEOUT = 2.0

    def __init__(self, server_id: int, host: str, port: int):
        self.server_id = server_id
        self.host = host
        self.port = port
        self._idle: list[socket.socket] = []    # connected, no call on it
        self._seq = 0
        self._lock = threading.Lock()

    # --- framing ---------------------------------------------------------
    def _connect(self) -> socket.socket:
        """An idle socket, or a new one when every socket has a call."""
        with self._lock:
            if self._idle:
                return self._idle.pop()
        s = socket.create_connection((self.host, self.port),
                                     timeout=self.TIMEOUT)
        s.settimeout(self.TIMEOUT)
        return s

    def _call(self, cmd: Cmd, args: list) -> list:
        sock = None
        try:
            sock = self._connect()
            with self._lock:
                self._seq += 1
                seq = self._seq
            sock.sendall(pack_frame(seq, cmd, 0, encode_args(args)))
            head = self._recv(sock, HEADER_SIZE)
            _, _, status, length = unpack_header(head)
            body = self._recv(sock, length) if length else b""
            if status != Status.OK:
                raise ConnectionError(
                    decode_args(body)[0] if body else "cluster error")
            with self._lock:
                self._idle.append(sock)
            return decode_args(body) if body else []
        except (OSError, struct.error):
            if sock is not None:
                self._close(sock)
            self._drop()
            raise ConnectionError(f"peer {self.server_id} unreachable")

    @staticmethod
    def _close(sock: socket.socket) -> None:
        try:
            sock.close()
        except OSError:
            pass

    @staticmethod
    def _recv(sock: socket.socket, n: int) -> bytes:
        buf = b""
        while len(buf) < n:
            part = sock.recv(n - len(buf))
            if not part:
                raise ConnectionError("peer closed")
            buf += part
        return buf

    def _drop(self) -> None:
        """Close the idle sockets (after a failure, the peer may be gone)."""
        with self._lock:
            idle, self._idle = self._idle, []
        for sock in idle:
            self._close(sock)

    # --- channel interface -------------------------------------------------
    def request_vote(self, term: int, candidate_id: int,
                     log_len: int) -> bool:
        try:
            return bool(self._call(Cmd.RAFT_VOTE,
                                   [term, candidate_id, log_len])[0])
        except ConnectionError:
            return False

    def heartbeat(self, term: int, leader_id: int, log_len: int,
                  commit_index: int = 0) -> None:
        try:
            self._call(Cmd.RAFT_HEARTBEAT,
                       [term, leader_id, log_len, commit_index])
        except ConnectionError:
            pass

    def append_record(self, rec, leader_commit: int = 0) -> bool:
        try:
            return bool(self._call(Cmd.RAFT_APPEND,
                                   [json.dumps(dataclasses.asdict(rec)),
                                    leader_commit])[0])
        except ConnectionError:
            return False

    def records_since(self, index: int, limit: Optional[int] = None) -> list:
        """The peer's records from `index`, at most `limit` (a reference
        server ignores the limit and sends them all)."""
        from ..cluster import LogRecord
        args = [index] if limit is None else [index, limit]
        try:
            raw = json.loads(self._call(Cmd.RAFT_RECORDS_SINCE, args)[0])
        except ConnectionError:
            return []
        return [LogRecord(**d) for d in raw[:limit]]

    def raft_info(self) -> dict:
        return json.loads(self._call(Cmd.RAFT_INFO, [])[0])

    def client_write(self, ns: str, op: str, payload: dict) -> None:
        self._call(Cmd.RAFT_CLIENT_WRITE, [ns, op, json.dumps(payload)])

    def set_desired_leader(self, server_id: int) -> None:
        self._call(Cmd.RAFT_SET_LEADER, [server_id])


def make_tcp_cluster(n: int, device="cuda"):
    """N-node localhost RAFT cluster over real sockets, each node's
    database on the torch `device`. Returns (nodes, servers); stop servers
    (and nodes) when done."""
    from ..cluster import ClusterNode

    nodes = [ClusterNode(i, device=device) for i in range(n)]
    servers = [ClusterServer(node) for node in nodes]
    for s in servers:
        s.start()
    for i, node in enumerate(nodes):
        for j, peer_srv in enumerate(servers):
            if i != j:
                node.peers[j] = RpcPeer(j, "127.0.0.1", peer_srv.port)
    for node in nodes:
        node.start()
    return nodes, servers

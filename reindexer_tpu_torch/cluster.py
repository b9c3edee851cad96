"""Port of reindexer_tpu/cluster.py: the reference's module over the port's
databases (host only; the same records and verbs). A node builds its
`Reindexer` on the torch `device` it is given (default `cuda`), as does
`make_cluster`; the nodes of one process share that device, and each
node's selects launch the port's kernels there.

It differs in one place, a follower's catch-up. The reference appends the
records a heartbeat's leader sends with `append_record`, which refuses a
record whose own term is older than the follower's: once a follower has
seen a newer term (an election while it was behind), it refuses the
committed records of the earlier terms it lacks and never catches up. The
port appends them under the heartbeat's term, which it has checked (a
record's own term tells whether it conflicts, not whether its sender may
send it), stops when a newer leader takes over, and takes at most
`CATCH_UP_BATCH` records a heartbeat, so that a leader whose heartbeats
run in process keeps its other followers' elections off (ROADMAP C).

The reference's notes follow.

Synchronous RAFT cluster: leader election + quorum-acked replication +
follower write proxying.

Semantic equivalent of the reference sync cluster
(cpp_src/cluster/raftmanager.cc leader election; ClusterDataReplicator with
quorum ack; core/clusterproxy.cc wrapping every API verb so follower writes
proxy to the leader; role switching cluster/replication/roleswitcher.cc).

The implementation is the host control plane only (SURVEY.md §2.4 P9):
election state machine with randomized timeouts and term voting, heartbeats
from the leader, and synchronous log shipping — a write returns once a
majority of nodes applied it. Transports are in-process channels (the
ServerControl-style test topology); the data plane reuses the replication
WAL record format (replication.py).
"""
from __future__ import annotations

import dataclasses
import random
import threading
import time
from typing import Any, Callable, Optional

from .core.database import Reindexer
from .core.errors import NotFoundError, ReindexerError
from .core.payload import IndexDef
from .query.query import Query
from .query.results import QueryResults

HEARTBEAT_INTERVAL = 0.05
ELECTION_TIMEOUT = (0.15, 0.3)
CATCH_UP_BATCH = 256     # records a heartbeat's catch-up appends at most


class Role:
    FOLLOWER = "follower"
    CANDIDATE = "candidate"
    LEADER = "leader"


@dataclasses.dataclass
class LogRecord:
    index: int
    term: int
    ns: str
    op: str
    payload: dict


class ClusterNode:
    """One cluster member: embedded engine + RAFT state machine."""

    def __init__(self, server_id: int, db: Optional[Reindexer] = None,
                 device="cuda"):
        """device: the torch device of the database made here when `db`
        is None."""
        self.server_id = server_id
        self.db = db or Reindexer(device=device)
        # lets `#config` actions reach the RAFT layer (set_leader_node)
        self.db._cluster_node = self
        self.peers: dict[int, "ClusterNode"] = {}
        # RAFT state (reference: RaftManager)
        self.term = 0
        self.voted_for: Optional[int] = None
        self.role = Role.FOLLOWER
        self.leader_id: Optional[int] = None
        self._last_heartbeat = time.monotonic()
        self._election_deadline = self._new_deadline()
        # replicated log: records append uncommitted; they apply to the
        # engine only once the leader advances commit_index past them
        # (quorum-ack rule — reference: ClusterDataReplicator sync mode)
        self.log: list[LogRecord] = []
        self.commit_index = 0
        self.applied_index = 0
        self._lock = threading.RLock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.alive = True

    def set_desired_leader(self, server_id: int) -> None:
        """Manual leadership transfer (reference: set_leader_node action,
        replication.md:498-505; clusterproxy SetDesiredLeaderId). The
        target runs an election immediately with a bumped term — stale
        leaders step down when they see the newer term (request_vote /
        heartbeat term rules); local siblings are additionally demoted and
        held back so the target wins the race deterministically."""
        target = (self if server_id == self.server_id
                  else self.peers.get(server_id))
        if target is None or not getattr(target, "alive", True):
            from .core.errors import ParamsError
            raise ParamsError(
                f"no alive cluster node with server id {server_id}")
        for node in [self, *self.peers.values()]:
            if node is target or not hasattr(node, "_run_election") \
                    or not node.alive:
                continue   # remote (RpcPeer) siblings self-correct via terms
            with node._lock:
                if node.role == Role.LEADER:
                    node.role = Role.FOLLOWER
                    node.leader_id = None
                # hold other nodes back so the target wins the race
                node._election_deadline = node._new_deadline() + 1.0
        if hasattr(target, "_run_election"):
            target._run_election()
        else:
            target.set_desired_leader(server_id)   # forward over TCP

    # --- topology -------------------------------------------------------
    def connect(self, nodes: list["ClusterNode"]) -> None:
        for n in nodes:
            if n.server_id != self.server_id:
                self.peers[n.server_id] = n

    def quorum(self) -> int:
        return (len(self.peers) + 1) // 2 + 1

    # --- lifecycle ------------------------------------------------------
    def start(self) -> None:
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        self.alive = False
        if self._thread is not None:
            self._thread.join(timeout=2)

    def kill(self) -> None:
        """Simulate node failure (reference test: ServerControl kill)."""
        self.alive = False

    def revive(self) -> None:
        self.alive = True
        with self._lock:
            self.role = Role.FOLLOWER
            self._election_deadline = self._new_deadline()

    def _new_deadline(self) -> float:
        return time.monotonic() + random.uniform(*ELECTION_TIMEOUT)

    # --- RAFT loop (reference: raftmanager.cc election/ping loop) -------
    def _loop(self) -> None:
        while not self._stop.is_set():
            if self.alive:
                try:
                    if self.role == Role.LEADER:
                        self._send_heartbeats()
                        time.sleep(HEARTBEAT_INTERVAL)
                        continue
                    if time.monotonic() > self._election_deadline:
                        self._run_election()
                except Exception:
                    pass
            time.sleep(0.01)

    def _run_election(self) -> None:
        with self._lock:
            self.role = Role.CANDIDATE
            self.term += 1
            self.voted_for = self.server_id
            term = self.term
            self._election_deadline = self._new_deadline()
        votes = 1
        for peer in self.peers.values():
            if peer.request_vote(term, self.server_id, len(self.log)):
                votes += 1
        with self._lock:
            if self.role == Role.CANDIDATE and self.term == term \
                    and votes >= self.quorum():
                self.role = Role.LEADER
                self.leader_id = self.server_id
        if self.role == Role.LEADER:
            self._send_heartbeats()

    def request_vote(self, term: int, candidate_id: int,
                     candidate_log_len: int) -> bool:
        """RPC: vote request (reference: SuggestLeader verb)."""
        if not self.alive:
            return False
        with self._lock:
            if term < self.term:
                return False
            if term > self.term:
                self.term = term
                self.voted_for = None
                self.role = Role.FOLLOWER
            if self.voted_for in (None, candidate_id) \
                    and candidate_log_len >= len(self.log):
                self.voted_for = candidate_id
                self._election_deadline = self._new_deadline()
                return True
            return False

    def _send_heartbeats(self) -> None:
        for peer in self.peers.values():
            peer.heartbeat(self.term, self.server_id, len(self.log),
                           self.commit_index)

    def heartbeat(self, term: int, leader_id: int, log_len: int,
                  commit_index: int = 0) -> None:
        """RPC: leader ping carrying the commit index (reference:
        LeadersPing verb + AppendEntries leaderCommit semantics)."""
        if not self.alive:
            return
        with self._lock:
            if term < self.term:
                return             # stale leader: ignore its ping entirely
            self.term = term
            self.role = Role.FOLLOWER
            self.leader_id = leader_id
            self._election_deadline = self._new_deadline()
        # catch up missing records: the leader's, whatever their own terms
        if log_len > len(self.log):
            leader = self.peers.get(leader_id)
            if leader is not None:
                for rec in leader.records_since(len(self.log),
                                                CATCH_UP_BATCH):
                    with self._lock:
                        if self.term != term or self.leader_id != leader_id \
                                or not self._append_locked(rec, commit_index):
                            break
        with self._lock:
            self._advance_commit(commit_index)

    # --- replicated writes ---------------------------------------------
    def records_since(self, index: int,
                      limit: Optional[int] = None) -> list[LogRecord]:
        with self._lock:
            return list(self.log[index:None if limit is None
                                 else index + limit])

    def append_record(self, rec: LogRecord, leader_commit: int = 0) -> bool:
        """RPC: append one replicated record on a follower (uncommitted
        until `leader_commit` covers it)."""
        if not self.alive:
            return False
        with self._lock:
            if rec.term < self.term:
                return False          # record from a deposed leader
            if rec.term > self.term:
                self.term = rec.term
                self.role = Role.FOLLOWER
                self.voted_for = None
            return self._append_locked(rec, leader_commit)

    def _append_locked(self, rec: LogRecord, leader_commit: int) -> bool:
        """Append rec at its index (callers hold _lock and have checked
        that its sender leads)."""
        if rec.index <= len(self.log):
            have = self.log[rec.index - 1]
            if have.term == rec.term:
                self._advance_commit(leader_commit)
                return True       # already have it
            if have.index <= self.applied_index:
                return False      # applied divergence: needs resync
            del self.log[rec.index - 1:]   # truncate conflicting tail
        if rec.index != len(self.log) + 1:
            return False          # gap: wait for catch-up
        self.log.append(rec)
        self._advance_commit(leader_commit)
        return True

    def _advance_commit(self, commit_index: int) -> None:
        """Apply committed-but-unapplied records (callers hold _lock)."""
        commit_index = min(commit_index, len(self.log))
        if commit_index > self.commit_index:
            self.commit_index = commit_index
        while self.applied_index < self.commit_index:
            rec = self.log[self.applied_index]
            self._apply(rec)
            self.applied_index = rec.index

    def _apply(self, rec: LogRecord) -> None:
        op, ns, payload = rec.op, rec.ns, rec.payload
        if op == "open_namespace":
            self.db.open_namespace(
                ns, [IndexDef.from_dict(d) for d in payload.get("indexes", [])])
        elif op == "upsert":
            self.db.get_namespace(ns).upsert(payload["doc"])
        elif op == "delete":
            self.db.get_namespace(ns).delete(payload["doc"])
        elif op == "truncate":
            self.db.truncate_namespace(ns)
        elif op == "put_meta":
            self.db.put_meta(ns, payload["key"], payload["value"])

    def _replicate(self, ns: str, op: str, payload: dict) -> None:
        """Leader: append uncommitted, fan out, apply only after quorum ack
        (reference: sync cluster quorum ack). A write that misses quorum
        stays uncommitted — it is never applied locally, so the 'failed'
        write cannot diverge from the followers."""
        with self._lock:
            if self.role != Role.LEADER:
                raise ReindexerError("not the leader")
            rec = LogRecord(index=len(self.log) + 1, term=self.term,
                            ns=ns, op=op, payload=payload)
            self.log.append(rec)
            commit = self.commit_index
        acks = 1
        for peer in self.peers.values():
            if peer.append_record(rec, commit):
                acks += 1
        if acks < self.quorum():
            raise ReindexerError(
                f"write not acknowledged by quorum ({acks}/{self.quorum()})")
        with self._lock:
            self._advance_commit(rec.index)
        # push the new commit index so followers apply synchronously
        self._send_heartbeats()

    # --- public API (proxied like the reference ClusterProxy) -----------
    def client_write(self, ns: str, op: str, payload: dict) -> None:
        """RPC-facing write entry on the leader (reference: clusterproxy.cc
        proxies follower writes to the leader over cproto)."""
        self._replicate(ns, op, payload)

    def _proxy_write(self, ns: str, op: str, payload: dict) -> None:
        """Route a write to the current leader — locally when this node
        leads, else through the peer channel (in-process or TCP)."""
        # generous deadline: elections under GIL contention on a 1-core test
        # host can take seconds (reference proxies block similarly while a
        # leader is being elected)
        deadline = time.monotonic() + 10.0
        last_err: Optional[Exception] = None
        while time.monotonic() < deadline:
            try:
                if self.role == Role.LEADER:
                    return self._replicate(ns, op, payload)
                lid = self.leader_id
                peer = self.peers.get(lid) if lid is not None else None
                if peer is not None:
                    return peer.client_write(ns, op, payload)
            except (ConnectionError, ReindexerError) as e:
                if "quorum" in str(e):
                    raise ReindexerError(str(e))
                last_err = e
            time.sleep(0.02)
        raise ReindexerError(f"no cluster leader elected ({last_err})")

    def open_namespace(self, name: str, indexes=()) -> None:
        self._proxy_write(name, "open_namespace",
                          {"indexes": [d.to_dict() for d in indexes]})

    def upsert(self, ns: str, doc: dict) -> None:
        self._proxy_write(ns, "upsert", {"doc": doc})

    def delete(self, ns: str, doc: dict) -> None:
        self._proxy_write(ns, "delete", {"doc": doc})

    def truncate_namespace(self, ns: str) -> None:
        self._proxy_write(ns, "truncate", {})

    def put_meta(self, ns: str, key: str, value: str) -> None:
        self._proxy_write(ns, "put_meta", {"key": key, "value": value})

    def select(self, q) -> QueryResults:
        # reads serve locally (reference: followers serve reads)
        return self.db.select(q)

    def raft_info(self) -> dict:
        """(reference: GetRaftInfo verb)"""
        return {"server_id": self.server_id, "role": self.role,
                "term": self.term, "leader_id": self.leader_id,
                "log_len": len(self.log), "commit_index": self.commit_index,
                "alive": self.alive}


def make_cluster(n: int, device="cuda") -> list[ClusterNode]:
    nodes = [ClusterNode(i, device=device) for i in range(n)]
    for node in nodes:
        node.connect(nodes)
    for node in nodes:
        node.start()
    return nodes


def wait_leader(nodes: list[ClusterNode], timeout: float = 5.0,
                ) -> Optional[ClusterNode]:
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        leaders = [n for n in nodes if n.alive and n.role == Role.LEADER]
        if len(leaders) == 1:
            # all live nodes agree on it
            lid = leaders[0].server_id
            if all(n.leader_id == lid for n in nodes
                   if n.alive and n.role == Role.FOLLOWER):
                return leaders[0]
        time.sleep(0.02)
    return None

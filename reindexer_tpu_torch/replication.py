"""Port of reindexer_tpu/replication.py: the reference's module over the
port's databases (host only; the same records, verbs and wire format, so
either package's follower replicates from either package's leader). It
differs in three places:

  - the leader's write hook reads the namespace's name when it writes, not
    when it attaches, so the writes to a renamed namespace ship under its
    new name (the reference's ship under the old one);
  - the leader ships a namespace's drop and rename as WAL records
    (`drop_namespace`, `rename_namespace` with `to`), and its wrapper of
    `open_namespace` also serves `add_namespace`; a write to a namespace
    that is no longer the database's (dropped, replaced) ships nothing;
  - the follower applies those records, and drops the namespaces it
    replicated that a snapshot or the leader's data-hash map no longer
    holds (a force sync drops them; the data-hash check counts them as a
    mismatch), so after `wait_sync` its namespace set is the leader's.
A follower of the reference applies neither record: its `_apply` skips an
unknown op (ROADMAP C).

The reference's notes follow.

Async logical replication: leader -> follower WAL shipping.

Semantic equivalent of the reference async replication
(cpp_src/cluster/replication/asyncdatareplicator.cc + replicationthread.cc;
protocol semantics replication.md:39-52): the leader tracks a bounded
in-memory WAL ring with monotonic LSNs (cpp_src/wal/waltracker.h analog);
followers poll for updates since their last applied LSN and apply them
online. When a follower's LSN has fallen out of the ring (or it is empty),
it force-syncs via a full namespace snapshot (namespace/snapshot/ analog)
and resumes online replay — the reference's resync ladder.

Transports: in-process `LeaderChannel` (the ServerControl-style test path)
or `HttpLeaderChannel` against a running ReindexerServer. The control plane
is host-only — device state rebuilds on the follower from the applied docs
(or its own ANN cache), per SURVEY.md §2.4 P9.
"""
from __future__ import annotations

import json
import threading
import time
import urllib.request
from typing import Any, Optional

from .core.database import Reindexer
from .core.errors import NotFoundError, ReindexerError
from .core.payload import IndexDef

_REPLICATED_OPS = ("upsert", "delete", "truncate", "add_index", "drop_index",
                   "put_meta", "delete_meta")


class WalTracker:
    """Bounded in-memory replication log (reference: WALTracker,
    wal/waltracker.h:16 — 4M-record ring default)."""

    def __init__(self, capacity: int = 100_000):
        self.capacity = capacity
        self._records: list[dict] = []
        self._first_lsn = 1
        self._next_lsn = 1
        self._lock = threading.Lock()

    def append(self, ns: str, op: str, payload: dict) -> int:
        with self._lock:
            lsn = self._next_lsn
            self._next_lsn += 1
            rec = {"lsn": lsn, "ns": ns, "op": op}
            if op in ("upsert", "delete"):
                rec["doc"] = payload.get("doc")
            elif op == "add_index":
                rec["index"] = payload
            elif op == "drop_index":
                rec["name"] = payload.get("name")
            elif op in ("put_meta", "delete_meta"):
                rec.update({k: payload.get(k) for k in ("key", "value")})
            elif op == "rename_namespace":
                rec["to"] = payload["to"]
            self._records.append(rec)
            if len(self._records) > self.capacity:
                drop = len(self._records) - self.capacity
                self._records = self._records[drop:]
                self._first_lsn += drop
            return lsn

    @property
    def last_lsn(self) -> int:
        return self._next_lsn - 1

    def seed(self, lsn: int) -> None:
        """Start the ring at `lsn` so records the tracker never saw (state
        that predates its attachment) read as fallen-off-the-ring: a
        follower below `lsn` is forced to snapshot-sync instead of silently
        receiving an empty update list (reference: WALTracker is initialized
        from the namespace's persisted LSN counter, wal/waltracker.h)."""
        with self._lock:
            if self._next_lsn <= lsn:
                self._first_lsn = lsn + 1
                self._next_lsn = lsn + 1

    def since(self, from_lsn: int) -> Optional[list[dict]]:
        """Records with lsn > from_lsn; None when the range fell off the ring
        (follower must force-sync)."""
        with self._lock:
            if from_lsn + 1 < self._first_lsn:
                return None
            idx = from_lsn + 1 - self._first_lsn
            return list(self._records[max(idx, 0):])


class ReplicationState:
    """Leader-side replication source bound to one Reindexer."""

    def __init__(self, db: Reindexer, server_id: int = 0):
        self.db = db
        self.server_id = server_id
        self.wal = WalTracker()
        db._replication_state = self
        existing = db.namespace_names()
        if existing:
            # state predating this tracker (leader restored from storage, or
            # the state lazily created on the first replication poll) is not
            # in the ring — seed past LSN 0 so a fresh follower force-syncs
            # it instead of receiving an empty "up to date" update list
            self.wal.seed(1)
        for name in existing:
            self._hook(db.get_namespace(name))
        orig_open = db.open_namespace
        orig_drop = db.drop_namespace
        orig_rename = db.rename_namespace

        def open_and_hook(name, indexes=()):
            # hook BEFORE the initial indexes are added so their add_index
            # records land in the replication log
            had = name in db._namespaces
            ns = orig_open(name, ())
            if not had:
                self._hook(ns)
            return orig_open(name, indexes)

        def drop_and_log(name):
            with db._lock:
                orig_drop(name)
                self.wal.append(name, "drop_namespace", {})

        def rename_and_log(src, dst):
            with db._lock:
                ns = db._namespaces.get(src)
                if ns is None:
                    return orig_rename(src, dst)     # raises NotFoundError
                # under the namespace's lock: no write to it lands between
                # the rename and its record
                with ns.lock:
                    orig_rename(src, dst)
                    self.wal.append(src, "rename_namespace", {"to": dst})

        db.open_namespace = db.add_namespace = open_and_hook
        db.drop_namespace = drop_and_log
        db.rename_namespace = rename_and_log

    def _hook(self, ns) -> None:
        def on_write(op, payload):
            # the name as it is now (a rename moves the namespace), and
            # nothing for a namespace the database no longer holds
            if op in _REPLICATED_OPS and \
                    self.db._namespaces.get(ns.name) is ns:
                self.wal.append(ns.name, op, payload)
        ns.wal_hooks.append(on_write)

    # --- protocol verbs (reference: RPC UpdatesStream / GetSnapshot) ----
    def data_hashes(self) -> dict:
        """Per-namespace incremental checksums (reference: repl_.dataHash —
        the follower compares them to detect divergence, replication.md:67)."""
        return {name: self.db.get_namespace(name).data_hash
                for name in self.db.namespace_names()}

    def updates(self, from_lsn: int) -> dict:
        recs = self.wal.since(from_lsn)
        if recs is None:
            return {"force_sync": True, "last_lsn": self.wal.last_lsn}
        return {"force_sync": False, "updates": recs,
                "last_lsn": self.wal.last_lsn,
                "data_hash": self.data_hashes()}

    def snapshot(self) -> dict:
        """Full-state snapshot for force sync (reference:
        namespace/snapshot/snapshot.h)."""
        out = {"lsn": self.wal.last_lsn, "namespaces": []}
        for name in self.db.namespace_names():
            ns = self.db.get_namespace(name)
            with ns.lock:
                out["namespaces"].append({
                    "name": name,
                    "indexes": [d.to_dict() for d in ns.index_defs()],
                    "meta": dict(ns.meta),
                    "items": [doc for doc in ns.items if doc is not None],
                })
        return out

    # --- chunked force sync (reference: namespace/snapshot/snapshot.h —
    # snapshots stream in chunks and apply via tx, bounding memory) --------
    def snapshot_meta(self) -> dict:
        """Schema + counts only; items stream via snapshot_chunk."""
        out = {"lsn": self.wal.last_lsn, "namespaces": []}
        for name in self.db.namespace_names():
            ns = self.db.get_namespace(name)
            with ns.lock:
                out["namespaces"].append({
                    "name": name,
                    "indexes": [d.to_dict() for d in ns.index_defs()],
                    "meta": dict(ns.meta),
                    "row_count": len(ns.items),
                })
        return out

    def snapshot_chunk(self, ns_name: str, offset: int, limit: int) -> dict:
        """One page of documents from the row-id range [offset, offset+limit).
        `next_offset` is -1 when the namespace is exhausted."""
        ns = self.db.get_namespace(ns_name)
        with ns.lock:
            total = len(ns.items)
            hi = min(offset + limit, total)
            items = [doc for doc in ns.items[offset:hi] if doc is not None]
            return {"items": items,
                    "next_offset": hi if hi < total else -1}


class LeaderChannel:
    """In-process transport (the ServerControl-style test topology,
    reference: gtests fixtures/servercontrol.h)."""

    def __init__(self, state: ReplicationState):
        self.state = state

    def updates(self, from_lsn: int) -> dict:
        return self.state.updates(from_lsn)

    def snapshot(self) -> dict:
        return self.state.snapshot()

    def snapshot_meta(self) -> dict:
        return self.state.snapshot_meta()

    def snapshot_chunk(self, ns: str, offset: int, limit: int) -> dict:
        return self.state.snapshot_chunk(ns, offset, limit)


class HttpLeaderChannel:
    """HTTP transport against ReindexerServer replication routes."""

    def __init__(self, base_url: str, db_name: str):
        self.base = base_url.rstrip("/")
        self.db_name = db_name

    def _get(self, path: str) -> dict:
        with urllib.request.urlopen(self.base + path, timeout=30) as r:
            return json.loads(r.read().decode())

    def updates(self, from_lsn: int) -> dict:
        return self._get(
            f"/api/v1/db/{self.db_name}/replication/updates?from_lsn={from_lsn}")

    def snapshot(self) -> dict:
        return self._get(f"/api/v1/db/{self.db_name}/replication/snapshot")

    def snapshot_meta(self) -> dict:
        return self._get(
            f"/api/v1/db/{self.db_name}/replication/snapshot_meta")

    def snapshot_chunk(self, ns: str, offset: int, limit: int) -> dict:
        return self._get(
            f"/api/v1/db/{self.db_name}/replication/snapshot_chunk"
            f"?ns={ns}&offset={offset}&limit={limit}")


class RpcLeaderChannel:
    """Binary-RPC transport (reference: replication rides cproto verbs,
    rpcserver.cc:1382-1384 GetSnapshot/updates)."""

    def __init__(self, host: str, port: int, db_name: str,
                 user: str = "", password: str = ""):
        from .net.rpc_client import RpcReindexer
        self._client = RpcReindexer(host, port, db_name, user, password)

    def updates(self, from_lsn: int) -> dict:
        from .net.protocol import Cmd
        return json.loads(self._client._call(Cmd.GET_UPDATES, [from_lsn])[0])

    def snapshot(self) -> dict:
        from .net.protocol import Cmd
        return json.loads(self._client._call(Cmd.GET_SNAPSHOT, [])[0])

    def snapshot_meta(self) -> dict:
        from .net.protocol import Cmd
        return json.loads(self._client._call(Cmd.GET_SNAPSHOT_META, [])[0])

    def snapshot_chunk(self, ns: str, offset: int, limit: int) -> dict:
        from .net.protocol import Cmd
        return json.loads(self._client._call(
            Cmd.GET_SNAPSHOT_CHUNK, [ns, offset, limit])[0])


class AsyncReplicator:
    """Follower-side replication thread (reference: ReplThread,
    cluster/replication/replicationthread.cc)."""

    SNAPSHOT_CHUNK = 1000    # docs per force-sync page (bounded memory)

    def __init__(self, follower: Reindexer, channel, poll_interval: float = 0.05):
        self.db = follower
        self.channel = channel
        self.poll_interval = poll_interval
        self.last_lsn = 0
        self.force_syncs = 0
        self.force_sync_chunks = 0
        self.data_hash_mismatches = 0
        self._hash_mismatch_streak = 0
        self.applied = 0
        # the namespaces this follower took from its leader
        self._replicated: set[str] = set()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._err: Optional[str] = None

    # --- lifecycle ------------------------------------------------------
    def start(self) -> None:
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)

    def sync_once(self) -> None:
        """One replication round (poll + apply); usable without the thread."""
        resp = self.channel.updates(self.last_lsn)
        if resp.get("force_sync"):
            self._force_sync()
            return
        for rec in resp.get("updates", []):
            self._apply(rec)
            self.last_lsn = rec["lsn"]
        self._verify_data_hash(resp)

    def _verify_data_hash(self, resp: dict) -> None:
        """Data-integrity check (reference: replication.md:67-70 Checksum/
        DataHash): once caught up, compare per-ns checksums; a mismatch
        stable across two rounds (leader may mutate between building the
        update list and reading the hashes) forces a resync."""
        hashes = resp.get("data_hash")
        if hashes is None or self.last_lsn != resp.get("last_lsn"):
            self._hash_mismatch_streak = 0
            return
        # a namespace taken from the leader that the leader no longer
        # holds is a mismatch too (a leader that ships no drop or rename)
        mismatch = any(
            name not in hashes and name in self.db._namespaces
            for name in self._replicated) or any(
            name in self.db._namespaces
            and self.db.get_namespace(name).data_hash != want
            for name, want in hashes.items())
        if not mismatch:
            self._hash_mismatch_streak = 0
            return
        self._hash_mismatch_streak += 1
        if self._hash_mismatch_streak >= 2:
            self.data_hash_mismatches += 1
            self._hash_mismatch_streak = 0
            self._force_sync()

    def wait_sync(self, leader_state_or_lsn, timeout: float = 10.0) -> bool:
        """Poll until follower LSN catches the leader (reference:
        test/helpers/wait_sync.go:21-40 polling #memstats LSNs)."""
        target = (leader_state_or_lsn.wal.last_lsn
                  if isinstance(leader_state_or_lsn, ReplicationState)
                  else int(leader_state_or_lsn))
        deadline = time.time() + timeout
        while time.time() < deadline:
            if self.last_lsn >= target:
                return True
            time.sleep(0.01)
        return self.last_lsn >= target

    # --- internals ------------------------------------------------------
    def _loop(self) -> None:
        while not self._stop.is_set():
            try:
                self.sync_once()
                self._err = None
            except Exception as e:     # transport errors: retry next tick
                self._err = str(e)
            self._stop.wait(self.poll_interval)

    def _force_sync(self) -> None:
        """Chunked force sync (reference: snapshots stream in chunks applied
        via tx, namespace/snapshot/snapshot.h) — memory stays bounded by
        SNAPSHOT_CHUNK docs regardless of namespace size. Falls back to the
        monolithic snapshot verb for channels that lack the chunk verbs."""
        self.force_syncs += 1
        if not hasattr(self.channel, "snapshot_meta"):
            self._force_sync_monolithic()
            return
        meta = self.channel.snapshot_meta()
        self._drop_missing(meta)
        for ns_meta in meta.get("namespaces", []):
            name = ns_meta["name"]
            try:
                self.db.drop_namespace(name)
            except NotFoundError:
                pass
            self._replicated.add(name)
            ns = self.db.open_namespace(
                name, [IndexDef.from_dict(d) for d in ns_meta["indexes"]])
            for k, v in ns_meta.get("meta", {}).items():
                ns.put_meta(k, v)
            offset = 0
            while offset >= 0:
                chunk = self.channel.snapshot_chunk(
                    name, offset, self.SNAPSHOT_CHUNK)
                self.force_sync_chunks += 1
                tx = self.db.new_transaction(name)
                for doc in chunk["items"]:
                    tx.upsert(doc)
                tx.commit()
                offset = chunk["next_offset"]
        self.last_lsn = meta["lsn"]

    def _force_sync_monolithic(self) -> None:
        snap = self.channel.snapshot()
        self._drop_missing(snap)
        for ns_snap in snap.get("namespaces", []):
            name = ns_snap["name"]
            try:
                self.db.drop_namespace(name)
            except NotFoundError:
                pass
            self._replicated.add(name)
            ns = self.db.open_namespace(
                name, [IndexDef.from_dict(d) for d in ns_snap["indexes"]])
            for k, v in ns_snap.get("meta", {}).items():
                ns.put_meta(k, v)
            for doc in ns_snap["items"]:
                ns.upsert(doc)
        self.last_lsn = snap["lsn"]

    def _drop_missing(self, snap: dict) -> None:
        """Drop the replicated namespaces a snapshot no longer holds."""
        keep = {ns["name"] for ns in snap.get("namespaces", [])}
        for name in sorted(self._replicated - keep):
            self._replicated.discard(name)
            try:
                self.db.drop_namespace(name)
            except NotFoundError:
                pass

    def _apply(self, rec: dict) -> None:
        op = rec["op"]
        ns_name = rec["ns"]
        if op in ("add_index", "upsert"):
            self._replicated.add(ns_name)
        if op == "drop_namespace":
            self._replicated.discard(ns_name)
            try:
                self.db.drop_namespace(ns_name)
            except NotFoundError:
                pass
        elif op == "rename_namespace":
            self._replicated.discard(ns_name)
            self._replicated.add(rec["to"])
            try:
                self.db.rename_namespace(ns_name, rec["to"])
            except NotFoundError:
                pass
        elif op == "add_index":
            self.db.open_namespace(ns_name)
            self.db.add_index(ns_name, IndexDef.from_dict(rec["index"]))
        elif op == "drop_index":
            self.db.drop_index(ns_name, rec["name"])
        elif op == "upsert":
            self.db.open_namespace(ns_name)
            self.db.get_namespace(ns_name).upsert(rec["doc"])
        elif op == "delete":
            self.db.get_namespace(ns_name).delete(rec["doc"])
        elif op == "truncate":
            self.db.truncate_namespace(ns_name)
        elif op == "put_meta":
            self.db.put_meta(ns_name, rec["key"], rec["value"])
        elif op == "delete_meta":
            self.db.delete_meta(ns_name, rec["key"])
        self.applied += 1

    def stats(self) -> dict:
        """#replicationstats analog (reference: cluster/stats/)."""
        return {"last_lsn": self.last_lsn, "applied": self.applied,
                "force_syncs": self.force_syncs, "error": self._err}

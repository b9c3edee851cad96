"""Persistence: snapshot + write-ahead log per namespace (port of
reindexer_tpu/storage/engine.py).

A copy of the reference's module (host only): the files, the sqlite tables
and the ANN cache are the reference's, so a storage root written by either
package opens in the other. Its vector-index imports name the port's
`index.vector.base`. Each engine also keeps `load_report`: per namespace
loaded, the seconds of its three steps (the snapshot's parse and upserts,
the ANN cache's load and upload, the WAL replay), the vector indexes whose
cached state was applied, and the records skipped as torn. Its WAL hook
reads the namespace's name at each write, so writes to a renamed namespace
land under its new name (the reference's hook keeps the old one: the JSONL
engine then fails to open the old directory's WAL, the sqlite engine logs
the writes under the old name).

The reference's notes follow.

Semantic equivalent of the reference persistence stack
(cpp_src/core/storage/: IDataStorage with LevelDB/RocksDB backends behind
a DSN; AsyncStorage write-behind batching namespace/asyncstorage.cc; WAL
cpp_src/wal/waltracker.h). Two engines behind the same surface, selected
by DSN like the reference's storage-type config
(cpp_src/core/storage/storagefactory.cc):

* `FileStorage` (plain path / `builtin://`): human-readable layout

      <path>/<namespace>/indexes.json   — index definitions
      <path>/<namespace>/meta.json      — user metadata
      <path>/<namespace>/items.jsonl    — snapshot of documents (row order)
      <path>/<namespace>/wal.jsonl      — append-only log since snapshot

* `SqliteStorage` (`sqlite://<path>`): one transactional stdlib-sqlite
  database (blobs/items/wal tables) — the embedded-KV analog of the
  reference's LevelDB backend (torn-tail writes are impossible here; the
  jsonl engine tolerates them on replay instead).

Writes append to the WAL through a namespace hook (the analog of the
reference's WAL tracker feeding AsyncStorage); `flush_namespace` compacts
WAL into a fresh snapshot. Vector-index device state checkpoints through
the ANN storage cache (storage/ann_cache.py), so restart skips HNSW/IVF
rebuild like the reference (namespace/ann_storage_cache_helper.h).
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
from typing import Optional

import numpy as np

from ..core.errors import StorageError
from ..core.payload import IndexDef


def open_storage(dsn: str):
    """DSN -> engine (reference: storagefactory.cc by storage type)."""
    if dsn.startswith("sqlite://"):
        return SqliteStorage(dsn[len("sqlite://"):])
    path = dsn[len("builtin://"):] if dsn.startswith("builtin://") else dsn
    return FileStorage(path) if path else None


def _wal_record(op: str, payload) -> dict:
    rec = {"op": op}
    if op in ("upsert", "delete", "put_meta", "delete_meta"):
        rec.update(payload)
    elif op == "add_index":
        rec["index"] = payload
    elif op == "drop_index":
        rec["name"] = payload["name"]
    return rec


def repair_storage(path: str) -> dict:
    """Offline storage repair (reference:
    cmd/reindexer_tool/repair_tool.cc — validate each namespace's storage,
    drop broken records, rewrite clean files).

    For every namespace directory under `path`:
      * `indexes.json` / `meta.json` must parse (else quarantined to
        `<file>.broken` and reported);
      * `items.jsonl` / `wal.jsonl` are rewritten without unparseable
        (torn-tail / corrupt) lines.
    Returns a per-namespace report dict."""
    report: dict[str, dict] = {}
    if not os.path.isdir(path):
        return report
    for entry in sorted(os.listdir(path)):
        d = os.path.join(path, entry)
        if not os.path.isdir(d):
            continue
        r = {"items_dropped": 0, "wal_dropped": 0, "quarantined": [],
             "ok": True}
        for name in ("indexes.json", "meta.json"):
            p = os.path.join(d, name)
            if os.path.isfile(p):
                try:
                    with open(p, encoding="utf-8") as f:
                        json.load(f)
                except ValueError:
                    os.replace(p, p + ".broken")
                    r["quarantined"].append(name)
                    r["ok"] = False
        for name in ("items.jsonl", "wal.jsonl"):
            p = os.path.join(d, name)
            if not os.path.isfile(p):
                continue
            good, dropped = [], 0
            with open(p, encoding="utf-8") as f:
                for line in f:
                    s = line.strip()
                    if not s:
                        continue
                    try:
                        json.loads(s)
                        good.append(s)
                    except ValueError:
                        dropped += 1
            if dropped:
                tmp = p + ".tmp"
                with open(tmp, "w", encoding="utf-8") as f:
                    f.write("\n".join(good) + ("\n" if good else ""))
                os.replace(tmp, p)
                r["items_dropped" if name == "items.jsonl"
                  else "wal_dropped"] = dropped
                r["ok"] = False
        if (r["items_dropped"] or r["wal_dropped"] or r["quarantined"]
                or os.path.isfile(os.path.join(d, "indexes.json"))
                or os.path.isfile(os.path.join(d, "wal.jsonl"))):
            report[entry] = r
    return report


def _write_ann_cache(cache, ns) -> None:
    """Write the state of every vector index of `ns`, its rows numbered as
    the snapshot just written numbers them on reload."""
    from ..index.vector.base import FloatVectorIndexBase
    rows = np.fromiter((r for r, doc in enumerate(ns.items)
                        if doc is not None), dtype=np.int64)
    for ix in ns.indexes:
        if isinstance(ix, FloatVectorIndexBase):
            cache.write(ns.name, ix, ns.item_count(), rows)


def _load_ann_cache(cache, ns) -> list[str]:
    """Apply the cached state of every vector index of `ns`; returns the
    names of the indexes whose state was applied."""
    from ..index.vector.base import FloatVectorIndexBase
    return [ix.name for ix in ns.indexes
            if isinstance(ix, FloatVectorIndexBase)
            and cache.load(ns.name, ix, ns.item_count())]


def _replay_wal(ns, records) -> int:
    """Apply WAL records to a loaded namespace (reference: per-doc LSN
    replay, replication.md:39-44). Returns the number of bad records."""
    skipped = 0
    for rec in records:
        if rec is None:
            skipped += 1
            continue
        op = rec.get("op")
        if op == "upsert" and "doc" in rec:
            ns.upsert(rec["doc"])
        elif op == "delete" and "doc" in rec:
            ns.delete(rec["doc"])
        elif op == "add_index":
            idef = IndexDef.from_dict(rec["index"])
            if idef.name not in ns.payload_type:
                ns.add_index(idef)
        elif op == "drop_index":
            if rec["name"] in ns.payload_type:
                ns.drop_index(rec["name"])
        elif op == "put_meta":
            ns.meta[rec["key"]] = rec["value"]
        elif op == "delete_meta":
            ns.meta.pop(rec["key"], None)
        elif op == "truncate":
            ns.truncate()
    return skipped


def _report(t0: float, t1: float, t2: float, applied: list[str],
            skipped: int) -> dict:
    return {"snapshot_s": t1 - t0, "ann_cache_s": t2 - t1,
            "wal_s": time.perf_counter() - t2, "ann_applied": applied,
            "skipped": skipped}


class FileStorage:
    WAL_COMPACT_THRESHOLD = 10000  # records before auto-compaction

    def __init__(self, path: str):
        self.path = path
        os.makedirs(path, exist_ok=True)
        self._wal_files: dict[str, object] = {}
        self._wal_counts: dict[str, int] = {}
        self._lock = threading.Lock()
        from .ann_cache import AnnStorageCache
        self.ann_cache = AnnStorageCache(path)
        self.load_report: dict[str, dict] = {}

    # ------------------------------------------------------------------
    def _ns_dir(self, name: str) -> str:
        return os.path.join(self.path, name)

    def namespace_names(self) -> list[str]:
        out = []
        if not os.path.isdir(self.path):
            return out
        for entry in sorted(os.listdir(self.path)):
            d = os.path.join(self.path, entry)
            # a namespace exists if it was ever snapshotted OR has WAL-only
            # history (created, mutated, crashed before the first flush)
            if os.path.isfile(os.path.join(d, "indexes.json")) or \
                    os.path.isfile(os.path.join(d, "wal.jsonl")):
                out.append(entry)
        return out

    # ------------------------------------------------------------------
    def attach_namespace(self, ns) -> None:
        """Register the WAL hook so mutations stream to disk."""
        os.makedirs(self._ns_dir(ns.name), exist_ok=True)
        # the hook reads the namespace's name at each write, so a renamed
        # namespace logs under its new name (the reference binds the name
        # at attach time)
        ns.wal_hooks.append(
            lambda op, payload, _ns=ns: self._wal_append(_ns.name, op,
                                                         payload))

    def _wal_append(self, ns_name: str, op: str, payload: dict) -> None:
        with self._lock:
            f = self._wal_files.get(ns_name)
            if f is None:
                f = open(os.path.join(self._ns_dir(ns_name), "wal.jsonl"), "a",
                         encoding="utf-8")
                self._wal_files[ns_name] = f
                self._wal_counts[ns_name] = 0
            try:
                rec = _wal_record(op, payload)
                f.write(json.dumps(rec, ensure_ascii=False, default=str) + "\n")
                f.flush()
                self._wal_counts[ns_name] += 1
            except (TypeError, ValueError) as e:
                raise StorageError(f"WAL serialization failed: {e}")

    # ------------------------------------------------------------------
    def flush_namespace(self, ns) -> None:
        """Write a full snapshot and truncate the WAL (compaction)."""
        d = self._ns_dir(ns.name)
        os.makedirs(d, exist_ok=True)
        with self._lock, ns.lock:
            with open(os.path.join(d, "indexes.json"), "w", encoding="utf-8") as f:
                json.dump([idef.to_dict() for idef in ns.index_defs()], f)
            with open(os.path.join(d, "meta.json"), "w", encoding="utf-8") as f:
                json.dump(ns.meta, f, ensure_ascii=False)
            tmp = os.path.join(d, "items.jsonl.tmp")
            with open(tmp, "w", encoding="utf-8") as f:
                for doc in ns.items:
                    if doc is not None:
                        f.write(json.dumps(doc, ensure_ascii=False, default=str) + "\n")
            os.replace(tmp, os.path.join(d, "items.jsonl"))
            walf = self._wal_files.pop(ns.name, None)
            if walf is not None:
                walf.close()
            wal_path = os.path.join(d, "wal.jsonl")
            if os.path.exists(wal_path):
                os.remove(wal_path)
            self._wal_counts[ns.name] = 0
            # persist vector-index device state (ANN cache: restart skips
            # HNSW/IVF rebuild, reference ann_storage_cache_helper.h)
            _write_ann_cache(self.ann_cache, ns)

    def load_namespace(self, ns) -> None:
        t0 = time.perf_counter()
        d = self._ns_dir(ns.name)
        idx_path = os.path.join(d, "indexes.json")
        if os.path.isfile(idx_path):
            with open(idx_path, encoding="utf-8") as f:
                for idef_dict in json.load(f):
                    ns.add_index(IndexDef.from_dict(idef_dict))
        meta_path = os.path.join(d, "meta.json")
        if os.path.isfile(meta_path):
            with open(meta_path, encoding="utf-8") as f:
                ns.meta.update(json.load(f))
        items_path = os.path.join(d, "items.jsonl")
        skipped = 0
        if os.path.isfile(items_path):
            with open(items_path, encoding="utf-8") as f:
                for line in f:
                    line = line.strip()
                    if not line:
                        continue
                    # torn/corrupted records are skipped, not fatal
                    # (reference: repair_tool semantics,
                    # cmd/reindexer_tool/repair_tool.cc)
                    try:
                        ns.upsert(json.loads(line))
                    except (ValueError, KeyError):
                        skipped += 1
        # apply cached ANN index states NOW — the cache stamp (item count at
        # flush) is only valid against the snapshot; WAL records replayed
        # below must land ON TOP of the cached state, otherwise an upsert of
        # an existing doc (count unchanged) would be clobbered by stale
        # cached vectors (reference stamps by lastUpdateTime/lsnCounter_,
        # ann_storage_cache_helper.h)
        t1 = time.perf_counter()
        applied = _load_ann_cache(self.ann_cache, ns)
        t2 = time.perf_counter()
        # replay WAL since last snapshot (torn tail writes — a crash
        # mid-append — yield None records, skipped by _replay_wal)
        wal_path = os.path.join(d, "wal.jsonl")
        if os.path.isfile(wal_path):
            def wal_iter():
                with open(wal_path, encoding="utf-8") as f:
                    for line in f:
                        line = line.strip()
                        if not line:
                            continue
                        try:
                            yield json.loads(line)
                        except ValueError:
                            yield None
            skipped += _replay_wal(ns, wal_iter())
        self.load_report[ns.name] = _report(t0, t1, t2, applied, skipped)

    def drop_namespace(self, name: str) -> None:
        with self._lock:
            f = self._wal_files.pop(name, None)
            if f is not None:
                f.close()
            d = self._ns_dir(name)
            if os.path.isdir(d):
                shutil.rmtree(d)

    def rename_namespace(self, src: str, dst: str) -> None:
        with self._lock:
            f = self._wal_files.pop(src, None)
            if f is not None:
                f.close()
            if os.path.isdir(self._ns_dir(src)):
                os.replace(self._ns_dir(src), self._ns_dir(dst))

    def close(self) -> None:
        with self._lock:
            for f in self._wal_files.values():
                f.close()
            self._wal_files.clear()


class SqliteStorage:
    """Transactional embedded-KV engine (stdlib sqlite3) behind the same
    surface as FileStorage — the analog of the reference's LevelDB backend
    (cpp_src/core/storage/leveldbstorage.cc behind IDataStorage)."""

    WAL_COMPACT_THRESHOLD = FileStorage.WAL_COMPACT_THRESHOLD

    def __init__(self, path: str):
        import sqlite3
        self.path = path
        os.makedirs(path, exist_ok=True)
        self._conn = sqlite3.connect(os.path.join(path, "storage.db"),
                                     check_same_thread=False)
        self._conn.execute("PRAGMA journal_mode=WAL")
        self._conn.execute("PRAGMA synchronous=NORMAL")
        self._conn.executescript("""
            CREATE TABLE IF NOT EXISTS blobs(
                ns TEXT, kind TEXT, data TEXT, PRIMARY KEY(ns, kind));
            CREATE TABLE IF NOT EXISTS items(
                ns TEXT, seq INTEGER, doc TEXT, PRIMARY KEY(ns, seq));
            CREATE TABLE IF NOT EXISTS wal(
                id INTEGER PRIMARY KEY AUTOINCREMENT, ns TEXT, rec TEXT);
        """)
        self._conn.commit()
        self._lock = threading.Lock()
        from .ann_cache import AnnStorageCache
        self.ann_cache = AnnStorageCache(path)
        self.load_report: dict[str, dict] = {}

    def namespace_names(self) -> list[str]:
        with self._lock:
            rows = self._conn.execute(
                "SELECT ns FROM blobs UNION SELECT ns FROM wal").fetchall()
        return sorted({r[0] for r in rows})

    def attach_namespace(self, ns) -> None:
        ns.wal_hooks.append(
            lambda op, payload, _ns=ns: self._wal_append(_ns.name, op,
                                                         payload))

    def _wal_append(self, ns_name: str, op: str, payload: dict) -> None:
        try:
            rec = json.dumps(_wal_record(op, payload), ensure_ascii=False,
                             default=str)
        except (TypeError, ValueError) as e:
            raise StorageError(f"WAL serialization failed: {e}")
        with self._lock:
            self._conn.execute("INSERT INTO wal(ns, rec) VALUES(?, ?)",
                               (ns_name, rec))
            self._conn.commit()

    def flush_namespace(self, ns) -> None:
        with self._lock, ns.lock:
            c = self._conn
            c.execute("DELETE FROM items WHERE ns = ?", (ns.name,))
            c.executemany(
                "INSERT INTO items(ns, seq, doc) VALUES(?, ?, ?)",
                ((ns.name, i, json.dumps(doc, ensure_ascii=False,
                                         default=str))
                 for i, doc in enumerate(ns.items) if doc is not None))
            c.execute(
                "INSERT OR REPLACE INTO blobs(ns, kind, data) VALUES(?,?,?)",
                (ns.name, "indexes",
                 json.dumps([d.to_dict() for d in ns.index_defs()])))
            c.execute(
                "INSERT OR REPLACE INTO blobs(ns, kind, data) VALUES(?,?,?)",
                (ns.name, "meta",
                 json.dumps(ns.meta, ensure_ascii=False, default=str)))
            c.execute("DELETE FROM wal WHERE ns = ?", (ns.name,))
            c.commit()
            _write_ann_cache(self.ann_cache, ns)

    def load_namespace(self, ns) -> None:
        t0 = time.perf_counter()
        with self._lock:
            idefs = self._conn.execute(
                "SELECT data FROM blobs WHERE ns=? AND kind='indexes'",
                (ns.name,)).fetchone()
            meta = self._conn.execute(
                "SELECT data FROM blobs WHERE ns=? AND kind='meta'",
                (ns.name,)).fetchone()
            docs = self._conn.execute(
                "SELECT doc FROM items WHERE ns=? ORDER BY seq",
                (ns.name,)).fetchall()
            wal = self._conn.execute(
                "SELECT rec FROM wal WHERE ns=? ORDER BY id",
                (ns.name,)).fetchall()
        if idefs:
            for idef_dict in json.loads(idefs[0]):
                ns.add_index(IndexDef.from_dict(idef_dict))
        if meta:
            ns.meta.update(json.loads(meta[0]))
        for (doc,) in docs:
            ns.upsert(json.loads(doc))
        t1 = time.perf_counter()
        applied = _load_ann_cache(self.ann_cache, ns)
        t2 = time.perf_counter()
        skipped = _replay_wal(ns, (json.loads(r[0]) for r in wal))
        self.load_report[ns.name] = _report(t0, t1, t2, applied, skipped)

    def drop_namespace(self, name: str) -> None:
        with self._lock:
            for table in ("blobs", "items", "wal"):
                self._conn.execute(f"DELETE FROM {table} WHERE ns = ?",
                                   (name,))
            self._conn.commit()

    def rename_namespace(self, src: str, dst: str) -> None:
        with self._lock:
            for table in ("blobs", "items", "wal"):
                self._conn.execute(f"UPDATE {table} SET ns = ? WHERE ns = ?",
                                   (dst, src))
            self._conn.commit()

    def close(self) -> None:
        with self._lock:
            self._conn.close()

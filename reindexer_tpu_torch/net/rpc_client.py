"""Port of reindexer_tpu/net/rpc_client.py: a copy of the reference's module
(host only; the same wire format).

The reference's notes follow.

Binary RPC client.

Semantic equivalent of the reference's network binding
(bindings/cproto/cproto.go connection POOL + Go query execution over
cproto; C++ client cpp_src/client/): blocking socket connections speaking
the framed varint protocol (net/protocol.py), with cursor-paged result
iteration (FetchResults analog). Concurrent callers spread over a lazy
connection pool (reference: cproto.go conn pool, default 8); cursors and
transactions are CONNECTION-AFFINE server-side (per-_Conn state,
net/rpc_server.py), so select() pins one pooled connection for its
fetch/close sequence and a transaction holds one until commit/rollback.
"""
from __future__ import annotations

import json
import queue
import socket
import threading
from typing import Any, Iterator, Optional, Sequence, Union

from ..core import cjson
from ..core.errors import (ConflictError, NotFoundError, ParamsError,
                           QueryCanceledError, QueryError, ReindexerError)
from ..core.payload import IndexDef
from ..query.dsl import to_dsl
from ..query.query import Query
from ..query.results import AggregationResult, QueryResults, ResultItem
from .protocol import Cmd, HEADER_SIZE, Status, pack_frame, unpack_header
from .serializer import decode_args, encode_args

_ERR_OF = {Status.QUERY_ERROR: QueryError, Status.PARAMS_ERROR: ParamsError,
           Status.NOT_FOUND: NotFoundError, Status.CONFLICT: ConflictError,
           Status.TIMEOUT: QueryCanceledError}


def _page_docs(page, tag_state=None) -> list:
    """Result page: stateful CJSON blob (per-connection delta tag table)
    or legacy JSON list."""
    if isinstance(page, (bytes, bytearray)):
        if tag_state is not None:
            return cjson.decode_docs_stateful(bytes(page), tag_state)
        return cjson.decode_docs(bytes(page))
    return [json.loads(p) for p in page]



class _ConnSlot:
    """One pooled connection: socket + frame sequence (used by a single
    thread at a time — the pool hands a slot to one caller)."""

    def __init__(self, addr, creds):
        self.sock = socket.create_connection(addr, timeout=30)
        # keep-alive request/response pairs hit the 40 ms Nagle/delayed-ACK
        # stall otherwise (round-5 serving forensics, docs/performance.md)
        self.sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self.seq = 0
        self.dead = False
        self.tag_state = cjson.TagState()   # mirrors the server connection
        user, password, db = creds
        self.call(Cmd.LOGIN, [user, password, db])

    def call(self, cmd: Cmd, args: list) -> list:
        self.seq += 1
        seq = self.seq
        try:
            self.sock.sendall(pack_frame(seq, cmd, 0, encode_args(args)))
            head = self._recv_exact(HEADER_SIZE)
            rseq, rcmd, status, length = unpack_header(head)
            body = self._recv_exact(length) if length else b""
        except (OSError, ConnectionError):
            self.dead = True
            raise
        if rseq != seq:
            self.dead = True
            raise ReindexerError(f"rpc sequence mismatch {rseq} != {seq}")
        out = decode_args(body) if body else []
        if status != Status.OK:
            msg = out[0] if out else "rpc error"
            raise _ERR_OF.get(Status(status), ReindexerError)(msg)
        return out

    def _recv_exact(self, n: int) -> bytes:
        buf = b""
        while len(buf) < n:
            chunk = self.sock.recv(n - len(buf))
            if not chunk:
                raise ConnectionError("rpc connection closed")
            buf += chunk
        return buf

    def close(self) -> None:
        self.dead = True
        try:
            self.sock.close()
        except OSError:
            pass


class RpcTransaction:
    """Holds one pooled connection until commit/rollback (tx ids are
    per-connection server-side)."""

    def __init__(self, client: "RpcReindexer", tx_id: int, slot):
        self._c = client
        self._id = tx_id
        self._slot = slot

    def _op(self, mode: int, doc: dict,
            precepts: Optional[list[str]] = None) -> "RpcTransaction":
        args: list = [self._id, mode, cjson.encode_doc(doc)]
        if precepts:
            args.append(json.dumps(precepts))
        self._c._call(Cmd.TX_MODIFY, args, slot=self._slot)
        return self

    def upsert(self, doc: dict, precepts=None) -> "RpcTransaction":
        return self._op(0, doc, precepts)

    def insert(self, doc: dict, precepts=None) -> "RpcTransaction":
        return self._op(1, doc, precepts)

    def update(self, doc: dict, precepts=None) -> "RpcTransaction":
        return self._op(2, doc, precepts)

    def delete(self, doc: dict) -> "RpcTransaction":
        return self._op(3, doc)

    def _finish(self, cmd: Cmd) -> list:
        try:
            return self._c._call(cmd, [self._id], slot=self._slot)
        finally:
            self._c._checkin(self._slot)
            self._slot = None

    def commit(self) -> int:
        return int(self._finish(Cmd.COMMIT_TX)[0])

    def rollback(self) -> None:
        self._finish(Cmd.ROLLBACK_TX)


class RpcSubscription:
    """Client side of an RPC-plane event subscription (reference: the Go
    connector's events stream over cproto, kCmdUpdates frames): a DEDICATED
    connection whose reader thread routes unsolicited seq-0 UPDATES_PUSH
    frames into a local queue."""

    def __init__(self, addr, creds, namespaces=(), event_types=(),
                 with_doc=True):
        self._slot = _ConnSlot(addr, creds)
        self._slot.call(Cmd.SUBSCRIBE_UPDATES, [
            1, json.dumps({"namespaces": list(namespaces),
                           "event_types": list(event_types),
                           "with_doc": bool(with_doc)})])
        self._q: "queue.Queue[dict]" = queue.Queue()
        self.closed = False
        self._reader = threading.Thread(target=self._read_loop, daemon=True)
        self._reader.start()

    def _read_loop(self) -> None:
        try:
            while not self.closed:
                head = self._slot._recv_exact(HEADER_SIZE)
                _seq, cmd, _status, length = unpack_header(head)
                body = self._slot._recv_exact(length) if length else b""
                if Cmd(cmd) != Cmd.UPDATES_PUSH:
                    continue            # unsubscribe/other replies
                for blob in decode_args(body):
                    self._q.put(json.loads(blob))
        except (ConnectionError, OSError, ValueError):
            pass

    def poll(self, timeout: Optional[float] = 1.0,
             max_events: int = 256) -> list[dict]:
        out: list[dict] = []
        try:
            out.append(self._q.get(timeout=timeout) if timeout
                       else self._q.get_nowait())
        except queue.Empty:
            return out
        while len(out) < max_events:
            try:
                out.append(self._q.get_nowait())
            except queue.Empty:
                break
        return out

    def close(self) -> None:
        if self.closed:
            return
        self.closed = True
        try:   # best-effort explicit unsubscribe (reply eaten by reader)
            self._slot.sock.sendall(pack_frame(
                1 << 20, Cmd.SUBSCRIBE_UPDATES, 0, encode_args([0, ""])))
        except OSError:
            pass
        self._slot.close()


class RpcReindexer:
    """Client facade over the binary protocol (same API shape as
    client.RemoteReindexer / the embedded Reindexer)."""

    def __init__(self, host: str, port: int, db: str,
                 user: str = "", password: str = "",
                 fetch_limit: int = 100, conns: int = 4):
        self._addr = (host, port)
        self._creds = (user, password, db)
        self.fetch_limit = fetch_limit
        self._pool: "queue.LifoQueue[_ConnSlot]" = queue.LifoQueue()
        self._max = max(1, conns)
        self._created = 0
        self._lock = threading.Lock()
        # eager first connection validates the login
        self._checkin(self._new_slot())

    # --- transport (pooled) --------------------------------------------
    def _new_slot(self) -> "_ConnSlot":
        with self._lock:
            self._created += 1
        try:
            return _ConnSlot(self._addr, self._creds)
        except BaseException:
            with self._lock:
                self._created -= 1
            raise

    def _checkout(self) -> "_ConnSlot":
        try:
            return self._pool.get_nowait()
        except queue.Empty:
            pass
        with self._lock:
            can_grow = self._created < self._max
        if can_grow:
            return self._new_slot()
        return self._pool.get()

    def _checkin(self, slot: "_ConnSlot") -> None:
        if slot.dead:
            with self._lock:
                self._created -= 1
            return
        self._pool.put(slot)

    def _call(self, cmd: Cmd, args: list,
              slot: "Optional[_ConnSlot]" = None) -> list:
        if slot is not None:
            return slot.call(cmd, args)
        s = self._checkout()
        try:
            return s.call(cmd, args)
        finally:
            self._checkin(s)

    def subscribe_updates(self, namespaces=(), event_types=(),
                          with_doc=True) -> "RpcSubscription":
        """Filtered WAL event stream over the RPC plane (reference:
        rpcserver.cc:1378 kCmdSubscribeUpdates + kCmdUpdates pushes)."""
        return RpcSubscription(self._addr, self._creds, namespaces,
                               event_types, with_doc)

    def close(self) -> None:
        while True:
            try:
                self._pool.get_nowait().close()
            except queue.Empty:
                return

    # --- API --------------------------------------------------------------
    def ping(self) -> bool:
        return self._call(Cmd.PING, [])[0] == "pong"

    def open_namespace(self, name: str,
                       indexes: Sequence[IndexDef] = ()) -> None:
        self._call(Cmd.OPEN_NAMESPACE,
                   [name, json.dumps([d.to_dict() for d in indexes])])

    def drop_namespace(self, name: str) -> None:
        self._call(Cmd.DROP_NAMESPACE, [name])

    def truncate_namespace(self, name: str) -> None:
        self._call(Cmd.TRUNCATE_NAMESPACE, [name])

    def namespace_names(self) -> list[str]:
        return self._call(Cmd.ENUM_NAMESPACES, [])[0]

    def add_index(self, ns: str, idef: IndexDef) -> None:
        self._call(Cmd.ADD_INDEX, [ns, json.dumps(idef.to_dict())])

    def drop_index(self, ns: str, name: str) -> None:
        self._call(Cmd.DROP_INDEX, [ns, name])

    def _modify(self, ns: str, mode: int, doc: dict,
                precepts: Optional[list[str]] = None) -> Optional[dict]:
        args: list = [ns, mode, cjson.encode_doc(doc)]
        if precepts:
            args.append(json.dumps(precepts))
        ret = self._call(Cmd.MODIFY_ITEM, args)
        if precepts and ret:
            # server echoes the precept-computed item (serial()/now())
            computed = json.loads(ret[0])
            doc.clear()
            doc.update(computed)
            return computed
        return None

    def upsert(self, ns: str, doc: dict, precepts=None) -> None:
        self._modify(ns, 0, doc, precepts)

    def insert(self, ns: str, doc: dict, precepts=None) -> None:
        self._modify(ns, 1, doc, precepts)

    def update(self, ns: str, doc: dict, precepts=None) -> None:
        self._modify(ns, 2, doc, precepts)

    def delete(self, ns: str, doc: dict) -> None:
        self._call(Cmd.MODIFY_ITEM, [ns, 3, cjson.encode_doc(doc)])

    def select(self, q: Union[Query, str],
               timeout_ms: Optional[float] = None) -> QueryResults:
        # the result cursor is per-connection server-side: pin ONE pooled
        # connection for the select + fetch + close sequence
        slot = self._checkout()
        try:
            return self._select_on(slot, q, timeout_ms)
        finally:
            self._checkin(slot)

    def _select_on(self, slot, q: Union[Query, str],
                   timeout_ms: Optional[float] = None) -> QueryResults:
        t = float(timeout_ms) if timeout_ms else 0.0
        if isinstance(q, str):
            out = self._call(Cmd.SELECT_SQL, [q, self.fetch_limit, 1, t],
                             slot=slot)
            ns = ""
        else:
            out = self._call(Cmd.SELECT_DSL,
                             [json.dumps(to_dsl(q), default=str),
                              self.fetch_limit, 1, t], slot=slot)
            ns = q.namespace
        req_id, total, count, page, ranks, aggs_json = out
        docs = _page_docs(page, slot.tag_state)
        items = [ResultItem(doc=d, row_id=i, ns_name=ns,
                            rank=(ranks[i] if ranks[i] else None))
                 for i, d in enumerate(docs)]
        # cursor-paged fetch of the remainder (reference: kCmdFetchResults)
        offset = len(items)
        while offset < count:
            fpage, franks = self._call(
                Cmd.FETCH_RESULTS, [req_id, offset, self.fetch_limit, 1],
                slot=slot)
            fdocs = _page_docs(fpage, slot.tag_state)
            for j, d in enumerate(fdocs):
                items.append(ResultItem(
                    doc=d, row_id=offset + j, ns_name=ns,
                    rank=(franks[j] if franks[j] else None)))
            if not fdocs:
                break
            offset += len(fdocs)
        self._call(Cmd.CLOSE_RESULTS, [req_id], slot=slot)
        aggs = []
        for a in json.loads(aggs_json):
            ar = AggregationResult(a.get("type", ""),
                                   tuple(a.get("fields", ())))
            ar.value = a.get("value")
            ar.distincts = a.get("distincts", [])
            aggs.append(ar)
        return QueryResults(ns_name=ns, items=items, total_count=total,
                            aggregations=aggs)

    def new_transaction(self, ns: str) -> RpcTransaction:
        slot = self._checkout()
        try:
            tx_id = int(self._call(Cmd.BEGIN_TX, [ns], slot=slot)[0])
        except BaseException:
            self._checkin(slot)
            raise
        return RpcTransaction(self, tx_id, slot)

    def put_meta(self, ns: str, key: str, value: str) -> None:
        self._call(Cmd.PUT_META, [ns, key, value])

    def get_meta(self, ns: str, key: str) -> Optional[str]:
        return self._call(Cmd.GET_META, [ns, key])[0]

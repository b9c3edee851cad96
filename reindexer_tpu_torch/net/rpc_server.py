"""Port of reindexer_tpu/net/rpc_server.py: the reference's server over the
port's databases: the manager's `Reindexer`s live on its torch device (a
manager made here takes `device`, default `cuda`), and the worker pool
calls them from several threads at once.

The reference's notes follow.

Binary RPC server.

Semantic equivalent of the reference RPC server
(cpp_src/server/rpcserver.cc dispatch table :1343-1392 + coroutine
connections net/cproto/serverconnection.cc): an asyncio acceptor replaces
the bespoke ev reactor + stackful coroutines (P6 in SURVEY.md §2.4 — host
concurrency is not device-relevant). Query results are held server-side in
cursors and paged by FETCH_RESULTS (RPCQrWatcher analog,
server/rpcqrwatcher.cc).
"""
from __future__ import annotations

import asyncio
import concurrent.futures
import itertools
import json
import os
import threading
import time
from typing import Any, Optional

from ..core.errors import (ConflictError, NotFoundError, ParamsError,
                           QueryCanceledError, QueryError, ReindexerError)
from ..core.payload import IndexDef
from ..server.auth import ROLE_ORDER
from ..query.dsl import parse_dsl
from ..core import cjson
from .protocol import (Cmd, HEADER_SIZE, MODIFY_MODES, Status, pack_frame,
                       unpack_header)
from .serializer import decode_args, encode_args

_STATUS_OF = {QueryError: Status.QUERY_ERROR, ParamsError: Status.PARAMS_ERROR,
              NotFoundError: Status.NOT_FOUND, ConflictError: Status.CONFLICT}


# commands that can block on the engine (device round trips, commits,
# snapshot builds) run in the worker pool; cheap metadata verbs stay
# inline on the loop (the executor hop costs more than they do)
_OFFLOADED = frozenset({
    Cmd.SELECT_SQL, Cmd.SELECT_DSL, Cmd.FETCH_RESULTS, Cmd.MODIFY_ITEM,
    Cmd.COMMIT_TX, Cmd.GET_SNAPSHOT, Cmd.GET_SNAPSHOT_META,
    Cmd.GET_SNAPSHOT_CHUNK, Cmd.GET_UPDATES,
})


def _status_of(e: ReindexerError) -> Status:
    if isinstance(e, QueryCanceledError):      # incl. QueryTimeoutError
        return Status.TIMEOUT
    return _STATUS_OF.get(type(e), Status.INTERNAL)


def _load_doc(payload) -> Any:
    """Item payload: CJSON binary (bytes) or JSON text — the wire accepts
    both, like the reference's per-item format flag (FormatCJson/FormatJson,
    rpcserver.cc modifyItem)."""
    if isinstance(payload, (bytes, bytearray)):
        return cjson.decode_doc(bytes(payload))
    return json.loads(payload)


def _dump_page(items, binary: bool, tag_state=None):
    """Result page: CJSON blob (binary clients) or JSON string list
    (legacy). With a per-connection TagState the blob carries only the tag
    NAMES the connection has not seen yet (reference: tagsmatcher.h
    stateToken_ — measured ~170 B/page for a 12-field schema, 73% of a
    single-doc page)."""
    if binary:
        if tag_state is not None:
            return cjson.encode_docs_stateful([it.doc for it in items],
                                              tag_state)
        return cjson.encode_docs([it.doc for it in items])
    return [json.dumps(it.doc, default=str) for it in items]


class _Conn:
    """Per-connection state (db binding, role, cursors, transactions)."""

    def __init__(self, server: "RpcServer"):
        self.server = server
        self.db = None
        self.user: Optional[str] = None
        self.role: str = "owner"      # auth disabled => unrestricted
        self.cursors: dict[int, Any] = {}
        self.txs: dict[int, Any] = {}
        self.ids = itertools.count(1)
        self.tag_state = cjson.TagState()   # cumulative per-connection tags
        self.sub = None                     # events subscription (RPC plane)
        self.sub_obs = None
        self.push_task = None


# per-verb minimum role (reference: rpcserver.cc getDB(ctx, kRole...) —
# OpenNamespace: data_read (:282); DropNamespace/Truncate/index DDL:
# db_admin (:286,294,376-392); item/tx/meta writes: data_write; selects by
# statement type (:217-223))
_VERB_NEED = {
    Cmd.OPEN_NAMESPACE: "data_read",
    Cmd.DROP_NAMESPACE: "db_admin",
    Cmd.TRUNCATE_NAMESPACE: "db_admin",
    Cmd.ENUM_NAMESPACES: "data_read",
    Cmd.ADD_INDEX: "db_admin",
    Cmd.UPDATE_INDEX: "db_admin",
    Cmd.DROP_INDEX: "db_admin",
    Cmd.MODIFY_ITEM: "data_write",
    Cmd.SELECT_SQL: "data_read",      # escalated by SQL statement type below
    Cmd.SELECT_DSL: "data_read",
    Cmd.FETCH_RESULTS: "data_read",
    Cmd.CLOSE_RESULTS: "data_read",
    Cmd.BEGIN_TX: "data_write",
    Cmd.TX_MODIFY: "data_write",
    Cmd.COMMIT_TX: "data_write",
    Cmd.ROLLBACK_TX: "data_write",
    Cmd.PUT_META: "data_write",
    Cmd.GET_META: "data_read",
    Cmd.ENUM_META: "data_read",
    Cmd.SUBSCRIBE_UPDATES: "data_read",
    Cmd.GET_SNAPSHOT: "data_read",
    Cmd.GET_UPDATES: "data_read",
    Cmd.GET_SNAPSHOT_META: "data_read",
    Cmd.GET_SNAPSHOT_CHUNK: "data_read",
}

_SQL_NEED = {"UPDATE": "data_write", "DELETE": "data_write",
             "TRUNCATE": "db_admin", "DROP": "db_admin"}


class RpcServer:
    def __init__(self, mgr=None, host: str = "127.0.0.1", port: int = 0,
                 auth=None, device="cuda"):
        """device: the torch device of the databases of the manager made
        here when `mgr` is None."""
        from ..server.http import DBManager
        self.mgr = mgr or DBManager(device=device)
        self.auth = auth
        self.host = host
        self._port = port
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._server: Optional[asyncio.AbstractServer] = None
        self._thread: Optional[threading.Thread] = None
        self._started = threading.Event()
        # commands run OFF the event loop so connections overlap their
        # device round trips (the reference's per-connection stackful
        # coroutines yield during blocking work, serverconnection.cc; an
        # asyncio loop that calls db.select inline would serialize every
        # client behind one drain). Per-connection ordering is preserved:
        # _handle awaits each request fully before reading the next.
        self._executor = concurrent.futures.ThreadPoolExecutor(
            max_workers=int(os.environ.get("RX_RPC_WORKERS", "16")),
            thread_name_prefix="rpc-worker")

    @property
    def port(self) -> int:
        return self._port

    # --- lifecycle ------------------------------------------------------
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
        if self._loop is not None:
            async def shutdown():
                if self._server is not None:
                    self._server.close()
                tasks = [t for t in asyncio.all_tasks(self._loop)
                         if t is not asyncio.current_task()]
                for task in tasks:
                    task.cancel()
                # drain the cancellations so connection handlers run their
                # finally blocks before the loop dies (no "task destroyed
                # but pending" at shutdown)
                await asyncio.gather(*tasks, return_exceptions=True)
                self._loop.stop()
            asyncio.run_coroutine_threadsafe(shutdown(), self._loop)
        if self._thread is not None:
            self._thread.join(timeout=5)
        self._executor.shutdown(wait=False, cancel_futures=True)

    # --- connection loop --------------------------------------------------
    async def _handle(self, reader: asyncio.StreamReader,
                      writer: asyncio.StreamWriter) -> None:
        conn = _Conn(self)
        peer = writer.get_extra_info("peername") or ("?", 0)
        # client registration feeds #clientsstats (reference: RPC clients
        # stats, server/rpcserver.cc + clientsstats.h)
        stat = {"client_id": id(conn) & 0xFFFF, "ip": f"{peer[0]}:{peer[1]}",
                "start_time": time.time(), "recv_bytes": 0, "sent_bytes": 0,
                "user_name": "", "client_version": "rpc"}
        registered_db = None
        wlock = asyncio.Lock()     # the event pusher shares the writer
        try:
            while True:
                head = await reader.readexactly(HEADER_SIZE)
                seq, cmd, _, length = unpack_header(head)
                body = await reader.readexactly(length) if length else b""
                stat["recv_bytes"] += HEADER_SIZE + length
                try:
                    args = decode_args(body) if body else []
                    cmd_e = Cmd(cmd)
                    if cmd_e in _OFFLOADED:
                        # device-blocking work leaves the event loop so
                        # other connections overlap their round trips
                        result = await self._loop.run_in_executor(
                            self._executor, self._dispatch, conn, cmd_e,
                            args)
                    else:
                        result = self._dispatch(conn, cmd_e, args)
                    out = pack_frame(seq, cmd, Status.OK,
                                     encode_args(result))
                except ReindexerError as e:
                    st = _status_of(e)
                    out = pack_frame(seq, cmd, st, encode_args([str(e)]))
                except Exception as e:   # pragma: no cover
                    out = pack_frame(seq, cmd, Status.INTERNAL,
                                     encode_args([str(e)]))
                stat["sent_bytes"] += len(out)
                stat["user_name"] = conn.user or ""
                if conn.db is not None and registered_db is not conn.db:
                    if registered_db is not None:
                        getattr(registered_db, "_clients", {}).pop(
                            id(conn), None)
                    if not hasattr(conn.db, "_clients"):
                        conn.db._clients = {}
                    conn.db._clients[id(conn)] = stat
                    registered_db = conn.db
                async with wlock:
                    writer.write(out)
                    await writer.drain()
                # events push stream lifecycle (reference: the connection's
                # UpdatesPusher, rpcserver.cc:1226-1248): start after the
                # SubscribeUpdates reply, stop on unsubscribe
                if conn.sub is not None and conn.push_task is None:
                    conn.push_task = asyncio.ensure_future(
                        self._push_events(conn, writer, wlock))
                elif conn.sub is None and conn.push_task is not None:
                    conn.push_task.cancel()
                    conn.push_task = None
        except (asyncio.IncompleteReadError, ConnectionError):
            pass
        finally:
            if conn.push_task is not None:
                conn.push_task.cancel()
            if conn.sub is not None and conn.sub_obs is not None:
                conn.sub_obs.unsubscribe(conn.sub)
                conn.sub = None
            if registered_db is not None:
                getattr(registered_db, "_clients", {}).pop(id(conn), None)
            try:
                writer.close()
            except RuntimeError:       # loop already closed at shutdown
                pass

    async def _push_events(self, conn: _Conn, writer, wlock) -> None:
        """Push filtered WAL events as unsolicited seq-0 UPDATES_PUSH frames
        (reference: cproto kCmdUpdates=91 over the subscribed connection)."""
        import json as _json
        try:
            while conn.sub is not None and not conn.sub.closed:
                events = conn.sub.poll(timeout=0)
                if events:
                    body = encode_args(
                        [_json.dumps(e.to_dict(), default=str)
                         for e in events])
                    out = pack_frame(0, Cmd.UPDATES_PUSH, Status.OK, body)
                    async with wlock:
                        writer.write(out)
                        await writer.drain()
                else:
                    await asyncio.sleep(0.03)
        except (ConnectionError, asyncio.CancelledError, RuntimeError):
            pass

    # --- dispatch (reference: rpcserver.cc:1343-1392) ---------------------
    def _dispatch(self, conn: _Conn, cmd: Cmd, args: list) -> list:
        if cmd == Cmd.PING:
            return ["pong"]
        if cmd == Cmd.LOGIN:
            user, password, db_name = args[0], args[1], args[2]
            if self.auth is not None and self.auth.enabled:
                import base64
                token = base64.b64encode(
                    f"{user}:{password}".encode()).decode()
                who = self.auth.authenticate(f"Basic {token}")
                if who is None:
                    raise ReindexerError("invalid credentials")
                conn.user = who
                conn.role = self.auth.role_for(who, db_name)
                if ROLE_ORDER[conn.role] < ROLE_ORDER["data_read"]:
                    raise ReindexerError(
                        f"forbidden: no access to database '{db_name}'")
                # only owners may implicitly create a missing database
                # (reference: dbmanager.cc:89 OpenDatabase canCreate gate)
                if db_name in self.mgr.names() \
                        or ROLE_ORDER[conn.role] >= ROLE_ORDER["owner"]:
                    conn.db = self.mgr.create(db_name)
                else:
                    conn.db = self.mgr.get(db_name)   # raises NotFound
            else:
                conn.db = self.mgr.create(db_name)
            return ["ok"]
        if conn.db is None:
            raise QueryError("not logged in (send LOGIN first)")
        db = conn.db
        need = _VERB_NEED.get(cmd, "db_admin")
        if cmd == Cmd.SELECT_SQL and args:
            head = str(args[0]).lstrip().split(None, 1)
            need = _SQL_NEED.get(head[0].upper() if head else "", need)
        if ROLE_ORDER[conn.role] < ROLE_ORDER[need]:
            raise ReindexerError(
                f"forbidden: role '{conn.role}' lacks '{need}' "
                f"for {cmd.name}")

        if cmd == Cmd.OPEN_NAMESPACE:
            ns, idefs = args[0], json.loads(args[1]) if args[1] else []
            db.open_namespace(ns, [IndexDef.from_dict(d) for d in idefs])
            return []
        if cmd == Cmd.DROP_NAMESPACE:
            db.drop_namespace(args[0])
            return []
        if cmd == Cmd.TRUNCATE_NAMESPACE:
            db.truncate_namespace(args[0])
            return []
        if cmd == Cmd.ENUM_NAMESPACES:
            return [db.namespace_names()]
        if cmd == Cmd.ADD_INDEX:
            db.add_index(args[0], IndexDef.from_dict(json.loads(args[1])))
            return []
        if cmd == Cmd.UPDATE_INDEX:
            db.update_index(args[0], IndexDef.from_dict(json.loads(args[1])))
            return []
        if cmd == Cmd.DROP_INDEX:
            db.drop_index(args[0], args[1])
            return []
        if cmd == Cmd.MODIFY_ITEM:
            ns, mode, doc = args[0], MODIFY_MODES[args[1]], _load_doc(args[2])
            # optional 4th arg: JSON list of precepts (reference:
            # rpcserver.cc modifyItem reads item precepts from the args)
            precepts = (json.loads(args[3])
                        if len(args) > 3 and args[3] else None)
            if mode == "delete":
                db.delete(ns, doc)
                return []
            getattr(db, mode)(ns, doc, precepts=precepts)
            # return the precept-computed item so clients see serial()/now()
            return [json.dumps(doc, default=str)] if precepts else []
        if cmd in (Cmd.SELECT_SQL, Cmd.SELECT_DSL):
            fetch_limit = int(args[1]) if len(args) > 1 else 100
            binary = len(args) > 2 and int(args[2]) == 1
            # optional execution deadline (reference: cproto execTimeout_)
            timeout_ms = (float(args[3])
                          if len(args) > 3 and args[3] else None)
            import contextlib
            if timeout_ms:
                from ..core import rdxcontext
                qctx = rdxcontext.context(timeout_ms=timeout_ms, tag="rpc")
            else:
                qctx = contextlib.nullcontext()
            with qctx:
                if cmd == Cmd.SELECT_SQL:
                    res = db.select(args[0])
                else:
                    res = db.select(parse_dsl(json.loads(args[0])))
            req_id = next(conn.ids)
            conn.cursors[req_id] = res
            total = (res.total_count if res.total_count is not None
                     else len(res))
            page = _dump_page(res[:fetch_limit], binary, conn.tag_state)
            ranks = [float(it.rank) if it.rank is not None else 0.0
                     for it in res[:fetch_limit]]
            aggs = json.dumps(res.agg_results())
            return [req_id, int(total), len(res), page, ranks, aggs]
        if cmd == Cmd.FETCH_RESULTS:
            req_id, offset, limit = int(args[0]), int(args[1]), int(args[2])
            binary = len(args) > 3 and int(args[3]) == 1
            res = conn.cursors.get(req_id)
            if res is None:
                raise NotFoundError(f"results cursor {req_id} not found")
            page = _dump_page(res[offset: offset + limit], binary,
                              conn.tag_state)
            ranks = [float(it.rank) if it.rank is not None else 0.0
                     for it in res[offset: offset + limit]]
            return [page, ranks]
        if cmd == Cmd.CLOSE_RESULTS:
            conn.cursors.pop(int(args[0]), None)
            return []
        if cmd == Cmd.BEGIN_TX:
            tx = db.new_transaction(args[0])
            tx_id = next(conn.ids)
            conn.txs[tx_id] = tx
            return [tx_id]
        if cmd == Cmd.TX_MODIFY:
            tx = conn.txs.get(int(args[0]))
            if tx is None:
                raise NotFoundError("transaction not found")
            mode, doc = MODIFY_MODES[args[1]], _load_doc(args[2])
            precepts = (json.loads(args[3])
                        if len(args) > 3 and args[3] else None)
            if mode == "delete":
                tx.delete(doc)
            else:
                getattr(tx, mode)(doc, precepts=precepts)
            return []
        if cmd == Cmd.COMMIT_TX:
            tx = conn.txs.pop(int(args[0]), None)
            if tx is None:
                raise NotFoundError("transaction not found")
            return [tx.commit()]
        if cmd == Cmd.ROLLBACK_TX:
            tx = conn.txs.pop(int(args[0]), None)
            if tx is None:
                raise NotFoundError("transaction not found")
            tx.rollback()
            return []
        if cmd == Cmd.SUBSCRIBE_UPDATES:
            # (flag, subscription_opts_json): flag=1 subscribe / 0 drop
            # (reference: rpcserver.cc:1226-1248 SubscribeUpdates with an
            # EventSubscriberConfig; events push as kCmdUpdates frames)
            from ..events import EventsObserver, EventSubscriberConfig
            flag = int(args[0])
            if not flag:
                if conn.sub is not None and conn.sub_obs is not None:
                    conn.sub_obs.unsubscribe(conn.sub)
                conn.sub = None
                return []
            opts = json.loads(args[1]) if len(args) > 1 and args[1] else {}
            obs = getattr(db, "_events_observer", None)
            if obs is None:
                obs = EventsObserver()
                obs.attach_db(db)
            if conn.sub is not None and conn.sub_obs is not None:
                conn.sub_obs.unsubscribe(conn.sub)
            cfg = EventSubscriberConfig(
                namespaces=tuple(opts.get("namespaces", ())),
                event_types=tuple(opts.get("event_types", ())),
                with_doc=bool(opts.get("with_doc", True)))
            conn.sub_obs = obs
            conn.sub = obs.subscribe(cfg)
            return []
        if cmd == Cmd.PUT_META:
            db.put_meta(args[0], args[1], args[2])
            return []
        if cmd == Cmd.GET_META:
            return [db.get_meta(args[0], args[1])]
        if cmd == Cmd.ENUM_META:
            return [db.enum_meta(args[0])]
        if cmd == Cmd.GET_SNAPSHOT:
            return [json.dumps(self._repl_state(db).snapshot(), default=str)]
        if cmd == Cmd.GET_UPDATES:
            state = self._repl_state(db)
            return [json.dumps(state.updates(int(args[0])), default=str)]
        if cmd == Cmd.GET_SNAPSHOT_META:
            return [json.dumps(self._repl_state(db).snapshot_meta(),
                               default=str)]
        if cmd == Cmd.GET_SNAPSHOT_CHUNK:
            chunk = self._repl_state(db).snapshot_chunk(
                args[0], int(args[1]), int(args[2]))
            return [json.dumps(chunk, default=str)]
        raise QueryError(f"unknown RPC command {cmd}")

    @staticmethod
    def _repl_state(db):
        state = getattr(db, "_replication_state", None)
        if state is None:
            from ..replication import ReplicationState
            state = ReplicationState(db)
        return state

"""Port of reindexer_tpu/tools/cli.py: the reference's tool; a local DSN
opens on `--device` (default `cuda`) and `--repair` runs the port's
`repair_storage`.

The reference's notes follow.

reindexer_tpu CLI tool: SQL REPL + dump/restore.

Semantic equivalent of the reference command-line tool
(cpp_src/cmd/reindexer_tool/commandsprocessor.cc): connects to a local
storage path (embedded) or a server URL (remote), executes SQL, and supports
the reference's backslash commands:

    \\namespaces           list namespaces
    \\upsert <ns> <json>   upsert one document
    \\delete <ns> <json>   delete one document
    \\meta <ns> [key]      list / read metadata
    \\dump [ns ...]        dump namespaces as restorable command stream
    \\quit

`dump` emits the same self-describing line format the tool can re-ingest
(reference dump/restore round-trip).
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import Optional, TextIO

from ..core.database import Reindexer
from ..core.errors import ReindexerError
from ..core.payload import IndexDef
from ..query.query import Query


def connect(dsn: str, device="cuda"):
    """builtin://<path> or http://host:port/<db>; a local database opens
    its vector indexes on the torch `device`."""
    if dsn.startswith("http://") or dsn.startswith("https://"):
        from ..client import RemoteReindexer
        base, _, db = dsn.rpartition("/")
        return RemoteReindexer(base, db)
    path = dsn[len("builtin://"):] if dsn.startswith("builtin://") else dsn
    return Reindexer(path, device=device)


def dump(db, namespaces: Optional[list[str]], out: TextIO) -> int:
    names = namespaces or db.namespace_names()
    count = 0
    for name in names:
        if hasattr(db, "get_namespace"):
            defs = [d.to_dict() for d in db.get_namespace(name).index_defs()]
        else:
            defs = [d.to_dict() for d in db.index_defs(name)]
        out.write(f"\\namespaces add {json.dumps({'name': name, 'indexes': defs}, ensure_ascii=False)}\n")
        res = db.select(Query(name))
        for doc in res.docs():
            out.write(f"\\upsert {name} {json.dumps(doc, ensure_ascii=False, default=str)}\n")
            count += 1
        if hasattr(db, "get_namespace"):
            ns = db.get_namespace(name)
            for k in ns.enum_meta():
                out.write(f"\\meta put {name} {json.dumps(k)} "
                          f"{json.dumps(ns.get_meta(k))}\n")
    return count


def execute_line(db, line: str, out: TextIO) -> None:
    line = line.strip()
    if not line or line.startswith("--"):
        return
    if not line.startswith("\\"):
        res = db.select(line)
        for doc in res.docs():
            out.write(json.dumps(doc, ensure_ascii=False, default=str) + "\n")
        for a in res.agg_results():
            out.write(json.dumps(a, ensure_ascii=False) + "\n")
        return
    parts = line.split(None, 2)
    cmd = parts[0][1:].lower()
    if cmd == "namespaces":
        if len(parts) >= 3 and parts[1] == "add":
            spec = json.loads(parts[2])
            db.open_namespace(spec["name"],
                              [IndexDef.from_dict(i)
                               for i in spec.get("indexes", [])])
        else:
            for n in db.namespace_names():
                out.write(n + "\n")
    elif cmd == "upsert":
        ns, doc = parts[1], json.loads(parts[2])
        db.upsert(ns, doc)
    elif cmd == "delete":
        ns, doc = parts[1], json.loads(parts[2])
        db.delete(ns, doc)
    elif cmd == "meta":
        if len(parts) >= 3 and parts[1] == "put":
            ns, rest = parts[2].split(None, 1)
            key_json, val_json = rest.split(None, 1)
            db.put_meta(ns, json.loads(key_json), json.loads(val_json))
        else:
            ns = parts[1]
            key = parts[2] if len(parts) > 2 else None
            if key:
                out.write(str(db.get_meta(ns, key)) + "\n")
            elif hasattr(db, "get_namespace"):
                for k in db.get_namespace(ns).enum_meta():
                    out.write(k + "\n")
    elif cmd == "dump":
        names = " ".join(parts[1:]).split() if len(parts) > 1 else None
        if names and names[0] == "wal":
            # WAL dump (reference: reindexer_tool \dump wal): replication
            # log records from the given LSN (default: all retained)
            state = getattr(db, "_replication_state", None)
            if state is None:
                from ..replication import ReplicationState
                state = ReplicationState(db)
            from_lsn = int(names[1]) if len(names) > 1 else 0
            for rec in state.updates(from_lsn).get("updates", []):
                out.write(json.dumps(rec, ensure_ascii=False,
                                     default=str) + "\n")
        else:
            dump(db, names, out)
    elif cmd == "wal":
        # WAL-as-query (reference: wal/walselecter.cc): \wal <ns> [from_lsn]
        from ..query.query import Query
        ns = parts[1]
        from_lsn = int(parts[2]) if len(parts) > 2 else 0
        res = db.select(Query(ns).where("#lsn", ">", from_lsn))
        for doc in res.docs():
            out.write(json.dumps(doc, ensure_ascii=False, default=str)
                      + "\n")
    elif cmd in ("quit", "q", "exit"):
        raise EOFError
    else:
        out.write(f"unknown command: \\{cmd}\n")


def main(argv: Optional[list[str]] = None) -> int:
    ap = argparse.ArgumentParser(prog="reindexer_tpu_torch_tool")
    ap.add_argument("--dsn", default="builtin://",
                    help="builtin://<path> or http://host:port/<db>")
    ap.add_argument("--command", "-c", action="append", default=[],
                    help="execute command(s) and exit")
    ap.add_argument("--filename", "-f", help="execute commands from file "
                    "(restore a dump)")
    ap.add_argument("--output", "-o", help="write output to file")
    ap.add_argument("--repair", action="store_true",
                    help="offline storage repair: validate + rewrite the "
                         "namespace files under the builtin:// DSN path "
                         "(reference: reindexer_tool --repair, "
                         "cmd/reindexer_tool/repair_tool.cc)")
    ap.add_argument("--device", default="cuda",
                    help="torch device of a local database's vector indexes "
                         "(cuda, cuda:<n> or cpu)")
    args = ap.parse_args(argv)

    if args.repair:
        from ..storage.engine import repair_storage
        path = args.dsn
        if path.startswith("builtin://"):
            path = path[len("builtin://"):]
        report = repair_storage(path)
        print(json.dumps(report, indent=2, sort_keys=True))
        return 0 if all(r["ok"] for r in report.values()) else 1

    db = connect(args.dsn, args.device)
    out: TextIO = open(args.output, "w", encoding="utf-8") if args.output \
        else sys.stdout
    try:
        if args.filename:
            with open(args.filename, encoding="utf-8") as f:
                for line in f:
                    execute_line(db, line, out)
            return 0
        if args.command:
            for c in args.command:
                execute_line(db, c, out)
            return 0
        # REPL
        while True:
            try:
                line = input("reindexer_tpu> ")
                execute_line(db, line, out)
            except EOFError:
                break
            except ReindexerError as e:
                print(f"error: {e}", file=sys.stderr)
        return 0
    finally:
        if args.output:
            out.close()
        if hasattr(db, "close"):
            db.close()


if __name__ == "__main__":
    sys.exit(main())

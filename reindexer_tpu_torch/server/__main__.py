"""Port of reindexer_tpu/server/__main__.py: the reference's daemon with
`--device` (default `cuda`): every database of the storage root opens on
that torch device. `--grpc-port` other than 0 serves the gRPC plane over
the same databases; only then is `grpcio` imported.

The reference's notes follow.

Standalone server daemon (reference: cpp_src/cmd/reindexer_server —
yaml/CLI-configured HTTP + RPC endpoints over one database root).

    python -m reindexer_tpu_torch.server --http-port 9088 --rpc-port 6534 \
        --storage /var/lib/reindexer_tpu [--user admin:secret:owner] \
        [--device cuda]
"""
from __future__ import annotations

import argparse
import signal
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="reindexer_tpu_torch_server")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--http-port", type=int, default=9088)
    ap.add_argument("--rpc-port", type=int, default=6534)
    ap.add_argument("--grpc-port", type=int, default=0,
                    help="enable the gRPC plane on this port (0 = off; "
                         "reference: optional ENABLE_GRPC service)")
    ap.add_argument("--storage", default="",
                    help="storage root (empty = in-memory databases)")
    ap.add_argument("--user", action="append", default=[],
                    help="name:password:role (repeatable); enables auth")
    ap.add_argument("--device", default="cuda",
                    help="torch device of every database's vector indexes "
                         "(cuda, cuda:<n> or cpu)")
    args = ap.parse_args(argv)

    auth = None
    if args.user:
        from .auth import AuthManager
        auth = AuthManager()
        for spec in args.user:
            name, password, role = (spec.split(":") + ["owner"])[:3]
            auth.add_user(name, password, {"*": role})

    from .http import ReindexerServer
    from ..net.rpc_server import RpcServer

    httpd = ReindexerServer(host=args.host, port=args.http_port,
                            storage_root=args.storage, auth=auth,
                            device=args.device)
    rpcd = RpcServer(mgr=httpd.mgr, host=args.host, port=args.rpc_port,
                     auth=auth)
    grpcd = None
    if args.grpc_port:
        from .grpc_service import GrpcReindexerServer
        grpcd = GrpcReindexerServer(mgr=httpd.mgr, host=args.host,
                                    port=args.grpc_port)
    httpd.start()
    rpcd.start()
    if grpcd is not None:
        grpcd.start()
    print(f"reindexer_tpu_torch server: http://{args.host}:{httpd.port} "
          f"rpc {args.host}:{rpcd.port} "
          f"grpc={grpcd.port if grpcd else 0} "
          f"storage={args.storage or '(memory)'} device={httpd.mgr.device}",
          flush=True)

    stop = []
    signal.signal(signal.SIGTERM, lambda *a: stop.append(1))
    try:
        while not stop:
            signal.pause()
    except KeyboardInterrupt:
        pass
    finally:
        if grpcd is not None:
            grpcd.stop()
        rpcd.stop()
        httpd.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())

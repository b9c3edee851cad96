"""Helpers of the tests that run one scenario in both packages
(tests/test_torch_{replication,cluster,sharding,orm,grpc}.py): a package's
API by name, with the port's databases on the CPU."""
import importlib
import time

PKGS = ("ref", "port")


class Pkg:
    """One package's API: its Reindexer (the port's on the CPU), its
    servers (in memory, port 0) and its modules by path."""

    def __init__(self, name: str):
        self.name = name
        self.top = "reindexer_tpu_torch" if name == "port" else "reindexer_tpu"
        self.api = importlib.import_module(self.top)

    def db(self, dsn: str = ""):
        if self.name == "port":
            return self.api.Reindexer(dsn, device="cpu")
        return self.api.Reindexer(dsn)

    def cpu(self) -> dict:
        """The keyword that puts a port object on the CPU, none for the
        reference."""
        return {"device": "cpu"} if self.name == "port" else {}

    def mod(self, path: str):
        return importlib.import_module(f"{self.top}.{path}")

    def http_server(self):
        return self.mod("server.http").ReindexerServer(port=0, **self.cpu())

    def rpc_server(self, mgr):
        return self.mod("net.rpc_server").RpcServer(mgr=mgr, port=0)

    def __getattr__(self, name):
        return getattr(self.api, name)


def both(scenario):
    """Run scenario(Pkg) in each package; its outcomes must be equal."""
    out = {name: scenario(Pkg(name)) for name in PKGS}
    assert out["port"] == out["ref"], out
    return out["port"]


def wait_until(cond, timeout: float) -> bool:
    """Poll cond() every 10 ms until it holds or `timeout` s pass."""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(0.01)
    return bool(cond())


def docs(db, ns: str, key: str = "id") -> list:
    """Every document of `ns` (any object with `select`), by `key`."""
    top = type(db).__module__.split(".")[0]
    query = importlib.import_module(top).Query(ns).limit(10 ** 9)
    return sorted(db.select(query).docs(), key=lambda d: d[key])


def hashes(db) -> dict:
    return {n: db.get_namespace(n).data_hash for n in db.namespace_names()}

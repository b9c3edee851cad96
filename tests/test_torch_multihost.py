"""A process-spanning mesh in the port (the twin of tests/test_multihost.py):
two OS processes, 4 CPU shards each, joined by torch.distributed over gloo
into one 8-shard mesh; the worker (reindexer_tpu_torch/tools/
multihost_worker.py) runs the sharded KNN leg, the BM25 legs and the
`Reindexer(mesh=...)` facade against a numpy oracle in each process. The
workers get their own time limit (WORKER_TIMEOUT) and are killed past it.
"""
import os
import socket
import subprocess
import sys

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER_TIMEOUT = 180


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_two_process_mesh():
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=_ROOT)
    procs = [
        subprocess.Popen([sys.executable, "-m",
                          "reindexer_tpu_torch.tools.multihost_worker",
                          str(pid), "2", str(port)],
                         cwd=_ROOT, stdout=subprocess.PIPE,
                         stderr=subprocess.STDOUT, text=True, env=env)
        for pid in range(2)
    ]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=WORKER_TIMEOUT)
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"worker {pid} failed:\n{out[-3000:]}"
        assert "MULTIHOST_OK" in out and "shards=8" in out, out[-3000:]

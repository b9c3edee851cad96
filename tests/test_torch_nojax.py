"""reindexer_tpu_torch runs with every `jax` / `jaxlib` import and the JAX
package `reindexer_tpu` itself blocked, and no file of it names the JAX
package in an import.

The run check is in a subprocess, so it never disturbs this worker's modules
(the JAX package's tests share it). The child blocks `jax`, `jaxlib` and
`reindexer_tpu` (exactly that top-level name, not `reindexer_tpu_torch`)
through a sys.meta_path finder, imports reindexer_tpu_torch, runs a scalar
namespace,
a vec_bf namespace, an SQ8 vec_bf namespace (all three modes), an IVF
namespace (select, knn_batch, a radius-only select) and an HNSW namespace
(select, knn_batch, a streaming query, an SQ8 HNSW field and an array
field) on the CPU, a full-text `match` select on a `text` index, imports
the storage, network, server, client, events and CLI modules, reopens a
persistent HNSW namespace from its ANN cache, imports the replication,
cluster, cluster transport, sharding, ORM and gRPC service modules (the
last without grpcio), syncs a follower over a `LeaderChannel`, runs a
KNN select over two shards, imports the mesh modules (parallel/ and the
multi-process worker), opens a 4-shard CPU mesh database with vec_bf, IVF,
HNSW and text fields and selects on each, and checks that no JAX module
got loaded, nor the JAX package. The static check reads every `*.py` of
the port, and chip_smoke.py, for an `import reindexer_tpu` or `from
reindexer_tpu` naming the JAX package.
"""
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
BLOCKED = ("jax", "jaxlib", "reindexer_tpu")
# `import reindexer_tpu` / `from reindexer_tpu` followed by ".", whitespace
# or the end of the line: the JAX package or one of its modules
REF_IMPORT = re.compile(r"\b(?:import|from)\s+reindexer_tpu(?:[.\s]|$)",
                        re.M)
PORT_FILES = sorted(
    str(p.relative_to(REPO))
    for p in (REPO / "reindexer_tpu_torch").rglob("*.py")) + ["chip_smoke.py"]

CHILD = r'''
import sys

class BlockJax:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "reindexer_tpu"):
            raise ImportError(f"import of {name} blocked")
        return None

sys.meta_path.insert(0, BlockJax())

import numpy as np
from reindexer_tpu_torch import (FloatVectorOpts, IndexDef, IndexOpts,
                                 KnnSearchParams, Query, Reindexer,
                                 VectorMetric)

db = Reindexer(device="cpu")
db.open_namespace("items", [
    IndexDef("id", "hash", "int", opts=IndexOpts(is_pk=True)),
    IndexDef("name", "tree", "string")])
for i in range(20):
    db.upsert("items", {"id": i, "name": f"n{i:02d}"})
res = db.select(Query("items").where("id", ">=", 15).sort("name", desc=True))
assert [d["id"] for d in res.docs()] == [19, 18, 17, 16, 15], res.docs()

db.open_namespace("vecs", [
    IndexDef("id", "hash", "int", opts=IndexOpts(is_pk=True)),
    IndexDef("v", "vec_bf", vector_opts=FloatVectorOpts(
        dims=8, metric=VectorMetric.L2))])
base = np.random.default_rng(0).normal(size=(50, 8)).astype(np.float32)
for i in range(50):
    db.upsert("vecs", {"id": i, "v": base[i].tolist()})
res = db.select(Query("vecs").where_knn("v", base[7], KnnSearchParams(k=3)))
want = np.argsort(((base - base[7]) ** 2).sum(1))[:3].tolist()
assert [d["id"] for d in res.docs()] == want, (res.docs(), want)
out = db.knn_batch("vecs", "v", base[:2], KnnSearchParams(k=2))
assert [r.docs()[0]["id"] for r in out] == [0, 1]

import reindexer_tpu_torch.index.vector.quantization
import reindexer_tpu_torch.ops.hnsw_kernels
from reindexer_tpu_torch import QuantizationConfig
from reindexer_tpu_torch.ops import scan, select
assert callable(scan.sq8_scan) and callable(scan.sq8_i8_scan)
assert callable(select.sq8_select) and callable(select.knn_scan_sq8)
modes = ("exact", "approx", "approx_rerank")
db.open_namespace("sq8", [
    IndexDef("id", "hash", "int", opts=IndexOpts(is_pk=True))] + [
    IndexDef(m, "vec_bf", vector_opts=FloatVectorOpts(
        dims=8, metric=VectorMetric.L2, quantization=QuantizationConfig(
            enabled=True, min_elements=16, mode=m))) for m in modes])
for i in range(50):
    db.upsert("sq8", {"id": i, **{m: base[i].tolist() for m in modes}})
for m in modes:
    res = db.select(Query("sq8").where_knn(m, base[7], KnnSearchParams(k=3)))
    assert [d["id"] for d in res.docs()][0] == 7, (m, res.docs())

from reindexer_tpu_torch import IvfSearchParams
from reindexer_tpu_torch.index.vector import ivf
db.open_namespace("ivf", [
    IndexDef("id", "hash", "int", opts=IndexOpts(is_pk=True)),
    IndexDef("v", "ivf", vector_opts=FloatVectorOpts(
        dims=8, metric=VectorMetric.L2, centroids_count=4))])
for i in range(50):
    db.upsert("ivf", {"id": i, "v": base[i].tolist()})
full = IvfSearchParams(k=3, nprobe=4)
res = db.select(Query("ivf").where_knn("v", base[7], full))
assert [d["id"] for d in res.docs()] == want, (res.docs(), want)
out = db.knn_batch("ivf", "v", base[:2], IvfSearchParams(k=2, nprobe=4))
assert [r.docs()[0]["id"] for r in out] == [0, 1]
d2 = ((base - base[7]) ** 2).sum(1)
radius = float(np.sort(d2)[5])
ivf.gather_scans.reset()
res = db.select(Query("ivf").where_knn(
    "v", base[7], IvfSearchParams(radius=radius, nprobe=4)))
assert ivf.gather_scans.value == 1
assert sorted(d["id"] for d in res.docs()) == sorted(
    np.flatnonzero(d2 < radius).tolist()), res.docs()

from reindexer_tpu_torch import HnswSearchParams
from reindexer_tpu_torch.index.vector.hnsw import HnswIndex
db.open_namespace("hnsw", [
    IndexDef("id", "hash", "int", opts=IndexOpts(is_pk=True)),
    IndexDef("grp", "hash", "int"),
    IndexDef("v", "hnsw", vector_opts=FloatVectorOpts(
        dims=8, metric=VectorMetric.L2, m=8, ef_construction=32)),
    IndexDef("q", "hnsw", vector_opts=FloatVectorOpts(
        dims=8, metric=VectorMetric.L2, m=8, quantization=QuantizationConfig(
            enabled=True, min_elements=16))),
    IndexDef("a", "hnsw", opts=IndexOpts(is_array=True),
             vector_opts=FloatVectorOpts(dims=8, metric=VectorMetric.L2))])
for i in range(50):
    db.upsert("hnsw", {"id": i, "grp": i % 2, "v": base[i].tolist(),
                       "q": base[i].tolist(),
                       "a": [base[i].tolist(), (base[i] + 50).tolist()]})
assert isinstance(db.get_namespace("hnsw").get_index("v"), HnswIndex)
for field in ("v", "q", "a"):
    res = db.select(Query("hnsw").where_knn(field, base[7],
                                            HnswSearchParams(k=3, ef=32)))
    assert [d["id"] for d in res.docs()] == want, (field, res.docs())
out = db.knn_batch("hnsw", "v", base[:2], HnswSearchParams(k=2, ef=16))
assert [r.docs()[0]["id"] for r in out] == [0, 1]
res = db.select(Query("hnsw").where("grp", "=", 1).where_knn(
    "v", base[7], HnswSearchParams()).limit(5))
odd = [i for i in np.argsort(d2).tolist() if i % 2 == 1][:5]
assert [d["id"] for d in res.docs()] == odd, (res.docs(), odd)

db.add_index("items", IndexDef("body", "text", "string"))
for i, text in enumerate(["red fox", "lazy dog", "red dog", "blue fox"]):
    db.upsert("items", {"id": 100 + i, "name": f"t{i}", "body": text})
res = db.select(Query("items").match("body", "red fox"))
assert [d["id"] for d in res.docs()][:2] == [100, 102], res.docs()

import tempfile
import reindexer_tpu_torch.client
import reindexer_tpu_torch.core.cjson
import reindexer_tpu_torch.core.protobuf
import reindexer_tpu_torch.events
import reindexer_tpu_torch.net.rpc_client
import reindexer_tpu_torch.net.rpc_server
import reindexer_tpu_torch.query.suggest
import reindexer_tpu_torch.server.__main__
import reindexer_tpu_torch.server.http
import reindexer_tpu_torch.storage.engine
import reindexer_tpu_torch.tools.cli
with tempfile.TemporaryDirectory() as root:
    pdb = Reindexer(root + "/db", device="cpu")
    pdb.open_namespace("p", [
        IndexDef("id", "hash", "int", opts=IndexOpts(is_pk=True)),
        IndexDef("v", "hnsw", vector_opts=FloatVectorOpts(
            dims=8, metric=VectorMetric.L2, m=8))])
    for i in range(50):
        pdb.upsert("p", {"id": i, "v": base[i].tolist()})
    pdb.close()
    pdb = Reindexer(root + "/db", device="cpu")
    assert pdb.storage.load_report["p"]["ann_applied"] == ["v"]
    res = pdb.select(Query("p").where_knn("v", base[7],
                                          HnswSearchParams(k=3, ef=32)))
    assert [d["id"] for d in res.docs()] == want, res.docs()

import reindexer_tpu_torch.cluster
import reindexer_tpu_torch.net.cluster_transport
import reindexer_tpu_torch.orm
import reindexer_tpu_torch.server.grpc_service
from reindexer_tpu_torch.replication import (AsyncReplicator, LeaderChannel,
                                             ReplicationState)
from reindexer_tpu_torch.sharding import (NamespaceShardingConfig, ShardSpec,
                                          ShardedReindexer)
follower = Reindexer(device="cpu")
repl = AsyncReplicator(follower, LeaderChannel(ReplicationState(db)))
repl.sync_once()
assert repl.force_syncs == 1
assert follower.get_namespace("vecs").data_hash == \
    db.get_namespace("vecs").data_hash
sr = ShardedReindexer([Reindexer(device="cpu") for _ in range(2)], [
    NamespaceShardingConfig("vecs", "id", (ShardSpec(0, values=(7,)),),
                            default_shard=1)])
sr.open_namespace("vecs", db.get_namespace("vecs").index_defs())
for i in range(50):
    sr.upsert("vecs", {"id": i, "v": base[i].tolist()})
res = sr.select(Query("vecs").where_knn("v", base[7], KnnSearchParams(k=3)))
assert [d["id"] for d in res.docs()] == want, (res.docs(), want)
assert len(sr.shards[0].select(Query("vecs"))) == 1
sr.close()
assert "grpc" not in sys.modules

import reindexer_tpu_torch.parallel.mesh
import reindexer_tpu_torch.parallel.sharded_ft
import reindexer_tpu_torch.parallel.sharded_hnsw
import reindexer_tpu_torch.parallel.sharded_ivf
import reindexer_tpu_torch.parallel.sharded_knn
import reindexer_tpu_torch.tools.multihost_worker
from reindexer_tpu_torch.parallel.context import MeshContext
mdb = Reindexer(mesh=MeshContext(["cpu"] * 4), device="cpu")
mdb.open_namespace("m", [
    IndexDef("id", "hash", "int", opts=IndexOpts(is_pk=True)),
    IndexDef("body", "text", "string"),
    IndexDef("bf", "vec_bf", vector_opts=FloatVectorOpts(
        dims=8, metric=VectorMetric.L2)),
    IndexDef("iv", "ivf", vector_opts=FloatVectorOpts(
        dims=8, metric=VectorMetric.L2, centroids_count=4)),
    IndexDef("hn", "hnsw", vector_opts=FloatVectorOpts(
        dims=8, metric=VectorMetric.L2, m=8))])
for i in range(50):
    mdb.upsert("m", {"id": i, "body": f"w{i % 5} x", "bf": base[i].tolist(),
                     "iv": base[i].tolist(), "hn": base[i].tolist()})
for field, params in (("bf", KnnSearchParams(k=3)),
                      ("iv", IvfSearchParams(k=3, nprobe=4)),
                      ("hn", HnswSearchParams(k=3, ef=32))):
    res = mdb.select(Query("m").where_knn(field, base[7], params))
    assert [d["id"] for d in res.docs()] == want, (field, res.docs())
assert len(mdb.get_namespace("m").get_index("bf").keeper.shards) == 4
res = mdb.select(Query("m").match("body", "w2"))
assert sorted(d["id"] for d in res.docs()) == list(range(2, 50, 5))

loaded = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "reindexer_tpu"))
assert not loaded, loaded
print("NOJAX-OK")
'''


def test_port_runs_with_jax_blocked():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (str(REPO), env.get("PYTHONPATH")) if p)
    proc = subprocess.run([sys.executable, "-c", CHILD], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "NOJAX-OK" in proc.stdout


@pytest.mark.parametrize("path", PORT_FILES)
def test_port_file_does_not_import_the_jax_package(path):
    text = (REPO / path).read_text()
    hits = [m.group(0) for m in REF_IMPORT.finditer(text)]
    assert not hits, f"{path} imports the JAX package: {hits}"


def test_reference_import_pattern():
    """The pattern catches the JAX package and its modules, and not the
    port's own name."""
    for line in ("import reindexer_tpu", "from reindexer_tpu.core import x",
                 "from reindexer_tpu import Query",
                 "    import reindexer_tpu\n"):
        assert REF_IMPORT.search(line), line
    for line in ("import reindexer_tpu_torch", "from reindexer_tpu_torch.ops "
                 "import scan", "# see reindexer_tpu/ops/pallas_scan.py"):
        assert not REF_IMPORT.search(line), line

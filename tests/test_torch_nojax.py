"""reindexer_tpu_torch runs with every `jax` / `jaxlib` import blocked.

The check runs in a subprocess, so it never disturbs this worker's modules
(the JAX package's tests share it). The child blocks JAX through a
sys.meta_path finder, imports reindexer_tpu_torch, runs a scalar namespace,
a vec_bf namespace, an SQ8 vec_bf namespace (all three modes) and an IVF
namespace (select, knn_batch, a radius-only select) on the CPU, checks that
the engines not ported yet raise NotImplementedError, and that no JAX module
got loaded.
"""
import os
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent

CHILD = r'''
import sys

class BlockJax:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib"):
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

for kind in ("hnsw",):
    try:
        db.add_index("vecs", IndexDef(kind, kind,
                                      vector_opts=FloatVectorOpts(dims=8)))
    except NotImplementedError:
        pass
    else:
        raise AssertionError(f"{kind} did not raise")
try:
    db.add_index("items", IndexDef("body", "text", "string"))
except NotImplementedError:
    pass
else:
    raise AssertionError("text did not raise")

loaded = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib"))
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

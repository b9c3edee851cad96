"""Tie order of the port's plain scan and of its mesh merge against the
reference (ROADMAP C1): among equal scores the lower row comes first, as
`lax.top_k` orders them. 400 identical 4-dim rows, L2, a zero query:
k = 129 takes the plain chunked scan (K2 takes k <= 128), which must return
rows 0-128, and under `grp = 0` (grp = id % 2) the 65 even rows among them,
on one device and on an 8-shard mesh, in both packages. The `cuda` tests
hold the port on the card to the same answer and skip without one (the
JAX package is imported inside the CPU tests only: the card's machine has
no JAX).
"""
import numpy as np
import pytest
import torch

import reindexer_tpu_torch as port
from reindexer_tpu_torch.ops.distance import stable_topk
from reindexer_tpu_torch.parallel.context import MeshContext

torch.set_num_threads(2)

N, K = 400, 129


def _tied_db(P, **kw):
    db = P.Reindexer(**kw)
    db.open_namespace("t", [
        P.IndexDef("id", "hash", "int", opts=P.IndexOpts(is_pk=True)),
        P.IndexDef("grp", "hash", "int"),
        P.IndexDef("vec", "vec_bf", vector_opts=P.FloatVectorOpts(
            dims=4, metric=P.VectorMetric.L2))])
    for i in range(N):
        db.upsert("t", {"id": i, "grp": i % 2, "vec": [1.0, 2.0, 3.0, 4.0]})
    return db


def _answers(P, db):
    zero = np.zeros(4, np.float32)
    full = db.select(P.Query("t").where_knn("vec", zero,
                                            P.KnnSearchParams(k=K)))
    grp0 = db.select(P.Query("t").where("grp", "=", 0).where_knn(
        "vec", zero, P.KnnSearchParams(k=K)))
    return [d["id"] for d in full.docs()], len(list(grp0.docs()))


def _ref_mesh():
    from reindexer_tpu.parallel.context import make_mesh_context
    return make_mesh_context(8)


@pytest.mark.parametrize("mesh", [False, True], ids=["one", "mesh8"])
def test_plain_scan_ties_keep_the_lower_rows(mesh):
    import reindexer_tpu as ref
    got_ref = _answers(ref, _tied_db(ref, **(
        {"mesh": _ref_mesh()} if mesh else {})))
    got_port = _answers(port, _tied_db(port, device="cpu", **(
        {"mesh": MeshContext(["cpu"] * 8)} if mesh else {})))
    assert got_ref == (list(range(K)), 65)
    assert got_port == got_ref


def test_stable_topk_orders_ties_by_column():
    s = torch.tensor([[1.0, 3.0, 3.0, 2.0, 3.0, float("-inf"), 3.0]])
    vals, cols = stable_topk(s, 4)
    assert cols.tolist() == [[1, 2, 4, 6]]
    assert vals.tolist() == [[3.0, 3.0, 3.0, 3.0]]
    vals, cols = stable_topk(s, 7)
    assert cols.tolist() == [[1, 2, 4, 6, 3, 0, 5]]


@pytest.mark.cuda
def test_plain_scan_ties_on_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels run only on the "
                    "card")
    assert _answers(port, _tied_db(port, device="cuda")) == \
        (list(range(K)), 65)
    assert _answers(port, _tied_db(port, device="cuda", mesh=MeshContext(
        ["cuda:0"] * 4))) == (list(range(K)), 65)
    s = torch.zeros((3, 100000), device="cuda")
    _, cols = stable_topk(s, 150)
    assert (cols.cpu() == torch.arange(150)).all()

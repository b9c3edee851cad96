"""The port's mesh mode must scale, not only match the oracle: the twins of
tests/test_mesh_scaling.py. A mesh-attached index's resident state is
row-partitioned over every shard (per-shard rows ∝ n/S, each shard's
tensors its own, on its device), so each shard's scan does n/S of the work.

The reference's third test counts JAX compile keys (pow2-bucketed k); the
port compiles nothing per k, so its twin checks the behaviour those keys
protect instead: every k of a bucket (and of the next) answers exactly the
oracle's ids, in both packages.
"""
import numpy as np
import pytest
import torch

import reindexer_tpu as ref
import reindexer_tpu_torch as port
from reindexer_tpu.parallel.context import make_mesh_context
from reindexer_tpu_torch.parallel.context import MeshContext

torch.set_num_threads(2)

S = 8


@pytest.fixture(scope="module")
def ctx():
    return MeshContext(["cpu"] * S)


def _defs(P, dims, **vo):
    return [
        P.IndexDef("id", "hash", "int", opts=P.IndexOpts(is_pk=True)),
        P.IndexDef("vec", P.IndexType.VEC_BF,
                   vector_opts=P.FloatVectorOpts(dims=dims, **vo)),
    ]


def _fill(db, ns, base):
    tx = db.new_transaction(ns)
    for i, v in enumerate(base):
        tx.upsert({"id": i, "vec": v.tolist()})
    tx.commit()


def _port_db(ctx, ns, base, **vo):
    db = port.Reindexer(mesh=ctx, device="cpu")
    db.open_namespace(ns, _defs(port, base.shape[1], **vo))
    _fill(db, ns, base)
    return db


def _shard_rows(tables):
    """Devices holding the per-shard tensors and their row counts; every
    tensor must be an allocation of its own."""
    assert len({t.data_ptr() for t in tables}) == len(tables)
    return {t.device for t in tables}, sorted(t.shape[0] for t in tables)


def test_bf_mesh_state_is_row_partitioned(ctx, rng):
    n, dims = 4096, 16
    base = rng.normal(size=(n, dims)).astype(np.float32)
    kp = _port_db(ctx, "sc", base, metric=port.VectorMetric.L2) \
        .get_namespace("sc").get_index("vec").keeper
    kp.flush()
    assert kp.count == n and kp.capacity >= n
    for name in ("data", "sq", "sq_eff"):
        devs, rows = _shard_rows([getattr(sh, name) for sh in kp.shards])
        assert devs == {torch.device("cpu")}
        # equal row partitions of the capacity => per-shard scan work n/S
        assert rows == [kp.capacity // S] * S
    # the host validity mirror and the shards agree row for row
    valid = np.concatenate([(sh.sq_eff < 1e29).numpy() for sh in kp.shards])
    np.testing.assert_array_equal(valid, kp.valid)


def test_bf_mesh_per_shard_rows_track_n(ctx, rng):
    """Doubling n doubles the per-shard partition (work ∝ n/S, not ∝ n),
    also when the capacity grows under a live mesh keeper."""
    dims = 16
    per_shard = {}
    for n in (2048, 4096):
        base = np.random.default_rng(n).normal(
            size=(n, dims)).astype(np.float32)
        db = _port_db(ctx, f"sc{n}", base, metric=port.VectorMetric.L2)
        kp = db.get_namespace(f"sc{n}").get_index("vec").keeper
        kp.flush()
        _, rows = _shard_rows([sh.data for sh in kp.shards])
        assert kp.count == n
        assert rows == [kp.capacity // S] * S
        per_shard[n] = rows[0]
        # every row reads back from its shard after the growth
        np.testing.assert_array_equal(kp.state_dict()["data"], base)
    assert per_shard[4096] == 2 * per_shard[2048]


def test_bf_mesh_jit_keys_bucket_pow2(ctx, rng):
    """Every k inside one pow2 bucket (5, 7, 8) and the next (9, 12, 16)
    gives the oracle's ids in both packages (the reference's compile-key
    test; the port has no compile keys)."""
    n, dims = 1024, 16
    base = rng.normal(size=(n, dims)).astype(np.float32)
    q = rng.normal(size=(dims,)).astype(np.float32)
    d2 = ((base - q) ** 2).sum(1)
    dbs = {"port": _port_db(ctx, "sk", base, metric=port.VectorMetric.L2),
           "ref": ref.Reindexer(mesh=make_mesh_context(S))}
    dbs["ref"].open_namespace("sk", _defs(ref, dims,
                                          metric=ref.VectorMetric.L2))
    _fill(dbs["ref"], "sk", base)
    for k in (5, 7, 8, 9, 12, 16):
        for name, db in dbs.items():
            P = port if name == "port" else ref
            res = db.select(P.Query("sk").where_knn(
                "vec", q, P.BruteForceSearchParams(k=k)))
            assert [d["id"] for d in res.docs()] == \
                np.argsort(d2)[:k].tolist(), (name, k)


def test_bf_mesh_sq8_codes_are_row_partitioned(ctx, rng):
    """Approx mode's resident u8 codes partition like the fp32 rows: the
    quantized sweep reads n/S/4 bytes a shard."""
    n, dims = 4096, 16
    base = rng.normal(size=(n, dims)).astype(np.float32)
    db = _port_db(ctx, "sq", base, metric=port.VectorMetric.L2,
                  quantization=port.QuantizationConfig(
                      enabled=True, mode="approx", min_elements=256))
    idx = db.get_namespace("sq").get_index("vec")
    q = rng.normal(size=(dims,)).astype(np.float32)
    res = db.select(port.Query("sq").where_knn(
        "vec", q, port.BruteForceSearchParams(k=10)))
    assert len(res.docs()) == 10   # engage the quantized mesh path first
    assert idx._quant is not None and idx._quant.active
    assert idx._quant.codes is None
    devs, rows = _shard_rows(idx._quant.shard_codes)
    assert devs == {torch.device("cpu")}
    assert rows == [idx.keeper.capacity // S] * S
    assert all(c.dtype == torch.uint8 for c in idx._quant.shard_codes)

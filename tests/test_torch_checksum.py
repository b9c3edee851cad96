"""The per-document checksum of reindexer_tpu_torch (core/namespace.py,
`_item_hash`): the C++ lane's text of float lists
(csrc/float_text_native.cpp) against json.dumps, and the checksum against
the JSON path it replaced, kept here as the oracle. The hash must not move:
replication compares the port's namespace hash with the JAX package's."""
import gc
import hashlib
import json
import math

import numpy as np
import pytest

import reindexer_tpu.core.namespace as ref_ns
from reindexer_tpu_torch import tracing
from reindexer_tpu_torch.core import namespace as ns

SEED = 2 ** 31 + 19


def oracle_hash(doc) -> int:
    """The checksum as it was computed before the lane (the JAX package's
    code): blake2b over json.dumps of the whole document."""
    blob = json.dumps(doc, sort_keys=True, separators=(",", ":"),
                      default=str).encode()
    return int.from_bytes(hashlib.blake2b(blob, digest_size=8).digest(),
                          "little")


@pytest.fixture(scope="module")
def lane():
    mod = ns._float_text_module()
    assert mod is not None, "the C++ lane did not build"
    return mod


def seeded_doubles() -> list:
    """Over 10^6 doubles of every kind a float's repr lays out apart."""
    rng = np.random.default_rng(SEED)
    n = 150_000
    parts = [
        # float32 rows widened, as a vector field holds them
        rng.normal(size=n).astype(np.float32).astype(np.float64),
        # full precision over a wide range of magnitudes
        rng.normal(size=n) * 10.0 ** rng.integers(-30, 31, n),
        # any bit pattern (NaNs and infinities among them)
        rng.integers(0, 2 ** 64, size=n, dtype=np.uint64).view(np.float64),
        # subnormals
        rng.integers(1, 2 ** 52, size=n, dtype=np.uint64).view(np.float64),
        # integral values, small and past 2**53
        rng.integers(-10 ** 6, 10 ** 6, n).astype(np.float64),
        rng.integers(-2 ** 62, 2 ** 62, n).astype(np.float64),
        # around the edges of the fixed notation, decimal point at -3..16
        rng.uniform(0.5, 10.0, n) * 10.0 ** rng.integers(-7, 20, n),
    ]
    edges = [0.0, -0.0, 1.0, -1.0, 1e-05, -1e-05, 0.0001, 1e15, 1e16,
             123456789012345680.0, 9999999999999998.0, 1e22, 0.1,
             9.999999999999999e-05, 5e-324, -5e-324, 2.2250738585072014e-308,
             1.7976931348623157e308, math.nan, math.inf, -math.inf]
    return np.concatenate(parts).tolist() + edges


def test_the_lanes_text_is_json_dumps_for_every_double(lane):
    values = seeded_doubles()
    assert len(values) >= 10 ** 6
    want = json.dumps(values, separators=(",", ":")).encode()
    got = lane.float_list_text(values)
    if got != want:
        bad = [(a, b) for a, b in zip(got[1:-1].split(b","),
                                      want[1:-1].split(b",")) if a != b]
        pytest.fail(f"{len(bad)} floats differ, first {bad[:5]}")
    assert lane.float_list_text(tuple(values[:1000])) == \
        json.dumps(values[:1000], separators=(",", ":")).encode()


@pytest.mark.parametrize("seq", [[1.0, 2], [1.0, True], [1.0, None],
                                 [np.float64(1.0)], [[1.0]], "1.0",
                                 np.zeros(3)],
                         ids=["int", "bool", "none", "np.float64", "nested",
                              "str", "ndarray"])
def test_the_lane_declines_what_is_not_a_list_of_exact_floats(lane, seq):
    assert lane.float_list_text(seq) is None


def seeded_docs() -> list:
    rng = np.random.default_rng(SEED + 1)
    vec = rng.normal(size=768).astype(np.float32).tolist()
    full = (rng.normal(size=96) * 1e-3).tolist()
    return [
        {"id": 1, "grp": 3, "vec": vec},
        {"vec": full, "id": 2, "grp": 0},
        {"id": 3, "meta": {"emb": vec[:16], "deep": {"v": full[:8]}},
         "tags": ["a", "b"]},
        {"id": 4, "arr": [vec[:4], full[:4], []], "n": 1.5},
        {"id": 5, "ints": list(range(50)), "vec": vec[:32]},
        {"id": 6, "mixed": [1.0, 2, "x", None, True, 2.5],
         "vec": tuple(full[:5])},
        {"id": 7, "nan": [math.nan, math.inf, -math.inf, -0.0, 0.0]},
        {"id": 8, "text": "rx.float-list", "vec": vec[:3]},
        {"id": 9, "rx.float-list": 1, "vec": vec[:3]},
        {"id": 10, "s": 'a"rx.float-list', "v": [1.0], "w": [2.0]},
        {"id": 11, "obj": np.arange(3), "f": np.float32(0.5),
         "vec": vec[:8]},
        {"id": 12, "u": "é中\n", "vec": [], "e": {}},
        # keys json writes as strings (sorted as numbers first)
        {13: "int key", 2.5: [0.5], 0: [1.0, 2.0], -1: True},
    ]


@pytest.mark.parametrize("i", range(len(seeded_docs())))
def test_the_checksum_is_the_json_paths(lane, i):
    doc = seeded_docs()[i]
    want = oracle_hash(doc)
    assert ns._item_hash(doc) == want
    assert ref_ns._item_hash(doc) == want


def test_the_checksum_does_not_see_key_order(lane):
    doc = seeded_docs()[0]
    assert ns._item_hash(dict(reversed(list(doc.items())))) == \
        ns._item_hash(doc)


@pytest.mark.parametrize("doc", [{"id": 1, "a": 1, 2: 3},
                                 {"id": 1, "v": [1.0, object.__new__(
                                     type("NoStr", (), {"__str__": None}))]}],
                         ids=["mixed_key_types", "str_raises"])
def test_a_document_json_cannot_encode_raises_as_before(lane, doc):
    with pytest.raises(TypeError) as old:
        oracle_hash(doc)
    with pytest.raises(TypeError) as new:
        ns._item_hash(doc)
    assert str(new.value) == str(old.value)


def test_a_circular_document_raises_as_before(lane):
    doc = {"id": 1, "v": [0.5]}
    doc["self"] = doc
    with pytest.raises(ValueError, match="Circular reference"):
        ns._item_hash(doc)


def test_without_the_lane_the_checksum_falls_back_and_counts(monkeypatch):
    docs = seeded_docs()
    monkeypatch.setattr(ns, "_FLOAT_TEXT_TRIED", True)
    monkeypatch.setattr(ns, "_FLOAT_TEXT", None)
    before = tracing.counters()["ns.hash_fallbacks"]
    assert [ns._item_hash(d) for d in docs] == [oracle_hash(d) for d in docs]
    assert tracing.counters()["ns.hash_fallbacks"] - before == len(docs)


def test_with_the_lane_no_checksum_falls_back(lane):
    before = tracing.counters()["ns.hash_fallbacks"]
    for d in seeded_docs():
        ns._item_hash(d)
    assert tracing.counters()["ns.hash_fallbacks"] == before


def test_a_namespaces_hash_is_the_json_paths_xor():
    from reindexer_tpu_torch import (FloatVectorOpts, IndexDef, IndexOpts,
                                     Reindexer, VectorMetric)
    rng = np.random.default_rng(SEED + 2)
    db = Reindexer(device="cpu")
    db.open_namespace("n", [
        IndexDef("id", "hash", "int", opts=IndexOpts(is_pk=True)),
        IndexDef("v", "vec_bf", vector_opts=FloatVectorOpts(
            dims=24, metric=VectorMetric.COSINE))])
    docs = {i: {"id": i, "v": rng.normal(size=24).astype(np.float32)
                .tolist(), "g": i % 3} for i in range(40)}
    for d in docs.values():
        db.upsert("n", d)
    # a replaced and a deleted document leave the XOR
    docs[5] = {"id": 5, "v": [0.25] * 24, "g": 9}
    db.upsert("n", docs[5])
    db.delete("n", docs.pop(7))
    want = 0
    for d in docs.values():
        want ^= oracle_hash(d)
    assert db.get_namespace("n").data_hash == want


def _vector_namespace():
    from reindexer_tpu_torch import (FloatVectorOpts, IndexDef, IndexOpts,
                                     Reindexer, VectorMetric)
    db = Reindexer(device="cpu")
    db.open_namespace("n", [
        IndexDef("id", "hash", "int", opts=IndexOpts(is_pk=True)),
        IndexDef("v", "vec_bf", vector_opts=FloatVectorOpts(
            dims=8, metric=VectorMetric.L2))])
    return db


def test_stored_vectors_leave_the_collectors_walk(lane):
    db = _vector_namespace()
    rng = np.random.default_rng(SEED + 3)
    floats = {"id": 1, "v": rng.normal(size=8).tolist(), "tags": [1.5, 2.5]}
    ints = {"id": 2, "v": [1, 2, 3, 4, 5, 6, 7, 8]}
    db.upsert("n", floats)
    db.upsert("n", ints)
    # the indexed vector of exact floats only; the document stays tracked
    assert not gc.is_tracked(floats["v"])
    assert gc.is_tracked(floats["tags"]) and gc.is_tracked(floats)
    assert gc.is_tracked(ints["v"])
    gc.collect()
    got = db.get_namespace("n").items
    assert floats in got and ints in got
    assert lane.untrack_float_list([0.5, math.nan]) is True
    assert lane.untrack_float_list([0.5, 1]) is False
    assert lane.untrack_float_list((0.5,)) is False


def test_without_the_lane_stored_vectors_stay_tracked(monkeypatch):
    monkeypatch.setattr(ns, "_FLOAT_TEXT_TRIED", True)
    monkeypatch.setattr(ns, "_FLOAT_TEXT", None)
    db = _vector_namespace()
    doc = {"id": 1, "v": [0.5] * 8}
    db.upsert("n", doc)
    assert gc.is_tracked(doc["v"])

"""The port's host layers against the JAX package's, through the public API.

reindexer_tpu_torch keeps its own copies of the reference's host layers
(core/, query/, index/{base,scalar,rtree}, the C++ host lanes). Each case
runs on `reindexer_tpu.Reindexer()` and on
`reindexer_tpu_torch.Reindexer(device="cpu")`, each holding the same
documents made from one seed, with the query built from each database's own
package, and requires equal results: the documents in order, their joined
documents, the total count and the aggregations. No vector index is
involved, so the results must be equal exactly.
"""
import numpy as np
import pytest

import reindexer_tpu as ref
import reindexer_tpu_torch as port
from reindexer_tpu.query import dsl as ref_dsl
from reindexer_tpu_torch.query import dsl as port_dsl

N_ITEMS, N_OTHER = 240, 60
NAMES = ("alpha", "beta", "gamma", "delta", "eps")


def make_db(pkg):
    """A database of pkg with `items` (scalar, array, store, composite and
    rtree indexes) and `other` (the joined namespace), from seed 7."""
    rng = np.random.default_rng(7)
    db = (port.Reindexer(device="cpu") if pkg is port else ref.Reindexer())
    pk = pkg.IndexDef("id", "hash", "int", opts=pkg.IndexOpts(is_pk=True))
    db.open_namespace("items", [
        pk,
        pkg.IndexDef("year", "tree", "int"),
        pkg.IndexDef("name", "hash", "string"),
        pkg.IndexDef("price", "tree", "double"),
        pkg.IndexDef("genres", "hash", "int",
                     opts=pkg.IndexOpts(is_array=True)),
        pkg.IndexDef("desc", "-", "string"),
        pkg.IndexDef("a", "-", "int"),
        pkg.IndexDef("b", "-", "string"),
        pkg.IndexDef("a+b", "hash", "composite", json_paths=("a", "b")),
        pkg.IndexDef("pt", "rtree", "point"),
    ])
    db.open_namespace("other", [
        pkg.IndexDef("id", "hash", "int", opts=pkg.IndexOpts(is_pk=True)),
        pkg.IndexDef("ref", "hash", "int"),
        pkg.IndexDef("grp", "hash", "int")])
    years = rng.integers(1990, 2025, N_ITEMS)
    prices = np.round(rng.uniform(0.5, 100.0, N_ITEMS), 2)
    names = rng.integers(0, len(NAMES), N_ITEMS)
    pts = rng.uniform(-5.0, 5.0, (N_ITEMS, 2))
    for i in range(N_ITEMS):
        db.upsert("items", {
            "id": i, "year": int(years[i]), "name": NAMES[names[i]],
            "price": float(prices[i]),
            "genres": sorted(set(rng.integers(0, 8, i % 4).tolist())),
            "desc": f"d{i % 13:02d}", "a": i % 5, "b": "xyz"[i % 3],
            "pt": pts[i].tolist(), "extra": i % 7})
    for j in range(N_OTHER):
        db.upsert("other", {"id": j, "ref": int(rng.integers(0, N_ITEMS)),
                            "grp": j % 4})
    return db


def summary(res) -> tuple:
    """What a caller sees of a QueryResults."""
    return ([(it.doc, it.joined) for it in res], res.total_count,
            res.agg_results())


def _dsl(pkg, d):
    return (port_dsl if pkg is port else ref_dsl).parse_dsl(d)


def _join_query(pkg, join):
    q = getattr(pkg.Query("items").where("year", ">", 2000), join)(
        pkg.Query("other").where("grp", "<", 3))
    return q.on("id", "EQ", "ref").query.sort("id")


def _tx(pkg, db):
    tx = db.new_transaction("items")
    tx.upsert({"id": 1000, "year": 2030, "name": "tx", "price": 1.0,
               "genres": [1], "a": 1, "b": "x", "pt": [0.0, 0.0]})
    tx.delete({"id": 3})
    tx.upsert({"id": 5, "year": 1999, "name": "tx5", "price": 2.0,
               "genres": [], "a": 2, "b": "y", "pt": [1.0, 1.0]})
    n = tx.commit()
    return n, summary(db.select(pkg.Query("items").where(
        "year", ">=", 2020).sort("id")))


def _update(pkg, db):
    res = db.update_query(pkg.Query("items").where("year", "<", 2000)
                          .set("flag", True))
    after = db.select(pkg.Query("items").where("flag", "=", True).sort("id"))
    return summary(res), summary(after)


def _update_expr(pkg, db):
    db.update_query(pkg.Query("items").where("name", "=", "beta")
                    .set_expression("price", "price * 2 + 1"))
    return summary(db.select(pkg.Query("items").where("name", "=", "beta")))


def _delete(pkg, db):
    n = db.delete_query(pkg.Query("items").where("year", "<", 2005)
                        .op_or().where("name", "=", "gamma"))
    return n, summary(db.select(pkg.Query("items").sort("id")))


def _select(build):
    """A case that selects the query build(pkg)."""
    return lambda pkg, db: summary(db.select(build(pkg)))


SQL_TEXT = ("SELECT * FROM items WHERE year >= 2005 AND NOT name = 'beta' "
            "ORDER BY price DESC LIMIT 12 OFFSET 2")
DSL = {"namespace": "items",
       "filters": [{"field": "year", "cond": "ge", "value": 2005},
                   {"op": "NOT", "field": "name", "cond": "eq",
                    "value": "beta"}],
       "sort": [{"field": "price", "desc": True}], "limit": 12, "offset": 2}

CASES = {
    "where_sort_limit": _select(lambda m: m.Query("items").where(
        "year", ">", 2010).sort("price", desc=True).limit(10).offset(3)),
    "range_multi_sort": _select(lambda m: m.Query("items").where(
        "year", "range", [2000, 2015]).sort("name").sort("id", desc=True)),
    "or_not": _select(lambda m: m.Query("items").where(
        "name", "=", "beta").op_or().where("name", "=", "delta").op_not()
        .where("year", "<", 2000)),
    "brackets": _select(lambda m: m.Query("items").where("year", ">=", 2010)
                        .open_bracket().where("name", "=", "alpha").op_or()
                        .where("price", "<", 20.0).close_bracket()),
    "array_set_allset": _select(lambda m: m.Query("items").where(
        "genres", "set", [3, 4]).op_or().where("genres", "allset", [1, 2])),
    "any_empty": _select(lambda m: m.Query("items").where(
        "genres", m.CondType.EMPTY).op_or().where("desc", "=", "d03")),
    "like_store": _select(lambda m: m.Query("items").where(
        "name", m.CondType.LIKE, "%ta").where("desc", ">", "d10")),
    "composite": _select(lambda m: m.Query("items").where(
        "a+b", "=", [(1, "y"), (3, "x")]).sort("id")),
    "composite_substitution": _select(lambda m: m.Query("items").where(
        "a", "=", 2).where("b", "=", "z")),
    "rtree_dwithin": _select(lambda m: m.Query("items").dwithin(
        "pt", (0.5, -0.5), 2.0).sort("id")),
    "aggregations": _select(lambda m: m.Query("items").where(
        "year", ">", 2000).aggregate_sum("price").aggregate_avg("year")
        .aggregate_min("price").aggregate_max("price").limit(0)),
    "facet": _select(lambda m: m.Query("items").aggregate_facet(
        "name", "a").limit(0)),
    "facet_array": _select(lambda m: m.Query("items").aggregate_facet(
        "genres").limit(0)),
    "distinct_total": _select(lambda m: m.Query("items").distinct("name")
                              .req_total_count().limit(3)),
    "sort_expression_between": _select(lambda m: m.Query("items")
                                       .where_between_fields("price", "ge",
                                                             "a")
                                       .sort("price * 2 + year").limit(15)),
    "inner_join": _select(lambda m: _join_query(m, "inner_join")),
    "left_join": _select(lambda m: _join_query(m, "left_join")),
    "sql": lambda m, db: summary(db.select(SQL_TEXT)),
    "dsl": lambda m, db: summary(db.select(_dsl(m, DSL))),
    "sql_aggregate": lambda m, db: summary(db.select(
        "SELECT COUNT(*), SUM(price), MAX(year) FROM items WHERE a = 1")),
    "sql_join": lambda m, db: summary(db.select(
        "SELECT * FROM items INNER JOIN other ON items.id = other.ref "
        "ORDER BY id")),
    "transaction": _tx,
    "update_query": _update,
    "update_expression": _update_expr,
    "delete_query": _delete,
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_host_layers_match_reference(case):
    got = [CASES[case](pkg, make_db(pkg)) for pkg in (ref, port)]
    assert got[0] == got[1]


def test_sql_and_dsl_forms_agree():
    """The SQL and DSL cases are one query in two forms."""
    db = make_db(port)
    assert (summary(db.select(SQL_TEXT))
            == summary(db.select(_dsl(port, DSL))))


def test_seams_raise_as_the_reference_does():
    """A streaming KNN query (HnswSearchParams with neither k nor radius)
    on a vec_bf index, ft_batch on a field that is not full-text, and a
    malformed select function raise the reference's QueryError, with its
    message, on the port; a well-formed one leaves the documents as the
    reference does where no full-text condition matched."""
    errors = []
    for pkg in (ref, port):
        db = make_db(pkg)
        db.add_index("items", pkg.IndexDef(
            "v", "vec_bf", vector_opts=pkg.FloatVectorOpts(dims=4)))
        calls = (
            lambda: db.select(pkg.Query("items").where_knn(
                "v", np.zeros(4, np.float32), pkg.HnswSearchParams())),
            lambda: db.ft_batch("items", "name", ["alpha"]),
            lambda: db.select(pkg.Query("items").limit(2).functions(
                "name highlight")))
        got = []
        for call in calls:
            with pytest.raises(pkg.QueryError) as info:
                call()
            got.append(str(info.value))
        errors.append(got)
    assert errors[0] == errors[1]
    highlighted = [summary(make_db(pkg).select(pkg.Query("items").where(
        "a", "=", 1).functions("name = highlight(<b>,</b>)")))
        for pkg in (ref, port)]
    assert highlighted[0] == highlighted[1]


def _composite_text_db(pkg):
    """`docs` with a composite index of type `text` over (a, b): the
    reference builds its host CompositeIndex for any composite definition,
    whatever its type, and so must the port."""
    db = (port.Reindexer(device="cpu") if pkg is port else ref.Reindexer())
    db.open_namespace("docs", [
        pkg.IndexDef("id", "hash", "int", opts=pkg.IndexOpts(is_pk=True)),
        pkg.IndexDef("a", "-", "int"),
        pkg.IndexDef("b", "-", "string"),
        pkg.IndexDef("ab", "text", "composite", json_paths=("a", "b"))])
    for i in range(60):
        db.upsert("docs", {"id": i, "a": i % 5, "b": "xyz"[i % 3]})
    db.delete("docs", {"id": 16})
    db.upsert("docs", {"id": 21, "a": 3, "b": "x"})
    return db


COMPOSITE_TEXT_QUERIES = {
    "eq": lambda m: m.Query("docs").where(
        "ab", "=", [(1, "y"), (3, "x")]).sort("id"),
    "substitution": lambda m: m.Query("docs").where("a", "=", 2).where(
        "b", "=", "z").sort("id"),
    "not_total": lambda m: m.Query("docs").op_not().where(
        "ab", "=", [(0, "x")]).req_total_count().limit(7),
}


@pytest.mark.parametrize("query", sorted(COMPOSITE_TEXT_QUERIES))
def test_composite_text_index_matches_reference(query):
    """A composite `text` definition opens, upserts, deletes and selects in
    the port exactly as in the reference."""
    build = COMPOSITE_TEXT_QUERIES[query]
    got = [summary(_composite_text_db(pkg).select(build(pkg)))
           for pkg in (ref, port)]
    assert got[0] == got[1]
    assert got[0][0], "the query matched nothing"


def test_composite_hnsw_definition_and_plain_unported_types():
    """An `hnsw` definition is a float-vector index whatever field type it
    names (IndexDef makes it so in both packages): without dims both raise
    the same ParamsError; with dims the reference builds its HNSW engine and
    the port raises NotImplementedError naming ROADMAP A7, as for a plain
    hnsw index. A plain `text` index raises naming A9."""
    errors = []
    for pkg in (ref, port):
        with pytest.raises(pkg.ParamsError) as info:
            pkg.IndexDef("ab", "hnsw", "composite", json_paths=("a", "b"))
        errors.append(str(info.value))
    assert errors[0] == errors[1]
    opts = {"vector_opts": port.FloatVectorOpts(dims=4)}
    composite = port.IndexDef("ab", "hnsw", "composite", json_paths=("a", "b"),
                              **opts)
    assert not composite.is_composite
    ref_def = ref.IndexDef("ab", "hnsw", "composite", json_paths=("a", "b"),
                           vector_opts=ref.FloatVectorOpts(dims=4))
    assert not ref_def.is_composite
    pk = port.IndexDef("id", "hash", "int", opts=port.IndexOpts(is_pk=True))
    for idef, item in ((composite, "A7"),
                       (port.IndexDef("v", "hnsw", **opts), "A7"),
                       (port.IndexDef("t", "text", "string"), "A9")):
        with pytest.raises(NotImplementedError, match=f"ROADMAP {item}"):
            port.Reindexer(device="cpu").open_namespace("n", [pk, idef])


def test_native_lanes_are_named_by_what_they_are_built_from(tmp_path):
    """The host C++ lanes build into the ignored build directory under a
    name that hashes their source (and the flags and the machine type), so
    a library built from another source is never loaded."""
    import os

    from reindexer_tpu_torch import csrc
    for name in ("scalar_native", "rtree_native"):
        src = os.path.join(csrc._DIR, f"{name}.cpp")
        path = csrc._so_path(name, src)
        assert os.path.dirname(path) == csrc._BUILD_DIR
        assert os.path.basename(path).startswith(f"{name}-")
        assert path == csrc._so_path(name, src)
        edited = tmp_path / f"{name}.cpp"
        with open(src, "rb") as f:
            edited.write_bytes(f.read() + b"\n")
        assert csrc._so_path(name, str(edited)) != path
    assert "-march=native" not in csrc._command("x.cpp", "x.so")

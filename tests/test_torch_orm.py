"""The dataclass mapping of reindexer_tpu_torch vs reindexer_tpu's, on the
CPU.

Every test of tests/test_orm.py has a counterpart here that runs the same
model in each package: the index definitions derived from its tags are the
same (`IndexDef.to_dict()`), and documents written and read through the
mapping give the same model instances. The port's definitions build the
port's engines (the text index, an HNSW field) on the CPU.
"""
import dataclasses

import numpy as np
import torch
from _torch_pkgs import Pkg, both

torch.set_num_threads(2)


def _item_model(orm):
    @dataclasses.dataclass
    class Item:
        id: int = orm.rx_field("id,hash,pk", 0)
        year: int = orm.rx_field("year,tree", 0)
        name: str = orm.rx_field("name,hash", "")
        tags: list = orm.rx_field("tags,hash", None)
        txt: str = orm.rx_field("txt,text", "")
        extra: str = ""
    return Item


def test_model_indexes():
    def run(pkg):
        orm = pkg.mod("orm")
        defs = {d.name: d for d in orm.model_indexes(_item_model(orm))}
        assert set(defs) == {"id", "year", "name", "tags", "txt"}
        assert defs["id"].opts.is_pk and defs["tags"].opts.is_array
        assert defs["year"].index_type == pkg.IndexType.TREE
        assert defs["txt"].index_type == pkg.IndexType.TEXT
        return {n: d.to_dict() for n, d in defs.items()}
    both(run)


def test_end_to_end_model_crud():
    def run(pkg):
        orm = pkg.mod("orm")
        Item = _item_model(orm)
        db = pkg.db()
        orm.open_namespace_for(db, "m", Item)
        db.upsert("m", orm.to_doc(Item(id=1, year=2020, name="a",
                                       tags=[1, 2], txt="hello world")))
        db.upsert("m", orm.to_doc(Item(id=2, year=2021, name="b", tags=[3],
                                       txt="other text", extra="x")))
        items = orm.decode_results(Item, db.select(
            pkg.Query("m").where("year", ">", 2020)))
        assert len(items) == 1 and items[0].id == 2 and items[0].extra == "x"
        found = orm.decode_results(Item, db.select(
            pkg.Query("m").match("txt", "hello")))
        assert found[0].id == 1
        return [dataclasses.asdict(i) for i in items + found]
    both(run)


def test_vector_model():
    """An HNSW field's tag carries its options; the port's definition
    builds its HNSW index, and a KNN select through the mapping finds the
    same documents as the reference's."""
    def run(pkg):
        orm = pkg.mod("orm")

        @dataclasses.dataclass
        class V:
            id: int = orm.rx_field("id,hash,pk", 0)
            vec: list = orm.rx_field("vec,hnsw", None, dims=8, metric="l2",
                                     m=8)

        defs = {d.name: d for d in orm.model_indexes(V)}
        assert defs["vec"].index_type == pkg.IndexType.HNSW
        assert defs["vec"].vector_opts.dims == 8
        assert defs["vec"].vector_opts.m == 8
        db = pkg.db()
        orm.open_namespace_for(db, "v", V)
        vecs = np.random.default_rng(2).normal(size=(40, 8)).astype(
            np.float32)
        for i in range(40):
            db.upsert("v", orm.to_doc(V(id=i, vec=vecs[i].tolist())))
        got = orm.decode_results(V, db.select(pkg.Query("v").where_knn(
            "vec", vecs[3], pkg.HnswSearchParams(k=3, ef=40))))
        assert got[0].id == 3
        return defs["vec"].to_dict(), [v.id for v in got]
    both(run)

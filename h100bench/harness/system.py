"""The system under test, built from a configuration and a seed through the
port's public API, and the two entries the traffic drives.

Documents are {id, grp, vec}; set-up loads them with `Reindexer.upsert`,
one call a document, as an application fills a namespace. Only this module
and the probes touch the program.
"""
from __future__ import annotations

import time

import numpy as np

from .spec import generator

NAMESPACE = "items"
FIELD = "vec"
# independent random streams drawn from one seed
_ROWS, _GROUPS, _QUERIES, _WARM = range(4)


def streams(seed: int, n: int) -> list:
    seq = np.random.SeedSequence(seed)
    return [np.random.default_rng(s) for s in seq.spawn(n)]


class Data:
    """What the harness makes from the seed and hands to both the program
    and the reference: the rows, the groups, the query pool and the
    warm-up queries (drawn after, so never in the pool)."""

    def __init__(self, config: dict, traffic: dict, seed: int):
        rngs = streams(seed, 4)
        gen = generator(config["generator"]["name"])
        params = config["generator"]["params"]
        n, d = config["rows"], config["dims"]
        self.rows, centers = gen.make(rngs[_ROWS], n, d, params)
        self.groups = rngs[_GROUPS].integers(0, config["n_groups"], size=n)
        self.queries = gen.make_queries(rngs[_QUERIES], traffic["query_pool"],
                                        d, params, centers)
        self.warm = gen.make_queries(rngs[_WARM], traffic["queries_per_call"],
                                     d, params, centers)


def knn_params(config: dict, traffic: dict):
    from reindexer_tpu_torch import HnswSearchParams, KnnSearchParams
    if config["index"]["type"] == "hnsw":
        return HnswSearchParams(k=traffic["k"], ef=traffic["ef"])
    return KnnSearchParams(k=traffic["k"])


def index_def(config: dict):
    from reindexer_tpu_torch import FloatVectorOpts, IndexDef, VectorMetric
    ix = config["index"]
    metric = {"l2": VectorMetric.L2,
              "inner_product": VectorMetric.INNER_PRODUCT}[config["metric"]]
    opts = {"dims": config["dims"], "metric": metric}
    if ix["type"] == "hnsw":
        opts.update(m=ix["m"], ef_construction=ix["ef_construction"])
    return IndexDef(FIELD, ix["type"], vector_opts=FloatVectorOpts(**opts))


class System:
    """A database holding the configuration's rows on `device`."""

    def __init__(self, config: dict, data: Data, device: str, on_open=None):
        from reindexer_tpu_torch import IndexDef, IndexOpts, Reindexer
        self.db = Reindexer(device=device)
        self.db.open_namespace(NAMESPACE, [
            IndexDef("id", "hash", "int", opts=IndexOpts(is_pk=True)),
            index_def(config)])
        self.ns = self.db.get_namespace(NAMESPACE)
        self.index = self.ns.get_index(FIELD)
        if on_open is not None:
            on_open(self)
        t0 = time.perf_counter()
        rows = data.rows.tolist()
        groups = data.groups.tolist()
        for i, (vec, grp) in enumerate(zip(rows, groups)):
            self.db.upsert(NAMESPACE, {"id": i, "grp": grp, FIELD: vec})
        self.load_s = time.perf_counter() - t0
        self.docs = len(rows)

    def call(self, traffic: dict, params):
        """The traffic's entry as a function of a list of query vectors,
        returning one QueryResults per query."""
        if traffic["entry"] == "knn_batch":
            return lambda qs: self.db.knn_batch(NAMESPACE, FIELD, qs, params)
        if traffic["entry"] == "select":
            from reindexer_tpu_torch import Query

            def select(qs):
                return [self.db.select(Query(NAMESPACE).where_knn(
                    FIELD, q, params)) for q in qs]
            return select
        raise ValueError(f"unknown entry {traffic['entry']!r}")

    def perfstats(self) -> dict:
        """This namespace's row of #perfstats."""
        from reindexer_tpu_torch import Query
        for doc in self.db.select(Query("#perfstats")).docs():
            if doc.get("name") == NAMESPACE:
                return doc
        return {}

"""The system under test, built from a configuration and a seed through the
port's public API, and the two entries the traffic drives.

Documents are {id, grp, vec}; set-up loads them with `Reindexer.upsert`,
one call a document, as an application fills a namespace. Only this module
and the probes touch the program.

What a configuration (configs/<name>.json) and a traffic file
(traffic/<mix>.json) give the program, as written:

- the configuration's `metric`: `l2`, `inner_product` or `cosine`
  (`VectorMetric`); its `dims` the index's dims;
- its `index` block: `type` (`vec_bf`, `hnsw`, `ivf`), `precision`
  (`fp32`, the only one) and any `FloatVectorOpts` field: `m`,
  `ef_construction`, `start_size` and `multithreading` (hnsw),
  `centroids_count` (ivf; 0 or absent: the index's own 4 sqrt(n)),
  `radius`, and `quantization`: `false` (none) or the port's JSON form
  {enabled, left_quantile, right_quantile, min_elements, mode};
- the traffic's search keys: `k` (always), `ef` (hnsw), `nprobe` (ivf),
  `radius` (any), into `HnswSearchParams`, `IvfSearchParams` or
  `KnnSearchParams` by the index's type.

Any other key in the `index` block, a precision other than fp32, or a
search key the index's type does not take ends the run with no result,
naming the key and the file: a misspelt option never falls back to a
default unseen. The traffic's other keys are the load's (load.py).
"""
from __future__ import annotations

import dataclasses
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


# the search key each index type takes beyond k and radius
_OWN_SEARCH_KEY = {"hnsw": "ef", "ivf": "nprobe"}
_SEARCH_KEYS = ("k", "ef", "nprobe", "radius")
# FloatVectorOpts fields an `index` block may not set: dims and metric
# are the configuration's own keys, and an embedder is a network service
_NOT_INDEX_KEYS = {"dims", "metric", "embedding"}


def _refuse(path: str, what: str):
    raise SystemExit(f"h100bench/{path}: {what}: no result")


def knn_params(config: dict, traffic: dict):
    """The search parameters of the traffic's search keys, of the class
    that the configuration's index type takes."""
    from reindexer_tpu_torch import (HnswSearchParams, IvfSearchParams,
                                     KnnSearchParams)
    kind = config["index"]["type"]
    given = {key: traffic[key] for key in _SEARCH_KEYS if key in traffic}
    for key in given.keys() & set(_OWN_SEARCH_KEY.values()):
        if key != _OWN_SEARCH_KEY.get(kind):
            _refuse(f"traffic/{traffic['name']}.json", f"search key {key!r}"
                    f" is not taken by configs/{config['name']}.json's "
                    f"{kind!r} index")
    cls = {"hnsw": HnswSearchParams,
           "ivf": IvfSearchParams}.get(kind, KnnSearchParams)
    return cls(**given)


def index_def(config: dict):
    """The vector index's definition: the configuration's dims and metric,
    and every key of its `index` block but `type` and `precision`."""
    from reindexer_tpu_torch import (FloatVectorOpts, IndexDef,
                                     QuantizationConfig, VectorMetric)
    path = f"configs/{config['name']}.json"
    ix = config["index"]
    try:
        metric = VectorMetric(config["metric"])
    except ValueError:
        _refuse(path, f"unknown metric {config['metric']!r}")
    if ix.get("precision") != "fp32":
        _refuse(path, f"index precision {ix.get('precision')!r}: only "
                "'fp32' is served")
    opts = {k: v for k, v in ix.items() if k not in ("type", "precision")}
    fields = {f.name for f in dataclasses.fields(FloatVectorOpts)}
    for key in opts:
        if key not in fields or key in _NOT_INDEX_KEYS:
            _refuse(path, f"unknown index key {key!r}")
    quant = opts.get("quantization", False)
    if quant is False:
        opts["quantization"] = QuantizationConfig()
    elif not isinstance(quant, dict):
        _refuse(path, f"index key 'quantization' is {quant!r}: false or "
                "a dict")
    return IndexDef(FIELD, ix["type"], vector_opts=FloatVectorOpts(
        dims=config["dims"], metric=metric, **opts))


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

"""The comparison that decides `correct`: the answers the timed window
produced, against the plain reference (h100bench/reference.py).

Every number is compared with its limit from the configuration's `check`
(a `..._min` limit is a floor, every other one a ceiling):

- answers_short: answers with another count than k, a repeated id or an
  id that is no row;
- fields_wrong: returned documents whose fields differ from the stored
  document rebuilt from its id (result assembly);
- misordered: answers whose ranks are not in the metric's order;
- rank_err: the widest gap between a returned rank and the exact float64
  rank of the returned row, over the largest exact rank magnitude of the
  query's true top-k;
- gap (exact indexes): the widest margin by which a returned row lies
  beyond the exact k-th rank, on the same scale;
- recall_min (approximate indexes): the mean share of the exact top-k
  that the answers hold.

A client's answer is compared with the reference of the query that client
sent, so an answer delivered to the wrong client fails `gap` or `recall`.
"""
from __future__ import annotations

import numpy as np

from .. import reference


def compare(samples: list, rows: np.ndarray, queries: np.ndarray,
            groups: np.ndarray, metric: str, k: int, limits: dict) -> dict:
    """samples: (query index, ids, ranks, docs) of each checked answer.
    Returns {number: {"value": v, "limit": limit}} in `limits`' order."""
    qidx = sorted({s[0] for s in samples})
    want_ids, want_ranks = reference.exact_topk(rows, queries[qidx], k,
                                                metric)
    where = {q: j for j, q in enumerate(qidx)}
    rows64 = rows.astype(np.float64)
    lower = reference.lower_is_better(metric)
    short = fields = misordered = 0
    rank_err = gap = 0.0
    recall = []
    for q, ids, ranks, docs in samples:
        j = where[q]
        ids = np.asarray(ids, dtype=np.int64)
        ranks = np.asarray(ranks, dtype=np.float64)
        if (len(ids) != k or len(set(ids.tolist())) != len(ids)
                or (len(ids) and (ids.min() < 0 or ids.max() >= len(rows)))):
            short += 1
            continue
        fields += sum(d != reference.document(i, groups)
                      for i, d in zip(ids.tolist(), docs))
        step = np.diff(ranks)
        misordered += bool((step < 0).any() if lower else (step > 0).any())
        exact = reference.ranks64(rows64, queries[q].astype(np.float64),
                                  ids, metric)
        scale = max(np.abs(want_ranks[j]).max(), np.finfo(np.float64).tiny)
        rank_err = max(rank_err, float(np.abs(ranks - exact).max() / scale))
        beyond = (exact - want_ranks[j, -1] if lower
                  else want_ranks[j, -1] - exact)
        gap = max(gap, float(max(beyond.max(), 0.0) / scale))
        recall.append(len(set(ids.tolist()) & set(want_ids[j].tolist())) / k)
    values = {"answers_short": short, "fields_wrong": fields,
              "misordered": misordered, "rank_err": rank_err, "gap": gap,
              "recall_min": float(np.mean(recall)) if recall else 0.0}
    return {name: {"value": values[name], "limit": limit}
            for name, limit in limits.items()}


def passed(numbers: dict) -> bool:
    return all(n["value"] >= n["limit"] if name.endswith("_min")
               else n["value"] <= n["limit"] for name, n in numbers.items())

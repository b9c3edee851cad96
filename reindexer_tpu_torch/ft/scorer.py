"""Device BM25 scoring + ranked merge in PyTorch (port of
reindexer_tpu/ft/scorer.py).

The JAX module is jitted XLA with no Pallas kernel, so every function here
is plain PyTorch on the tensors' own device. The host selects which postings
participate (variant expansion -> gather index list); the device computes,
for every gathered posting, the sub-term rank

    subTermRank = fieldBoost * termProc * bm25_norm * termBoost
                  * termLenBoost * positionRank           (mergerimpl.h:95-124)

with bm25_norm = (1-w) + bm25*boost*w and the piecewise pos2rank curve
(ftconfig.h:126-147), folds the max per (term, doc) and the sum per doc
with must/not masks, and ends in a top-merge_k (ftconfig.h merge_limit).

What the port keeps, and how:

  - Ties. `lax.top_k` ranks equal values by the lower index first and
    `lax.sort` sorts on several keys; torch promises neither, so every
    top-k here is a stable descending sort (`_top_k`) and the (doc, term)
    sort is one int32 key or two stable passes (`sum_ranks_sorted`).
  - The segmented scans (`lax.associative_scan`). The sorted path reads
    the per-(doc, term) max / min and the per-doc sums only at the last
    element of each run, so `_pair_scan` and `_doc_scan` give every element
    its run's total (scatter_reduce / index_add_ over run ids), which is the
    inclusive scan's value at the run's end. `_seg_last_valid` (the
    proximity carry) is exact everywhere: a cummax over the indices of the
    valid positions. A per-doc sum adds at most one value per query term, in
    whatever order the device takes, so scores move by fp32 rounding only.
  - The batched sorted scorer runs every query of the batch in one sort and
    one set of scans over [n_q, G] (the rows are runs of their own), where
    the JAX one vmaps the single-query body.

IDF choices mirror bm25.h: rx = max(0.2, log((N-M+1)/M)/log(1+N)),
classic = log(N/(M+1))+1, word_count = 0 (rank = raw term count).
"""
from __future__ import annotations

import numpy as np
import torch

NEG_INF = float("-inf")
_POS_BIG = 1.0e9


def _top_k(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Top k along the last dim, equal values by the lower index first
    (`lax.top_k`'s order)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _pos2rank(pos: torch.Tensor) -> torch.Tensor:
    """Piecewise position rank (reference: FTFieldConfig::pos2rank,
    ftconfig.h:126-144)."""
    p = pos.to(torch.float32)
    return torch.where(
        p <= 10, 1.0 - p / 100.0,
        torch.where(p <= 100, 0.9 - p / 1000.0,
                    torch.where(p <= 1000, 0.8 - p / 10000.0,
                                torch.where(p <= 10000, 0.7 - p / 100000.0,
                                            torch.where(p <= 100000,
                                                        0.6 - p / 1e6,
                                                        0.5)))))


def _subranks(gather_idx, tb_g, tl_g, g_weight, g_idf,
              post_doc, post_field, post_tf, post_minpos, doc_words,
              field_boost, field_bm25_boost, field_bm25_weight,
              field_pos_boost, field_pos_weight, k1, b, avg_len, bm25_type):
    """Per-gathered-posting (doc, minpos, subTermRank); tb_g / tl_g are the
    term boost and length boost of each posting's term."""
    gi = gather_idx.long()
    doc = post_doc[gi]
    fld = post_field[gi].long()
    tf = post_tf[gi]
    minpos = post_minpos[gi]
    wdoc = torch.clamp(doc_words[doc.long()], min=1.0)
    if bm25_type == "word_count":
        bm25 = tf
    else:
        t_freq = tf / wdoc if bm25_type == "classic" else tf
        bm25 = (g_idf * t_freq * (k1 + 1.0)
                / (t_freq + k1 * (1.0 - b + b * wdoc / avg_len)))
    w_f = field_bm25_weight[fld]
    bm25_norm = (1.0 - w_f) + bm25 * field_bm25_boost[fld] * w_f
    pw = field_pos_weight[fld]
    posrank = (1.0 - pw) + _pos2rank(minpos) * field_pos_boost[fld] * pw
    subrank = (field_boost[fld] * g_weight * bm25_norm * tb_g * tl_g
               * posrank)
    return doc, minpos, subrank


def _scatter_max(n: int, cap: int, rows, doc, vals) -> torch.Tensor:
    """[n, cap] zeros with vals scatter-maxed at (rows, doc)."""
    acc = torch.zeros(n * cap, dtype=torch.float32, device=vals.device)
    acc.scatter_reduce_(0, rows.long() * cap + doc.long(), vals, "amax",
                        include_self=True)
    return acc.view(n, cap)


def _term_minpos(g_term, doc, minpos, g_weight, t_count: int, cap: int):
    """Min token position per (term, doc) — scatter-min companion to the
    rank accumulator. Padding postings (g_weight == 0) are pushed to the
    sentinel so they never win the min."""
    p = torch.where(g_weight > 0.0, minpos.to(torch.float32),
                    torch.full_like(g_weight, _POS_BIG))
    minp = torch.full((t_count * cap,), _POS_BIG, dtype=torch.float32,
                      device=p.device)
    minp.scatter_reduce_(0, g_term.long() * cap + doc.long(), p, "amin",
                         include_self=True)
    return minp.view(t_count, cap)


def _apply_proximity(acc, minp, not_mask, dist_w, dist_b):
    """Term-proximity attenuation (reference: mergerimpl.h:179-181): for each
    term after the first that matches a doc already matched by an earlier
    term, its rank is multiplied by

        normDist = (1 - distanceWeight)
                 + distanceBoost * distanceWeight / max(distance, 1)

    (FTFieldConfig::bound, ftconfig.h:146) where `distance` is the position
    distance to the previous matched term. acc / minp [T, ...], not_mask
    [T] or [T, B]; the scan walks the term axis."""
    present = acc > 0.0
    nm = not_mask.reshape(not_mask.shape
                          + (1,) * (acc.ndim - not_mask.ndim))
    carry = torch.full(acc.shape[1:], _POS_BIG, dtype=torch.float32,
                       device=acc.device)
    out = []
    for t in range(acc.shape[0]):
        has_prev = carry < _POS_BIG
        dist = torch.clamp(torch.abs(minp[t] - carry), min=1.0)
        norm = torch.where(present[t] & has_prev,
                           (1.0 - dist_w) + dist_b * dist_w / dist,
                           torch.ones_like(dist))
        out.append(acc[t] * norm)
        carry = torch.where(present[t] & ~nm[t], minp[t], carry)
    return torch.stack(out)


def _full_match_boost(sum_rank, field_boost, field_words, n_terms, fm_boost,
                      matched_all):
    """Boost docs that matched ALL positive terms (canBeBoostedByFullMatch,
    mergerimpl.h:527-531) AND where a searched field holds exactly as many
    words as the query has terms (reference: Merger::addFullMatchBoost,
    merger.h:101-109; every searched field is checked)."""
    searched = field_boost[: field_words.shape[0]] > 0.0
    fm = matched_all & torch.any(
        searched[:, None] & (field_words == n_terms), dim=0)
    return torch.where(fm, sum_rank * fm_boost, sum_rank)


def _select(sum_rank, ok, merge_k: int):
    sum_rank = torch.where(ok, sum_rank, torch.full_like(sum_rank, NEG_INF))
    top_s, top_i = _top_k(sum_rank, merge_k)
    top_i = torch.where(top_s > NEG_INF, top_i.to(torch.int32),
                        torch.full_like(top_i, -1, dtype=torch.int32))
    return top_s, top_i


def score_and_merge_batch(
    gather_idx, g_term, g_weight, g_idf,
    post_doc, post_field, post_tf, post_minpos, doc_words,
    field_boost, field_bm25_boost, field_bm25_weight,
    field_pos_boost, field_pos_weight,
    term_boost, term_lenboost, must_mask, not_mask,
    k1, b, avg_len, n_q: int, t_count: int, cap: int, merge_k: int,
    bm25_type: str,
    dist_w=0.0, dist_b=1.0, use_proximity: bool = False,
    field_words=None, n_terms=None, fm_boost=1.0,
    use_fullmatch: bool = False,
):
    """Batched-query scoring with a dense [n_q * t_count, cap] scatter-max
    accumulator: query q's terms live at [q*t_count, (q+1)*t_count).
    g_term carries FLATTENED term ids; per-term vectors are [n_q*t_count].
    Returns (scores f32[n_q, merge_k], ids int32[n_q, merge_k])."""
    gt = g_term.long()
    doc, minpos, subrank = _subranks(
        gather_idx, term_boost[gt], term_lenboost[gt], g_weight, g_idf,
        post_doc, post_field, post_tf, post_minpos, doc_words,
        field_boost, field_bm25_boost, field_bm25_weight,
        field_pos_boost, field_pos_weight, k1, b, avg_len, bm25_type)
    acc = _scatter_max(n_q * t_count, cap, gt, doc, subrank)
    acc = acc.reshape(n_q, t_count, cap)
    mm = must_mask.reshape(n_q, t_count)
    nm = not_mask.reshape(n_q, t_count)
    present = acc > 0.0
    if use_proximity:
        minp = _term_minpos(gt, doc, minpos, g_weight, n_q * t_count, cap)
        minp = minp.reshape(n_q, t_count, cap).transpose(0, 1)
        att = _apply_proximity(acc.transpose(0, 1), minp, nm.T,
                               dist_w, dist_b)
        acc = att.transpose(0, 1)
    excluded = torch.any(present & nm[:, :, None], dim=1)
    rank_acc = torch.where(nm[:, :, None], torch.zeros_like(acc), acc)
    sum_rank = torch.sum(rank_acc, dim=1)                 # [n_q, cap]
    if use_fullmatch:
        pos_present = present & ~nm[:, :, None]
        matched_all = (pos_present.to(torch.int32).sum(dim=1)
                       == n_terms[:, None])               # [n_q, cap]
        searched = field_boost[: field_words.shape[0]] > 0.0
        fm = matched_all & torch.any(
            searched[None, :, None]
            & (field_words[None] == n_terms[:, None, None]), dim=1)
        sum_rank = torch.where(fm, sum_rank * fm_boost, sum_rank)
    all_must = torch.all(present | ~mm[:, :, None], dim=1)
    ok = all_must & ~excluded & (sum_rank > 0.0)
    return _select(sum_rank, ok, merge_k)


# ---------------------------------------------------------------------------
# Sorted / segmented-scan formulation (no dense [T, cap] accumulator): one
# sort of the gathered postings by (doc, term), then segment reductions
#   * per-(doc,term) run:  max subrank (variant max), min position
#   * per-doc run:         sum of term maxes, must/not/full-match counts
# Memory is O(G), the top-k runs over G, not cap.
# ---------------------------------------------------------------------------


def _run_ids(starts: torch.Tensor) -> torch.Tensor:
    """Run index of every element (runs begin where starts; starts[0])."""
    return torch.cumsum(starts.to(torch.int64), dim=0) - 1


def _pair_scan(sr, mp, starts):
    """Segmented (max, min): every element gets its run's max of sr and min
    of mp, the inclusive scan's value at the run's last element."""
    rid = _run_ids(starts)
    n = sr.shape[0]
    smax = torch.zeros(n, dtype=sr.dtype, device=sr.device).scatter_reduce_(
        0, rid, sr, "amax", include_self=False)
    pmin = torch.zeros(n, dtype=mp.dtype, device=mp.device).scatter_reduce_(
        0, rid, mp, "amin", include_self=False)
    return smax[rid], pmin[rid]


def _doc_scan(contrib, excl_b, must_c, pos_c, starts):
    """Segmented (sum, or, count, count): every element gets its run's
    totals, the inclusive scan's value at the run's last element."""
    rid = _run_ids(starts)
    n = contrib.shape[0]
    dev = contrib.device
    s = torch.zeros(n, dtype=contrib.dtype, device=dev).index_add_(
        0, rid, contrib)
    counts = torch.zeros((3, n), dtype=torch.int32, device=dev)
    counts.index_add_(1, rid, torch.stack(
        [excl_b.to(torch.int32), must_c.to(torch.int32),
         pos_c.to(torch.int32)]))
    counts = counts[:, rid]
    return s[rid], counts[0] > 0, counts[1], counts[2]


def _seg_last_valid(vals, valid, starts, ident):
    """Segmented 'last valid value so far' inclusive scan: (value, found),
    ident where no valid element precedes in the run."""
    idx = torch.arange(vals.shape[0], device=vals.device)
    zero = torch.zeros_like(idx)
    first = torch.cummax(torch.where(starts, idx, zero), dim=0).values
    last = torch.cummax(torch.where(valid, idx, torch.full_like(idx, -1)),
                        dim=0).values
    found = last >= first
    v = torch.where(found, vals[torch.clamp(last, min=0)],
                    torch.full_like(vals, ident))
    return v, found


def _shift(x: torch.Tensor, fill, step: int) -> torch.Tensor:
    """x moved `step` columns right (+1) or left (-1), `fill` entering."""
    pad = torch.full_like(x[:, :1], fill)
    return (torch.cat([pad, x[:, :-1]], 1) if step > 0
            else torch.cat([x[:, 1:], pad], 1))


def _sum_ranks_rows(
    gather_idx, g_term, g_weight, g_idf,
    post_doc, post_field, post_tf, post_minpos, doc_words,
    field_boost, field_bm25_boost, field_bm25_weight,
    field_pos_boost, field_pos_weight,
    term_boost, term_lenboost, must_mask, not_mask,
    k1, b, avg_len, t_count: int, cap: int, bm25_type: str,
    dist_w, dist_b, use_proximity: bool,
    field_words, n_terms, fm_boost, use_fullmatch: bool,
):
    """The sorted path over [B, G] rows, each its own query: per-query term
    vectors [B, t_count], n_terms [B]. Returns (scores f32[B, G], doc_keys
    i32[B, G]): -inf except at doc-run leaders."""
    B, G = gather_idx.shape
    gt = g_term.long()
    doc, minpos, subrank = _subranks(
        gather_idx, torch.gather(term_boost, 1, gt),
        torch.gather(term_lenboost, 1, gt), g_weight, g_idf,
        post_doc, post_field, post_tf, post_minpos, doc_words,
        field_boost, field_bm25_boost, field_bm25_weight,
        field_pos_boost, field_pos_weight, k1, b, avg_len, bm25_type)

    padm = g_weight <= 0.0
    dockey = torch.where(padm, cap, doc).to(torch.int32)
    termk = torch.where(padm, t_count, g_term).to(torch.int32)
    mp = torch.where(padm, _POS_BIG, minpos.to(torch.float32))
    sr = torch.where(padm, torch.zeros_like(subrank), subrank)

    # (doc, term) as ONE int32 sort key when it fits (t_count is pow2;
    # termk <= t_count needs one extra bit), else two stable passes
    t2 = 2 * t_count
    shift = t2.bit_length() - 1
    if (cap + 1) << shift < (1 << 31):
        key, order = torch.sort((dockey << shift) | termk, dim=1,
                                stable=True)
        dockey = key >> shift
        termk = key & (t2 - 1)
    else:
        termk, o1 = torch.sort(termk, dim=1, stable=True)
        dockey, o2 = torch.sort(torch.gather(dockey, 1, o1), dim=1,
                                stable=True)
        termk = torch.gather(termk, 1, o2)
        order = torch.gather(o1, 1, o2)
    sr = torch.gather(sr, 1, order)
    mp = torch.gather(mp, 1, order)
    real = dockey < cap

    prev_doc, prev_term = _shift(dockey, -1, 1), _shift(termk, -1, 1)
    nxt_doc, nxt_term = _shift(dockey, -2, -1), _shift(termk, -2, -1)
    pair_start = ((dockey != prev_doc) | (termk != prev_term)).reshape(-1)
    pair_end = ((dockey != nxt_doc) | (termk != nxt_term)).reshape(-1)
    doc_start = (dockey != prev_doc).reshape(-1)
    doc_end = (dockey != nxt_doc).reshape(-1)

    smax, pmin = _pair_scan(sr.reshape(-1), mp.reshape(-1), pair_start)
    real = real.reshape(-1)
    present = pair_end & real & (smax > 0.0)

    # per-element term masks (index t_count = padding -> False)
    ext = torch.zeros((B, 1), dtype=torch.bool, device=sr.device)
    tk = torch.clamp(termk, max=t_count).long()
    t_not = torch.gather(torch.cat([not_mask, ext], 1), 1, tk).reshape(-1)
    t_must = torch.gather(torch.cat([must_mask, ext], 1), 1, tk).reshape(-1)

    att = smax
    if use_proximity:
        # carry = min-position of the previous positive present term in this
        # doc (terms appear in ascending order inside a doc run)
        upd = present & ~t_not
        lastv, lasth = _seg_last_valid(pmin, upd, doc_start, _POS_BIG)
        carry = torch.cat([lastv.new_full((1,), _POS_BIG), lastv[:-1]])
        hasp = torch.cat([lasth.new_zeros(1), lasth[:-1]])
        carry = torch.where(doc_start, _POS_BIG, carry)
        hasp = hasp & ~doc_start
        dist = torch.clamp(torch.abs(pmin - carry), min=1.0)
        norm = torch.where(present & hasp,
                           (1.0 - dist_w) + dist_b * dist_w / dist,
                           torch.ones_like(dist))
        att = smax * norm

    pos = present & ~t_not
    contrib = torch.where(pos, att, torch.zeros_like(att))
    docsum, excl, must_cnt, pos_cnt = _doc_scan(
        contrib, present & t_not, present & t_must, pos, doc_start)

    if use_fullmatch:
        nt = n_terms.to(torch.int32)[:, None].expand(B, G).reshape(-1)
        dkc = torch.clamp(dockey.reshape(-1), max=cap - 1).long()
        fm_doc = torch.zeros_like(pos)
        for f in range(field_words.shape[0]):
            fm_doc |= (field_words[f][dkc] == nt) & (field_boost[f] > 0.0)
        fm = fm_doc & (pos_cnt == nt)
        docsum = torch.where(fm, docsum * fm_boost, docsum)
    n_must = must_mask.to(torch.int32).sum(dim=1)
    ok = (doc_end & real & ~excl & (docsum > 0.0)
          & (must_cnt.view(B, G) == n_must[:, None]).reshape(-1))
    scores = torch.where(ok, docsum, torch.full_like(docsum, NEG_INF))
    return scores.view(B, G), dockey


def _topk_sorted(scores, dockey, merge_k: int):
    """Top merge_k of [B, G] doc-leader scores -> (f32[B, merge_k],
    i32[B, merge_k]), padded with -inf / -1."""
    kk = min(merge_k, scores.shape[1])
    top_s, idx = _top_k(scores, kk)
    top_i = torch.gather(dockey, 1, idx)
    top_i = torch.where(top_s > NEG_INF, top_i, torch.full_like(top_i, -1))
    if kk < merge_k:
        top_s = torch.nn.functional.pad(top_s, (0, merge_k - kk),
                                        value=NEG_INF)
        top_i = torch.nn.functional.pad(top_i, (0, merge_k - kk), value=-1)
    return top_s, top_i


def sum_ranks_sorted(
    gather_idx, g_term, g_weight, g_idf,
    post_doc, post_field, post_tf, post_minpos, doc_words,
    field_boost, field_bm25_boost, field_bm25_weight,
    field_pos_boost, field_pos_weight,
    term_boost, term_lenboost, must_mask, not_mask,
    k1, b, avg_len, t_count: int, cap: int, bm25_type: str,
    dist_w=0.0, dist_b=1.0, use_proximity: bool = False,
    field_words=None, n_terms=0, fm_boost=1.0, use_fullmatch: bool = False,
):
    """Core of the sorted path for one query. Returns (scores f32[G],
    doc_keys i32[G]) where scores are -inf except at doc-run leaders."""
    nt = torch.as_tensor([n_terms], dtype=torch.int32,
                         device=gather_idx.device)
    scores, dockey = _sum_ranks_rows(
        gather_idx[None], g_term[None], g_weight[None], g_idf[None],
        post_doc, post_field, post_tf, post_minpos, doc_words,
        field_boost, field_bm25_boost, field_bm25_weight,
        field_pos_boost, field_pos_weight,
        term_boost[None], term_lenboost[None], must_mask[None],
        not_mask[None], k1, b, avg_len, t_count, cap, bm25_type,
        dist_w, dist_b, use_proximity, field_words, nt, fm_boost,
        use_fullmatch)
    return scores[0], dockey[0]


def score_and_merge_sorted(
    gather_idx, g_term, g_weight, g_idf,
    post_doc, post_field, post_tf, post_minpos, doc_words,
    field_boost, field_bm25_boost, field_bm25_weight,
    field_pos_boost, field_pos_weight,
    term_boost, term_lenboost, must_mask, not_mask,
    k1, b, avg_len, t_count: int, cap: int, merge_k: int, bm25_type: str,
    dist_w=0.0, dist_b=1.0, use_proximity: bool = False,
    field_words=None, n_terms=0, fm_boost=1.0, use_fullmatch: bool = False,
):
    """Drop-in replacement for score_and_merge built on the sorted path."""
    scores, dockey = sum_ranks_sorted(
        gather_idx, g_term, g_weight, g_idf,
        post_doc, post_field, post_tf, post_minpos, doc_words,
        field_boost, field_bm25_boost, field_bm25_weight,
        field_pos_boost, field_pos_weight,
        term_boost, term_lenboost, must_mask, not_mask,
        k1, b, avg_len, t_count, cap, bm25_type,
        dist_w, dist_b, use_proximity,
        field_words, n_terms, fm_boost, use_fullmatch)
    top_s, top_i = _topk_sorted(scores[None], dockey[None], merge_k)
    return top_s[0], top_i[0]


def score_and_merge_batch_sorted(
    gather_idx, g_term, g_weight, g_idf,      # [n_q, G] per-query arrays
    post_doc, post_field, post_tf, post_minpos, doc_words,
    field_boost, field_bm25_boost, field_bm25_weight,
    field_pos_boost, field_pos_weight,
    term_boost, term_lenboost, must_mask, not_mask,   # [n_q, t_count]
    k1, b, avg_len, t_count: int, cap: int, merge_k: int, bm25_type: str,
    dist_w=0.0, dist_b=1.0, use_proximity: bool = False,
    field_words=None, n_terms=None, fm_boost=1.0,     # n_terms: i32[n_q]
    use_fullmatch: bool = False,
):
    """Batched serving path: the sorted pipeline over every query of the
    batch at once (each row its own runs). Memory is O(n_q * G)."""
    if n_terms is None:
        n_terms = torch.zeros(gather_idx.shape[0], dtype=torch.int32,
                              device=gather_idx.device)
    scores, dockey = _sum_ranks_rows(
        gather_idx, g_term, g_weight, g_idf,
        post_doc, post_field, post_tf, post_minpos, doc_words,
        field_boost, field_bm25_boost, field_bm25_weight,
        field_pos_boost, field_pos_weight,
        term_boost, term_lenboost, must_mask, not_mask,
        k1, b, avg_len, t_count, cap, bm25_type,
        dist_w, dist_b, use_proximity, field_words, n_terms, fm_boost,
        use_fullmatch)
    return _topk_sorted(scores, dockey, merge_k)


def idf_host(total_docs: int, matched_docs: np.ndarray, bm25_type: str,
             ) -> np.ndarray:
    """Per-word IDF on host (reference: bm25.h IDF formulas)."""
    n = float(max(total_docs, 1))
    m = np.maximum(matched_docs.astype(np.float64), 1.0)
    if bm25_type == "classic":
        return (np.log(n / (m + 1.0)) + 1.0).astype(np.float32)
    if bm25_type == "word_count":
        return np.zeros_like(m, dtype=np.float32)
    f = np.log((n - m + 1.0) / m) / np.log(1.0 + n)
    return np.maximum(f, 0.2).astype(np.float32)


def sum_ranks(
    gather_idx, g_term, g_weight, g_idf,
    post_doc, post_field, post_tf, post_minpos, doc_words,
    field_boost, field_bm25_boost, field_bm25_weight,
    field_pos_boost, field_pos_weight,
    term_boost, term_lenboost, must_mask, not_mask,
    k1, b, avg_len, t_count: int, cap: int, bm25_type: str,
    dist_w=0.0, dist_b=1.0, use_proximity: bool = False,
    field_words=None, n_terms=0, fm_boost=1.0, use_fullmatch: bool = False,
):
    """Per-doc summed rank + validity mask over a dense [t_count, cap]
    accumulator (docRank = sum_t max subTermRank with must/not folding)."""
    gt = g_term.long()
    doc, minpos, subrank = _subranks(
        gather_idx, term_boost[gt], term_lenboost[gt], g_weight, g_idf,
        post_doc, post_field, post_tf, post_minpos, doc_words,
        field_boost, field_bm25_boost, field_bm25_weight,
        field_pos_boost, field_pos_weight, k1, b, avg_len, bm25_type)
    acc = _scatter_max(t_count, cap, gt, doc, subrank)
    return _fold_terms(acc, gt, doc, minpos, g_weight, field_boost,
                       must_mask, not_mask, t_count, cap, dist_w, dist_b,
                       use_proximity, field_words, n_terms, fm_boost,
                       use_fullmatch)


def _fold_terms(acc, gt, doc, minpos, g_weight, field_boost, must_mask,
                not_mask, t_count, cap, dist_w, dist_b, use_proximity,
                field_words, n_terms, fm_boost, use_fullmatch):
    """[t_count, cap] per-term ranks -> (sum_rank [cap], ok [cap])."""
    present = acc > 0.0
    if use_proximity:
        minp = _term_minpos(gt, doc, minpos, g_weight, t_count, cap)
        acc = _apply_proximity(acc, minp, not_mask, dist_w, dist_b)
    excluded = torch.any(present & not_mask[:, None], dim=0)
    rank_acc = torch.where(not_mask[:, None], torch.zeros_like(acc), acc)
    sum_rank = torch.sum(rank_acc, dim=0)
    if use_fullmatch:
        pos_present = present & ~not_mask[:, None]
        matched_all = pos_present.to(torch.int32).sum(dim=0) == n_terms
        sum_rank = _full_match_boost(sum_rank, field_boost, field_words,
                                     n_terms, fm_boost, matched_all)
    all_must = torch.all(present | ~must_mask[:, None], dim=0)
    ok = all_must & ~excluded & (sum_rank > 0.0)
    return sum_rank, ok


def sum_ranks_fielded(
    gather_idx, g_term, g_weight, g_idf,
    post_doc, post_field, post_tf, post_minpos, doc_words,
    field_boost, field_bm25_boost, field_bm25_weight,
    field_pos_boost, field_pos_weight,
    term_boost, term_lenboost, must_mask, not_mask,
    sum_fields_mask,            # bool[F] '+'-marked fields
    ratio: float,
    k1, b, avg_len, t_count: int, f_count: int, cap: int, bm25_type: str,
    dist_w=0.0, dist_b=1.0, use_proximity: bool = False,
    field_words=None, n_terms=0, fm_boost=1.0, use_fullmatch: bool = False,
):
    """Field-rank summation variant (reference: SumRanksByFieldsRatio,
    fulltext.md:118-128): per (term, doc) the field ranks sort descending and
    combine as Rmax + K*R1 + K^2*R2 + ... where only '+'-marked fields (plus
    the maximum) participate, over an extra [T, F, cap] accumulator."""
    gt = g_term.long()
    doc, minpos, subrank = _subranks(
        gather_idx, term_boost[gt], term_lenboost[gt], g_weight, g_idf,
        post_doc, post_field, post_tf, post_minpos, doc_words,
        field_boost, field_bm25_boost, field_bm25_weight,
        field_pos_boost, field_pos_weight, k1, b, avg_len, bm25_type)
    fld = post_field[gather_idx.long()].long()
    acc3 = _scatter_max(t_count * f_count, cap, gt * f_count + fld, doc,
                        subrank).view(t_count, f_count, cap)

    # per (term, doc): sort field ranks desc, geometric-sum participants
    v = acc3.permute(0, 2, 1)                        # [T, cap, F]
    v_sorted, order = torch.sort(v, dim=2, descending=True, stable=True)
    part = sum_fields_mask[order]
    first = torch.zeros_like(part)
    first[..., 0] = True
    include = (first | part) & (v_sorted > 0.0)
    j = torch.cumsum(include.to(torch.int32), dim=2) - 1
    w = torch.where(include,
                    ratio ** torch.clamp(j, min=0).to(torch.float32),
                    torch.zeros_like(v_sorted))
    # the max (position 0) always has weight 1
    w = torch.where(first & include, torch.ones_like(w), w)
    acc = torch.sum(v_sorted * w, dim=2)             # [T, cap]
    return _fold_terms(acc, gt, doc, minpos, g_weight, field_boost,
                       must_mask, not_mask, t_count, cap, dist_w, dist_b,
                       use_proximity, field_words, n_terms, fm_boost,
                       use_fullmatch)


def score_and_merge_fielded(
    gather_idx, g_term, g_weight, g_idf,
    post_doc, post_field, post_tf, post_minpos, doc_words,
    field_boost, field_bm25_boost, field_bm25_weight,
    field_pos_boost, field_pos_weight,
    term_boost, term_lenboost, must_mask, not_mask, sum_fields_mask,
    k1, b, avg_len, t_count: int, f_count: int, cap: int, merge_k: int,
    bm25_type: str, ratio: float,
    dist_w=0.0, dist_b=1.0, use_proximity: bool = False,
    field_words=None, n_terms=0, fm_boost=1.0, use_fullmatch: bool = False,
):
    sum_rank, ok = sum_ranks_fielded(
        gather_idx, g_term, g_weight, g_idf,
        post_doc, post_field, post_tf, post_minpos, doc_words,
        field_boost, field_bm25_boost, field_bm25_weight,
        field_pos_boost, field_pos_weight,
        term_boost, term_lenboost, must_mask, not_mask,
        sum_fields_mask, ratio,
        k1, b, avg_len, t_count, f_count, cap, bm25_type,
        dist_w, dist_b, use_proximity,
        field_words, n_terms, fm_boost, use_fullmatch)
    return _select(sum_rank, ok, merge_k)


def score_and_merge(
    gather_idx, g_term, g_weight, g_idf,
    post_doc, post_field, post_tf, post_minpos, doc_words,
    field_boost, field_bm25_boost, field_bm25_weight,
    field_pos_boost, field_pos_weight,
    term_boost, term_lenboost, must_mask, not_mask,
    k1: float, b: float, avg_len: float,
    t_count: int, cap: int, merge_k: int, bm25_type: str,
    dist_w=0.0, dist_b=1.0, use_proximity: bool = False,
    field_words=None, n_terms=0, fm_boost=1.0, use_fullmatch: bool = False,
):
    """Returns (scores f32[merge_k], doc_ids int32[merge_k]); empty slots
    have score -inf / id -1. Scores are un-normalized docRank sums — the
    caller applies the *255/allmax normalization (mergerimpl.h:107)."""
    sum_rank, ok = sum_ranks(
        gather_idx, g_term, g_weight, g_idf,
        post_doc, post_field, post_tf, post_minpos, doc_words,
        field_boost, field_bm25_boost, field_bm25_weight,
        field_pos_boost, field_pos_weight,
        term_boost, term_lenboost, must_mask, not_mask,
        k1, b, avg_len, t_count, cap, bm25_type,
        dist_w, dist_b, use_proximity,
        field_words, n_terms, fm_boost, use_fullmatch)
    return _select(sum_rank, ok, merge_k)


def drain(*tensors: torch.Tensor) -> list[np.ndarray]:
    """Device tensors (float32, int32 or bool) as numpy arrays, through one
    device-to-host copy."""
    flat = [t.reshape(-1).view(torch.int32) if t.dtype != torch.bool
            else t.reshape(-1).to(torch.int32) for t in tensors]
    host = torch.cat(flat).cpu().numpy()
    out, off = [], 0
    for t, f in zip(tensors, flat):
        a = host[off: off + f.numel()]
        off += f.numel()
        if t.dtype == torch.float32:
            a = a.view(np.float32)
        elif t.dtype == torch.bool:
            a = a.astype(bool)
        out.append(a.reshape(tuple(t.shape)))
    return out

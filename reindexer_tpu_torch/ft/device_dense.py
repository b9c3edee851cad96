"""Device-resident dense BM25 for frequent (zipf-head) words in PyTorch
(port of reindexer_tpu/ft/device_dense.py).

Build once per holder revision: for the top-G most frequent vocabulary
words, fold the query-independent per-posting rank PR = A + idf*B
(selector._ab_arrays, the same factorization the host C++ dense merge
consumes) into device-resident dense matrices

    S[g, d] = max over postings of word g in doc d of PR        (0 absent)
    M[g, d] = min over postings of word g in doc d of minpos    (BIG absent)

Max/min commute with the per-run constant rboost, so a query's per-term
subrank fold is exact: smax[t, d] = max_v rboost_v * S[slot_v, d].

A query gathers its [B, T, V] slot rows chunk by chunk over cap, runs the
reference combine (proximity carry, must/not, full-match boost, identical
to csrc/ft_native.cpp score_merge_dense) and selects the top merge_k on the
device: a per-segment top-M prune, then one (score desc, doc asc) sort of
the pruned candidates. A per-query overflow flag (a segment whose M-th value
still clears the global cut) sends that query back to the host merge,
keeping the exact contract.

The port returns (scores, docs) and normalizes on the host, as every other
route does, so its answer does not depend on the route: the reference's
packed download (ranks rounded to a byte, doc in 24 bits) is a saving for a
TPU reached through a slow tunnel and is not copied (ROADMAP C). The mesh
(doc-sharded) scorer is not ported (ROADMAP A12).

Eligibility is decided by the selector: every variant word of every term
must be resident, default field parameters only (PR folds the field
boosts), and the gather must be large enough that the device beats the
host merge (DEVICE_MIN, DEVICE_MIN_SINGLE; fitted on an H100, see
tests/test_torch_ft.py ROUTE_TABLES).
"""
from __future__ import annotations

import sys
from typing import Optional

import numpy as np
import torch

from .scorer import _top_k, drain

_POS_BIG = 1.0e9
_SEG = 1024          # selection segment width (docs)
_M_PER_SEG = 64      # candidates kept per segment
_MAX_T = 8
_MAX_V = 8

DENSE_WORDS = 64     # resident head words
# a word must carry this many postings to earn residency
DENSE_MIN_COUNT = 256
# least gathered postings for the dense route in a batch (process_batch)
# and for a single query (process_query): the fit of two runs' H100 route
# tables (tests/test_torch_ft.py ROUTE_TABLES); the reference's are 2^19
# and 2^21
DEVICE_MIN = 1 << 16
DEVICE_MIN_SINGLE = 1 << 16


def _pow2(n: int, floor: int) -> int:
    c = floor
    while c < n:
        c *= 2
    return c


def _score_core(S, M, FW, searched, idx, w, notm, must, n_must, n_pos,
                scalars, T: int, V: int, merge_k: int, use_prox: bool,
                use_fm: bool, chunks: int, seg: int, m_per_seg: int):
    """S/M: [G+1, cap] resident folds; FW: [F, cap] field word counts;
    idx [B,T,V] slots (G = padding), w [B,T,V] f32 rboost (0 = pad),
    notm/must [B,T] bool, n_must/n_pos [B] i32,
    scalars = [c1, c2, fm_boost, min_rank] f32.
    Returns (top scores [B, merge_k] f32, top docs [B, merge_k] i32
    (-1 = none), overflow [B] bool), sorted by (score desc, doc asc)."""
    B = idx.shape[0]
    cap = S.shape[1]
    C = cap // chunks
    c1, c2, fm_boost = scalars[0], scalars[1], scalars[2]
    idx = idx.long()
    scores = torch.empty((B, cap), dtype=torch.float32, device=S.device)
    for ci in range(chunks):
        off = ci * C
        rows = S[:, off: off + C][idx]                  # [B,T,V,C]
        at = torch.amax(w[..., None] * rows, dim=2)     # [B,T,C]
        del rows
        if use_prox:
            mt = torch.amin(M[:, off: off + C][idx], dim=2)   # [B,T,C]
            carry = torch.zeros((B, C), dtype=torch.float32, device=S.device)
            hasp = torch.zeros((B, C), dtype=torch.bool, device=S.device)
        docsum = torch.zeros((B, C), dtype=torch.float32, device=S.device)
        excl = torch.zeros((B, C), dtype=torch.bool, device=S.device)
        must_cnt = torch.zeros((B, C), dtype=torch.int32, device=S.device)
        pos_cnt = torch.zeros((B, C), dtype=torch.int32, device=S.device)
        for t in range(T):
            s = at[:, t]
            present = s > 0.0
            if use_prox:
                m = mt[:, t]
                dist = torch.clamp(torch.abs(m - carry), min=1.0)
                att = torch.where(hasp, s * (c1 + c2 / dist), s)
            else:
                att = s
            nm = notm[:, t][:, None]
            mu = must[:, t][:, None]
            add = present & ~nm
            docsum = docsum + torch.where(add, att, torch.zeros_like(att))
            pos_cnt = pos_cnt + add.to(torch.int32)
            excl = excl | (present & nm)
            must_cnt = must_cnt + (present & mu).to(torch.int32)
            if use_prox:
                carry = torch.where(add, m, carry)
                hasp = hasp | add
        ok = (~excl) & (must_cnt == n_must[:, None]) & (docsum > 0.0)
        score = torch.where(ok, docsum, torch.zeros_like(docsum))
        if use_fm:
            FWb = FW[:, off: off + C]
            # [B, F, C]: the searched mask runs over the field axis (the
            # reference's `searched[:, None, None]` fails for F > 1, ROADMAP C)
            fm_doc = torch.any(searched[None, :, None]
                               & (FWb[None] == n_pos[:, None, None]),
                               dim=1)                       # [B, C]
            fm = fm_doc & (pos_cnt == n_pos[:, None])
            score = torch.where(fm, score * fm_boost, score)
        scores[:, off: off + C] = score

    # --- top-merge_k selection: per-segment prune + one key sort
    nseg = cap // seg
    if m_per_seg == seg:
        # lossless: no pruning, sort everything (small corpora or merge_k
        # close to cap)
        cand_v = scores
        cand_d = torch.arange(cap, dtype=torch.int32,
                              device=S.device).expand(B, cap)
        top_v = None
    else:
        top_v, top_i = _top_k(scores.view(B, nseg, seg), m_per_seg)
        cand_v = top_v.reshape(B, nseg * m_per_seg)
        cand_d = (torch.arange(nseg, dtype=torch.int32,
                               device=S.device)[None, :, None] * seg
                  + top_i.to(torch.int32)).reshape(B, nseg * m_per_seg)
    # sort by (score desc, doc asc): scores are >= 0, so the f32 bit
    # pattern as i32 is order-isomorphic; negated above the doc, one int64
    # key orders both (docs are distinct, so no tie is left)
    key = (-cand_v.view(torch.int32).to(torch.int64)) * (1 << 32) \
        + cand_d.to(torch.int64)
    kk = min(merge_k, cand_v.shape[1])
    order = torch.sort(key, dim=1).indices[:, :kk]
    sel_v = torch.gather(cand_v, 1, order)
    sel_d = torch.gather(cand_d, 1, order)
    if kk < merge_k:
        sel_v = torch.nn.functional.pad(sel_v, (0, merge_k - kk))
        sel_d = torch.nn.functional.pad(sel_d, (0, merge_k - kk))
    if top_v is None:
        ovf = torch.zeros((B,), dtype=torch.bool, device=S.device)
    else:
        # the cut value: 0 when fewer candidates exist than merge_k (then
        # EVERY positive doc must be returned and a full segment implies
        # possible loss); overflow: a segment's M-th survivor is positive
        # and would still make the global cut, so that segment may hide
        # more than M qualifying docs
        kth = sel_v[:, merge_k - 1]
        segm = top_v[:, :, m_per_seg - 1]
        ovf = torch.any((segm > 0.0) & (segm >= kth[:, None]), dim=1)
    sel_d = torch.where(sel_v > 0.0, sel_d, torch.full_like(sel_d, -1))
    return sel_v, sel_d, ovf


def _build_mesh_score_fn(*args, **kwargs):
    raise NotImplementedError(
        "the doc-sharded dense full-text scorer is not yet ported to "
        "reindexer_tpu_torch, see ROADMAP A12 (multi-device)")


class FtDeviceDense:
    """Per-holder device-resident dense score/minpos matrices for the
    frequent-word head, plus the batched query entry point."""

    def __init__(self, holder, cfg, selector):
        self.holder = holder
        self.cfg = cfg
        self.selector = selector
        self.wid2slot: dict[int, int] = {}
        self.S = None            # [G+1, cap] f32 device
        self.M = None            # [G+1, cap] f32 device (BIG absent)
        self.cap = 0
        self._built_key = None

    # ------------------------------------------------------------------
    def ensure_built(self) -> bool:
        """(Re)build the resident matrices for the current holder revision
        and default field parameters. Returns False when the corpus has no
        head words worth residency."""
        from .dataholder import _pad_pow2 as _cap_pow2
        from .dsl import FtDslQuery

        h = self.holder
        if h.total_docs == 0 or not len(h.words):
            return False
        fb, bb, bw, pb, pw = self.selector._field_params(FtDslQuery())
        self.selector._ab_arrays(fb, bb, bw, pb, pw)
        key = h._ab_cache[0]
        if self._built_key == key:
            return self.S is not None
        self._built_key = key
        PR = h._ab_cache[3]

        counts = np.diff(h.word_start)
        # residency threshold: a word must carry enough postings that the
        # device sweep beats streaming them on host
        mod = sys.modules[__name__]
        min_count = max(mod.DENSE_MIN_COUNT, h.total_docs // 256)
        order = np.argsort(-counts, kind="stable")
        head = [int(wid) for wid in order[: mod.DENSE_WORDS]
                if counts[wid] >= min_count]
        if not head:
            self.S = self.M = None
            return False

        cap = _cap_pow2(max(len(h.doc_words), 1))
        G = len(head)
        S = np.zeros((G + 1, cap), np.float32)
        M = np.full((G + 1, cap), _POS_BIG, np.float32)
        minpos = h.post_minpos
        for g, wid in enumerate(head):
            s, e = int(h.word_start[wid]), int(h.word_start[wid + 1])
            docs = h.post_doc[s:e]
            starts = np.flatnonzero(np.diff(docs) != 0) + 1
            starts = np.concatenate([[0], starts])
            lead = docs[starts]
            S[g, lead] = np.maximum.reduceat(PR[s:e], starts)
            M[g, lead] = np.minimum.reduceat(
                minpos[s:e].astype(np.float32), starts)
        self.wid2slot = {wid: g for g, wid in enumerate(head)}
        self.cap = cap
        self.S = torch.from_numpy(S).to(h.device)
        self.M = torch.from_numpy(M).to(h.device)
        self._searched = torch.from_numpy(
            fb[: h.field_words.shape[0]] > 0.0).to(h.device)
        return True

    # ------------------------------------------------------------------
    def pack_query(self, prep: dict) -> Optional[dict]:
        """Map a prepared query's posting runs onto resident slots.
        Returns None when any variant word is not resident (host path)."""
        h = self.holder
        if self.S is None:
            return None
        T = len(prep["must"])
        if T > _MAX_T:
            return None
        wids = np.searchsorted(h.word_start, prep["run_start"],
                               side="right") - 1
        slots = np.empty(len(wids), np.int32)
        for i, wid in enumerate(wids):
            g = self.wid2slot.get(int(wid))
            if g is None:
                return None
            slots[i] = g
        per_term: list[list[tuple[int, float]]] = [[] for _ in range(T)]
        tb, tl = prep["term_boost"], prep["term_lenb"]
        for i, t in enumerate(prep["run_term"]):
            rb = float(prep["run_w"][i] * tb[t] * tl[t])
            per_term[int(t)].append((int(slots[i]), rb))
        V = max((len(v) for v in per_term), default=0)
        if V > _MAX_V or V == 0:
            return None
        return {"per_term": per_term, "T": T, "V": V,
                "must": prep["must"], "notm": prep["notm"],
                "n_must": int(prep["must"].sum()),
                "n_pos": int((~prep["notm"]).sum())}

    # ------------------------------------------------------------------
    def dispatch_batch(self, packs: list[dict], merge_k: int,
                       use_prox: bool, use_fm: bool):
        """Run a batch of packed queries on the device. Returns DEVICE
        tensors (scores [B, merge_k] f32, docs [B, merge_k] i32, ovf [B]
        bool): drain them with scorer.drain; callers re-route ovf rows to
        the host merge."""
        h, cfg = self.holder, self.cfg
        B = _pow2(len(packs), 1)
        T = _pow2(max(p["T"] for p in packs), 2)
        V = _pow2(max(p["V"] for p in packs), 1)
        G = self.S.shape[0] - 1
        idx = np.full((B, T, V), G, np.int32)
        w = np.zeros((B, T, V), np.float32)
        notm = np.zeros((B, T), np.bool_)
        must = np.zeros((B, T), np.bool_)
        n_must = np.zeros(B, np.int32)
        n_pos = np.full(B, -1, np.int32)
        for b, p in enumerate(packs):
            for t, lst in enumerate(p["per_term"]):
                for v, (slot, rb) in enumerate(lst):
                    idx[b, t, v] = slot
                    w[b, t, v] = rb
            notm[b, : p["T"]] = p["notm"]
            must[b, : p["T"]] = p["must"]
            n_must[b] = p["n_must"]
            n_pos[b] = p["n_pos"] if p["n_pos"] > 0 else -1
        scalars = np.asarray(
            [1.0 - cfg.distance_weight,
             cfg.distance_boost * cfg.distance_weight,
             cfg.full_match_boost, cfg.min_rank], np.float32)
        dev = h.device_arrays()
        cap = self.cap
        seg = min(_SEG, cap)
        mk = min(merge_k, cap)
        # per-segment prune depth: ~3x the expected per-segment survivor
        # count so random fluctuation rarely trips the overflow fallback;
        # m == seg disables pruning entirely (lossless sort)
        m_per_seg = min(seg, max(_M_PER_SEG, (3 * mk * seg + cap - 1) // cap))
        # bound the gathered chunk intermediate [B,T,V,C] to ~64MB
        rows = B * T * V
        chunks = 1
        while (cap // chunks) > seg and rows * (cap // chunks) * 4 > (1 << 26):
            chunks *= 2

        def up(a):
            return torch.from_numpy(a).to(h.device)

        return _score_core(
            self.S, self.M, dev["field_words"], self._searched, up(idx),
            up(w), up(notm), up(must), up(n_must), up(n_pos), up(scalars),
            T=T, V=V, merge_k=mk, use_prox=use_prox, use_fm=use_fm,
            chunks=chunks, seg=seg, m_per_seg=m_per_seg)

    def _dispatch_mesh(self, *args, **kwargs):
        return _build_mesh_score_fn()

    def score_batch(self, packs: list[dict], merge_k: int, use_prox: bool,
                    use_fm: bool):
        """Synchronous wrapper over dispatch_batch (host numpy results)."""
        return tuple(drain(*self.dispatch_batch(packs, merge_k, use_prox,
                                                use_fm)))

"""FT query pipeline (port of reindexer_tpu/ft/selector.py): variant
expansion (host) -> scoring on one of five routes -> merge.

The host half (`_prepare`, `_expand`, typos, phrases, the host C++ merge,
`warm_frequent_singles`) is the reference's. The device routes run the
port's PyTorch scorers on the holder's device, and each result comes back
in one device-to-host copy (`scorer.drain`). The routes, all with the
reference's contract (exact top-merge_k by (score desc, doc asc)):

  - host: the C++ merge (`_score_host`, G <= HOST_SCORE_MAX, and the
    single-term queries of its per-word cache, G >= SINGLE_CACHE_MIN);
  - sorted: the device sorted path (scorer.score_and_merge_sorted, and its
    batched form in process_batch);
  - dense: device-resident head words (device_dense.py), single
    (G >= DEVICE_MIN_SINGLE) and batched (G >= DEVICE_MIN);
  - fielded: the sum-ranks-by-fields scorer;
  - overflow: a dense query whose prune cannot certify its cut goes to the
    host merge (or, above HOST_SCORE_MAX, the sorted path).

Each route counts its queries (`host_merges`, `sorted_scores`,
`dense_scores`, `fielded_scores`, `dense_overflows`), and `native_fallbacks`
counts the queries the host merge would answer that go to the sorted path
because its C++ lane is not built. The crossovers are module and class
constants (no environment knobs), fitted on an H100 (tests/test_torch_ft.py
ROUTE_TABLES).

Mesh-resident mode (a selector made with a MeshContext): the query's
gather splits by doc shard on the host and every shard scores its postings
on its device (parallel/sharded_ft.py), merged once: `sharded_scores`. As
in the reference it replaces the host merge and the sorted path where the
holder's capacity divides into the shards (the fielded scorer and the
batched sorted path stay on one device), and the dense head doc-shards its
matrices (device_dense.py).

The reference's notes follow.

Semantic equivalent of the reference Selector
(cpp_src/core/ft/ft_fast/selecterimpl.h:631 Process, selecter.h:149-168
tryToCorrectTypos/transliterate/stem/addSynonyms): each DSL term expands into
dictionary *variants* — exact word, prefix/suffix matches, typo candidates,
stem-prefix matches, transliteration, keyboard layout, synonyms — each with
its base relevancy proc (FtSubTermProcs). The variants select CSR posting
ranges; the device scorer (scorer.py) folds them into ranked docs.

Partial-match relevancy mirrors ftconfig.h:183-185:
    proc = fullMatch - partialMatchDecrease * unmatched / matched
clamped to prefixMin/suffixMin.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from .. import tracing
from . import device_dense
from .config import FtFastConfig
from .dataholder import FtDataHolder
from .dsl import FtDslQuery, FtTerm, parse_ft_dsl
from ..core.errors import QueryError
from .scorer import (drain, idf_host, score_and_merge_batch_sorted,
                     score_and_merge_fielded, score_and_merge_sorted)
from .stemmer import get_stemmer
from .mmseg import segmenter_for_config
from .tokenizer import tokenize
from .variants import SynonymsMap, kblayout_variants, translit_variants

# queries answered by the host C++ merge
host_merges = tracing.counter("ft.host_merges")
# queries scored by the device sorted path
sorted_scores = tracing.counter("ft.sorted_scores")
# queries answered by the device dense route
dense_scores = tracing.counter("ft.dense_scores")
# queries scored by the fielded sum-ranks path
fielded_scores = tracing.counter("ft.fielded_scores")
# dense queries re-run elsewhere (overflow flag)
dense_overflows = tracing.counter("ft.dense_overflows")
# host-merge queries sent to the sorted path because the C++ lane is not
# built
native_fallbacks = tracing.counter("ft.native_fallbacks")
# queries scored doc-sharded over a mesh
sharded_scores = tracing.counter("ft.sharded_scores")


_MAX_VARIANT_WORDS = 1024
_MIN_STEM_LEN = 3


def _pad_pow2(n: int, floor: int = 64) -> int:
    c = floor
    while c < n:
        c *= 2
    return c


def normalize_ranks(docs: np.ndarray, scores: np.ndarray, min_rank: float,
                    ) -> tuple[np.ndarray, np.ndarray]:
    """docRank = sum*255/allmax + minRank cut (mergerimpl.h:107)."""
    allmax = float(scores[0]) if len(scores) else 1.0
    ranks = scores * (255.0 / max(allmax, 1e-30))
    keep = ranks >= min_rank
    return docs[keep].astype(np.int64), ranks[keep].astype(np.float32)


@dataclasses.dataclass
class FtSelectResult:
    ids: np.ndarray            # int64 doc rows, best rank first
    ranks: np.ndarray          # float32 0..255 (reference rank scale)
    matched_words: set         # vocabulary words that produced matches
    holder: Optional[FtDataHolder] = None
    # vocabulary word ids behind matched_words: with the holder they
    # resolve source-offset areas for highlight/snippet (areaholder.h)
    matched_wids: set = dataclasses.field(default_factory=set)
    # field indices actually searched (None = all): areas exclude fields
    # the query did not target (reference: per-field merge areas)
    searched_fields: Optional[set] = None


class FtSelector:
    def __init__(self, holder: FtDataHolder, cfg: FtFastConfig,
                 mesh_ctx=None):
        self.holder = holder
        self.cfg = cfg
        self.synonyms = SynonymsMap(cfg.synonyms)
        # device field-param vectors cached per DSL field signature
        # (5 small arrays otherwise re-uploaded every query)
        self._fp_cache: dict = {}
        # device-resident dense scorer for frequent words (device_dense.py)
        self._ddense = None
        # mesh-resident mode (parallel/context.MeshContext): the default
        # scorer runs doc-sharded with one merge of the shards' top-k
        self.mesh_ctx = mesh_ctx

    # ------------------------------------------------------------------
    def process(self, dsl: str, normalize: bool = True) -> FtSelectResult:
        q = parse_ft_dsl(dsl)
        return self.process_query(q, normalize=normalize)

    def _prepare(self, q: FtDslQuery) -> Optional[dict]:
        """Host half of a query: synonym/stop handling, variant expansion,
        gather-array construction, per-term vectors. Returns None when the
        query cannot match anything."""
        h = self.holder
        cfg = self.cfg
        if h.total_docs == 0 or not len(h.words):
            return None

        # CJK query terms split into per-character phrase groups (mirror of
        # the index-side unigram split, tokenizer._split_cjk)
        q = self._cjk_expand(q)

        # multi-word synonym spans add alternative variant terms
        terms = list(q.terms)
        patterns = [t.pattern for t in terms]
        for start, end, alts in self.synonyms.multi_matches(patterns):
            for alt in alts:
                for tok in tokenize(alt, cfg.extra_word_symbols,
                    segmenter_for_config(cfg)):
                    terms.append(dataclasses.replace(
                        terms[start], pattern=tok, phrase_group=-1,
                        op="or" if terms[start].op != "not" else "not"))

        # drop stop-word query terms (reference: stop words skipped in query)
        terms = [t for t in terms
                 if t.pattern not in cfg.stop_words
                 and t.pattern not in cfg.morpheme_stop_words]
        if not terms:
            return None

        # --- expand variants per term: word_id -> proc (max if several)
        variants: list[dict[int, float]] = [self._expand(t) for t in terms]
        if not any(variants):
            return None

        # --- collect per-(term, variant-word) posting runs. Each run is a
        # CONTIGUOUS doc-sorted CSR range [start, start+len) — the host merge
        # (csrc score_merge_runs) consumes them sort-free, and the device
        # gather arrays expand from them on the device (_device_gather) only
        # when a device path actually runs.
        run_start_p, run_len_p, run_term_p = [], [], []
        run_w_p, run_idf_p = [], []
        matched_words: set = set()
        matched_wids: set = set()
        bm25_type = cfg.bm25.bm25_type
        for t_idx, var in enumerate(variants):
            if not var:
                continue
            wids = np.fromiter(var.keys(), dtype=np.int64, count=len(var))
            procs = np.fromiter(var.values(), dtype=np.float32, count=len(var))
            idfs = idf_host(h.total_docs, h.word_ndocs[wids], bm25_type)
            starts = h.word_start[wids]
            ends = h.word_start[wids + 1]
            lens = (ends - starts).astype(np.int64)
            total = int(lens.sum())
            if total == 0:
                continue
            if terms[t_idx].op != "not":
                for w in wids:
                    matched_words.add(h.words[w])
                    matched_wids.add(int(w))
            nz = lens > 0
            run_start_p.append(starts[nz].astype(np.int64))
            run_len_p.append(lens[nz])
            run_term_p.append(np.full(int(nz.sum()), t_idx, dtype=np.int32))
            run_w_p.append((procs[nz] / 100.0).astype(np.float32))
            run_idf_p.append(idfs[nz].astype(np.float32))

        if not run_start_p:
            return None
        run_start = np.concatenate(run_start_p)
        run_len = np.concatenate(run_len_p)
        n_terms = len(terms)
        term_boost = np.ones(n_terms, dtype=np.float32)
        term_lenb = np.ones(n_terms, dtype=np.float32)
        must = np.zeros(n_terms, dtype=np.bool_)
        notm = np.zeros(n_terms, dtype=np.bool_)
        for i, t in enumerate(terms):
            term_boost[i] = t.boost
            term_lenb[i] = self._term_len_bound(t.term_len_boost)
            must[i] = (t.op == "must") or t.phrase_group >= 0
            notm[i] = t.op == "not"
        return {
            "terms": terms, "variants": variants,
            "matched_words": matched_words,
            "matched_wids": matched_wids,
            "run_start": run_start, "run_len": run_len,
            "run_term": np.concatenate(run_term_p),
            "run_w": np.concatenate(run_w_p),
            "run_idf": np.concatenate(run_idf_p),
            "G": int(run_len.sum()),
            "term_boost": term_boost, "term_lenb": term_lenb,
            "must": must, "notm": notm,
        }

    def _fp_tensors(self, q: FtDslQuery) -> tuple:
        """The field-param vectors of q on the holder's device (cached)."""
        fp_key = tuple((f.name, f.boost, f.sum_rank) for f in q.fields)
        cached = self._fp_cache.get(fp_key)
        if cached is None:
            cached = tuple(torch.from_numpy(a).to(self.holder.device)
                           for a in self._field_params(q))
            if len(self._fp_cache) < 64:
                self._fp_cache[fp_key] = cached
        return cached

    def process_query(self, q: FtDslQuery, normalize: bool = True,
                      _prep: Optional[dict] = None) -> FtSelectResult:
        h = self.holder
        cfg = self.cfg
        empty = FtSelectResult(np.empty(0, dtype=np.int64),
                               np.empty(0, dtype=np.float32), set(), h)
        prep = self._prepare(q) if _prep is None else _prep
        if prep is None:
            return empty
        terms = prep["terms"]
        variants = prep["variants"]
        matched_words = prep["matched_words"]

        from .dataholder import _pad_pow2 as _cap_pow2
        cap = _cap_pow2(max(len(h.doc_words), 1))
        merge_k = min(cfg.merge_limit, cap)
        # term-proximity boost only matters for multi-term queries
        # (mergerimpl.h:179 — attenuates later terms far from earlier ones)
        use_prox = cfg.distance_weight > 0.0 and len(terms) > 1
        # fullMatchBoost: field length == positive-term count (merger.h:101)
        n_pos_terms = int((~prep["notm"]).sum())
        use_fm = cfg.full_match_boost != 1.0 and n_pos_terms > 0
        sum_fields = [f.name for f in q.fields if f.sum_rank]
        fielded = cfg.sum_ranks_by_fields_ratio > 0 and bool(sum_fields)
        # mesh-resident mode: doc-sharded scoring (the reference's exact
        # condition: not fielded, and the capacity divides into the shards)
        sharded = (self.mesh_ctx is not None and not fielded
                   and cap % self.mesh_ctx.n_shards == 0)
        res = None
        if not fielded:
            # frequent-word queries whose variants are all device-resident
            # run the dense device scorer (device_dense.py)
            res = self._try_dense(q, prep, merge_k, use_prox, use_fm)
            if res is None and not sharded:
                res = self._score_host(q, prep, merge_k=merge_k,
                                       use_prox=use_prox, use_fm=use_fm,
                                       n_pos_terms=n_pos_terms)
        out = None
        if res is None and sharded:
            out = self._score_sharded(q, prep, cap, merge_k, use_prox,
                                      use_fm, n_pos_terms)
        elif res is None:
            out = self._score_device(q, prep, cap, merge_k, use_prox,
                                     use_fm, n_pos_terms, sum_fields,
                                     fielded)
        from ..core.rdxcontext import check_cancel
        check_cancel()          # between device dispatch and drain
        scores, docs = res if out is None else drain(*out)
        keep = docs >= 0
        scores, docs = scores[keep], docs[keep]
        if len(docs) == 0:
            return empty

        # --- phrase verification on host (positions CSR)
        if q.phrase_distance:
            pmask = self._verify_phrases(q, terms, variants, docs)
            scores, docs = scores[pmask], docs[pmask]
            if len(docs) == 0:
                return empty

        wids = prep["matched_wids"]
        searched = None
        if q.fields:
            fbv = self._field_params(q)[0]
            searched = {i for i in range(len(h.field_names)) if fbv[i] > 0}
        if not normalize:
            # raw docRank sums (merged/normalized by the caller — the
            # incremental-step merge in index/text.py)
            return FtSelectResult(docs.astype(np.int64),
                                  scores.astype(np.float32),
                                  matched_words, h, matched_wids=wids,
                                  searched_fields=searched)
        docs, ranks = normalize_ranks(docs, scores, cfg.min_rank)
        return FtSelectResult(docs, ranks, matched_words, h,
                              matched_wids=wids, searched_fields=searched)

    def _device_gather(self, preps: list, gpad: int,
                       n_rows: int = 0) -> list:
        """The gather arrays (g_idx i32, g_term i32, g_w f32, g_idf f32) of
        each prepared query as [n_rows, gpad] tensors on the holder's device
        (n_rows >= len(preps); rows past them and columns past a query's G
        are zero): the values the reference's `_gather_arrays` builds on the
        host, expanded on the device from the posting runs, so the host
        uploads a few numbers a run instead of four a posting."""
        n_rows = max(n_rows, len(preps))
        dev = self.holder.device
        lens = np.concatenate([p["run_len"] for p in preps])
        cols = np.concatenate([np.cumsum(p["run_len"]) - p["run_len"]
                               for p in preps])
        rows = np.repeat(np.arange(len(preps), dtype=np.int64),
                         [len(p["run_len"]) for p in preps])
        ints = torch.from_numpy(np.stack([
            np.concatenate([p["run_start"] for p in preps]).astype(np.int64),
            rows * gpad + cols, np.cumsum(lens) - lens, lens,
            np.concatenate([p["run_term"] for p in preps]).astype(np.int64)
        ])).to(dev)
        floats = torch.from_numpy(np.stack([
            np.concatenate([p["run_w"] for p in preps]),
            np.concatenate([p["run_idf"] for p in preps])
        ]).astype(np.float32)).to(dev)
        total = int(lens.sum())
        run = torch.repeat_interleave(
            torch.arange(len(lens), device=dev), ints[3], output_size=total)
        off = torch.arange(total, device=dev) - ints[2][run]
        at = ints[1][run] + off
        out = []
        for vals, dtype in ((ints[0][run] + off, torch.int32),
                            (ints[4][run], torch.int32),
                            (floats[0][run], torch.float32),
                            (floats[1][run], torch.float32)):
            a = torch.zeros(n_rows * gpad, dtype=dtype, device=dev)
            a[at] = vals.to(dtype)
            out.append(a.view(n_rows, gpad))
        return out

    def _score_device(self, q, prep, cap: int, merge_k: int, use_prox: bool,
                      use_fm: bool, n_pos_terms: int, sum_fields: list,
                      fielded: bool):
        """One query scored from its gathered postings on the device: the
        sorted path, or the fielded scorer. Returns device tensors
        (scores, docs)."""
        h, cfg = self.holder, self.cfg
        dev = h.device_arrays()
        fb, bb, bw, pb, pw = self._fp_tensors(q)
        # per-term parameter vectors padded to a shape bucket
        t_count = _pad_pow2(len(prep["terms"]), 2)

        def padt(a, fill):
            out = np.full(t_count, fill, dtype=a.dtype)
            out[: len(a)] = a
            return torch.from_numpy(out).to(h.device)

        gather = [a[0] for a in self._device_gather([prep],
                                                    _pad_pow2(prep["G"]))]
        args = (*gather, dev["post_doc"], dev["post_field"], dev["post_tf"],
                dev["post_minpos"], dev["doc_words"], fb, bb, bw, pb, pw,
                padt(prep["term_boost"], 1), padt(prep["term_lenb"], 1),
                padt(prep["must"], False), padt(prep["notm"], False))
        kw = dict(dist_w=cfg.distance_weight, dist_b=cfg.distance_boost,
                  use_proximity=use_prox, field_words=dev["field_words"],
                  n_terms=n_pos_terms, fm_boost=cfg.full_match_boost,
                  use_fullmatch=use_fm)
        if fielded:
            # field-rank summation (fulltext.md:118-128 '+'-marked fields)
            sum_mask = np.zeros(len(fb), dtype=np.bool_)
            for i, name in enumerate(h.field_names):
                if name in sum_fields:
                    sum_mask[i] = True
            fielded_scores.add()
            return score_and_merge_fielded(
                *args, torch.from_numpy(sum_mask).to(h.device),
                cfg.bm25.k1, cfg.bm25.b, h.avg_doc_len, t_count, len(fb),
                cap, merge_k, cfg.bm25.bm25_type,
                float(cfg.sum_ranks_by_fields_ratio), **kw)
        sorted_scores.add()
        return score_and_merge_sorted(
            *args, cfg.bm25.k1, cfg.bm25.b, h.avg_doc_len, t_count, cap,
            merge_k, cfg.bm25.bm25_type, **kw)

    # ------------------------------------------------------------------
    # Mesh-resident scoring: postings doc-sharded over the mesh, the
    # query's gather split by shard on the host, BM25 + proximity /
    # full-match boosts computed on each shard, one merge of the shards'
    # top-k (parallel/sharded_ft.py).
    # ------------------------------------------------------------------
    def _mesh_pack(self) -> dict:
        """Doc-sharded posting arrays on the shards' devices, cached on
        the holder (holders are immutable once built)."""
        from .dataholder import _pad_pow2 as _cap_pow2
        from ..parallel.sharded_ft import shard_postings
        h, ctx = self.holder, self.mesh_ctx
        pack = getattr(h, "_mesh_pack_cache", None)
        if pack is not None and pack["ctx"] is ctx:
            return pack
        cps = _cap_pow2(max(len(h.doc_words), 1)) // ctx.n_shards
        packed, dw, remap_shard, remap_local, _, fw = shard_postings(
            h, ctx.n_shards, cps)
        pack = {"ctx": ctx, "cps": cps, "remap_shard": remap_shard,
                "remap_local": remap_local, "doc_words": ctx.shard_rows(dw),
                "field_words": ctx.shard_rows(fw)}
        for name, a in packed.items():
            pack[name] = ctx.shard_rows(a)
        h._mesh_pack_cache = pack
        return pack

    def _score_sharded(self, q, prep, cap: int, merge_k: int,
                       use_prox: bool, use_fm: bool, n_pos_terms: int):
        """One query scored doc-sharded: device tensors (scores
        f32[merge_k], docs i32[merge_k]) on the merge device."""
        from ..parallel.sharded_ft import build_sharded_bm25
        h, cfg, ctx = self.holder, self.cfg, self.mesh_ctx
        pack = self._mesh_pack()
        S, cps = ctx.n_shards, pack["cps"]
        # the gather expanded from the posting runs, split per doc shard
        # (stable sort by shard, then per-shard positional fill)
        lens = prep["run_len"]
        run = np.repeat(np.arange(len(lens)), lens)
        g_idx = (prep["run_start"][run] + np.arange(int(lens.sum()))
                 - np.repeat(np.cumsum(lens) - lens, lens))
        s_of = pack["remap_shard"][g_idx]
        counts = np.bincount(s_of, minlength=S)
        gp = _pad_pow2(max(int(counts.max()), 1))
        order = np.argsort(s_of, kind="stable")
        offs = np.zeros(S, dtype=np.int64)
        np.cumsum(counts[:-1], out=offs[1:])
        within = np.arange(len(g_idx), dtype=np.int64) - offs[s_of[order]]
        rows = s_of[order]

        def scat(src, dtype):
            out = np.zeros((S, gp), dtype=dtype)
            out[rows, within] = src[order]
            return ctx.shard_rows(out)

        t_count = _pad_pow2(len(prep["terms"]), 2)

        def padt(a, fill):
            out = np.full(t_count, fill, dtype=a.dtype)
            out[: len(a)] = a
            return torch.from_numpy(out)

        fn = build_sharded_bm25(
            ctx, t_count, cps, merge_k, cfg.bm25.bm25_type,
            dist_w=cfg.distance_weight, dist_b=cfg.distance_boost,
            use_proximity=use_prox, n_terms=n_pos_terms,
            fm_boost=cfg.full_match_boost, use_fullmatch=use_fm)
        sharded_scores.add()
        return fn(scat(pack["remap_local"][g_idx], np.int32),
                  scat(prep["run_term"][run].astype(np.int32), np.int32),
                  scat(prep["run_w"][run], np.float32),
                  scat(prep["run_idf"][run], np.float32),
                  pack["post_doc"], pack["post_field"], pack["post_tf"],
                  pack["post_minpos"], pack["doc_words"],
                  pack["field_words"], *self._fp_tensors(q),
                  padt(prep["term_boost"], 1), padt(prep["term_lenb"], 1),
                  padt(prep["must"], False), padt(prep["notm"], False),
                  np.asarray([cfg.bm25.k1, cfg.bm25.b, h.avg_doc_len],
                             np.float32))

    # ------------------------------------------------------------------
    # Host C++ merge for small/medium gathers (csrc/ft_native.cpp
    # score_merge_runs / score_merge_dense, the reference's CPU Merger
    # analog, mergerimpl.h:95-124). HOST_SCORE_MAX: the largest gather the
    # host merges (the device sorted path takes larger ones); DENSE_MIN: the
    # least gather for which the host's dense [T, cap] doc-major merge
    # replaces its k-way heap merge. Both are the fit of two runs' H100
    # route tables (tests/test_torch_ft.py ROUTE_TABLES: NVIDIA H100 80GB
    # HBM3 at 700 W, 1M docs); the reference's are 2^23 and 2^17.
    # SINGLE_CACHE_MIN: the least gather of a single-term query whose top-k
    # the host materializes per word (and warm_frequent_singles warms at
    # commit); the reference ties it to DENSE_MIN, the port keeps its 2^17.
    HOST_SCORE_MAX = 1 << 16
    DENSE_MIN = 1 << 19
    SINGLE_CACHE_MIN = 1 << 17

    def _ab_arrays(self, fb, bb, bw, pb, pw):
        """Query-independent per-posting affine score parts (cached on the
        holder): subTermRank = w*tb*tlb * (A[p] + beta*B[p]) with
        A = fb*(1-bw)*posrank, B = fb*bb*bw*X*posrank, beta = idf (rx/
        classic) or 1 (word_count). One vectorized pass over the postings
        at first use (~0.3s at 18M) turns the merge's per-posting math into
        two fused multiply-adds."""
        h, cfg = self.holder, self.cfg
        key = (tuple(fb), tuple(bb), tuple(bw), tuple(pb), tuple(pw),
               cfg.bm25.k1, cfg.bm25.b, round(h.avg_doc_len, 6),
               cfg.bm25.bm25_type, h.num_postings)
        cached = getattr(h, "_ab_cache", None)
        if cached is not None and cached[0] == key:
            return cached[1], cached[2]
        fld = h.post_field
        minpos = h.post_minpos.astype(np.float32)
        # pos2rank piecewise (ftconfig.h:126-144), vectorized
        p = minpos
        p2r = np.where(
            p <= 10, 1.0 - p / 100.0,
            np.where(p <= 100, 0.9 - p / 1000.0,
                     np.where(p <= 1000, 0.8 - p / 10000.0,
                              np.where(p <= 10000, 0.7 - p / 100000.0,
                                       np.where(p <= 100000, 0.6 - p / 1e6,
                                                0.5))))).astype(np.float32)
        fbv, bbv, bwv = fb[fld], bb[fld], bw[fld]
        posrank = (1.0 - pw[fld]) + p2r * pb[fld] * pw[fld]
        k1, b = cfg.bm25.k1, cfg.bm25.b
        wdoc = np.maximum(h.doc_words[h.post_doc], 1.0)
        if cfg.bm25.bm25_type == "word_count":
            X = h.post_tf
        else:
            tfq = (h.post_tf / wdoc if cfg.bm25.bm25_type == "classic"
                   else h.post_tf)
            X = tfq * (k1 + 1.0) / (tfq + k1 * (1.0 - b
                                                + b * wdoc / h.avg_doc_len))
        A = np.ascontiguousarray(fbv * (1.0 - bwv) * posrank, np.float32)
        B = np.ascontiguousarray(fbv * bbv * bwv * X * posrank, np.float32)
        # fully-folded rank PR = A + idf_word*B: idf is a corpus statistic
        # (word_ndocs/total_docs), so PR is query-independent too — the
        # dense merge then reads ONE float per posting instead of two
        if cfg.bm25.bm25_type == "word_count":
            beta = np.float32(1.0)
        else:
            widf = idf_host(h.total_docs, h.word_ndocs,
                            cfg.bm25.bm25_type).astype(np.float32)
            beta = np.repeat(widf, np.diff(h.word_start))
        PR = np.ascontiguousarray(A + beta * B, np.float32)
        h._ab_cache = (key, A, B, PR)
        return A, B

    def _score_host(self, q, prep, merge_k: int, use_prox: bool,
                    use_fm: bool, n_pos_terms: int):
        h, cfg = self.holder, self.cfg
        t_real = len(prep["must"])
        # materialized per-word top-merge_k for frequent singles: a
        # single-term single-run ranking is a pure function of the word
        # up to the positive query scale rboost (which rank normalization
        # cancels), so the C++ pass runs once per (word, holder revision)
        # and zipf-head singles become a dict hit. Keyed on the AB-cache
        # key (field params + postings count = holder revision), the run
        # span, merge_k and the fm/boost knobs. Such a single stays on this
        # route whatever its size (with the reference's constants it never
        # exceeds HOST_SCORE_MAX)
        single = (t_real == 1 and len(prep["run_start"]) == 1
                  and not use_prox and prep["G"] >= self.SINGLE_CACHE_MIN
                  and merge_k > 0 and not prep["notm"][0])
        if prep["G"] > self.HOST_SCORE_MAX and not single:
            return None
        from .dataholder import _native_module
        native = _native_module()
        if native is None:
            native_fallbacks.add()
            return None
        # dense merge when postings dwarf the per-doc combine/memset cost
        # and the [T, cap] accumulator stays modest
        dense = (prep["G"] >= self.DENSE_MIN
                 and prep["G"] >= h.total_docs // 4
                 and t_real * h.total_docs <= (1 << 26))
        entry = native.score_merge_dense if dense else native.score_merge_runs
        fb, bb, bw, pb, pw = self._field_params(q)
        bm25_code = {"rx": 0, "classic": 1, "word_count": 2}.get(
            cfg.bm25.bm25_type, 0)
        fw = np.ascontiguousarray(h.field_words, dtype=np.int32)
        extra = ()
        run_idf = np.ascontiguousarray(prep["run_idf"], np.float32)
        if dense or single:
            # the single's cache key is the AB cache's (holder revision)
            self._ab_arrays(fb, bb, bw, pb, pw)
        if dense:
            if cfg.bm25.bm25_type == "word_count":
                run_idf = np.ones_like(run_idf)    # beta=1: B carries tf
            extra = (None, None, self.holder._ab_cache[3])
        skey = None
        if single:
            skey = (self.holder._ab_cache[0],
                    int(prep["run_start"][0]), int(prep["run_len"][0]),
                    int(merge_k), bool(use_fm), bm25_code,
                    float(prep["term_boost"][0]),
                    float(prep["term_lenb"][0]))
            cache = getattr(h, "_single_top_cache", None)
            if cache is None:
                cache = h._single_top_cache = {}
            hit = cache.get(skey)
            if hit is not None:
                docs0, scores0, rb0 = hit
                rb = float(prep["run_w"][0] * prep["term_boost"][0]
                           * prep["term_lenb"][0])
                if rb != rb0:
                    scores0 = scores0 * np.float32(rb / rb0)
                host_merges.add()
                return scores0, docs0
        docs_raw, scores_raw = entry(
            np.ascontiguousarray(prep["run_start"], np.int64),
            np.ascontiguousarray(prep["run_len"], np.int64),
            np.ascontiguousarray(prep["run_term"], np.int32),
            np.ascontiguousarray(prep["run_w"], np.float32),
            run_idf,
            h.post_doc, h.post_field, h.post_tf, h.post_minpos,
            h.doc_words,
            np.ascontiguousarray(fb, np.float32),
            np.ascontiguousarray(bb, np.float32),
            np.ascontiguousarray(bw, np.float32),
            np.ascontiguousarray(pb, np.float32),
            np.ascontiguousarray(pw, np.float32),
            np.ascontiguousarray(prep["term_boost"], np.float32),
            np.ascontiguousarray(prep["term_lenb"], np.float32),
            np.ascontiguousarray(prep["must"], np.uint8),
            np.ascontiguousarray(prep["notm"], np.uint8),
            float(cfg.bm25.k1), float(cfg.bm25.b), float(h.avg_doc_len),
            bm25_code,
            float(cfg.distance_weight), float(cfg.distance_boost),
            1 if use_prox else 0,
            fw, int(fw.shape[0]), int(fw.shape[1]),
            int(n_pos_terms), 1 if use_fm else 0,
            float(cfg.full_match_boost), int(merge_k), *extra)
        docs = np.frombuffer(docs_raw, dtype=np.int32)
        scores = np.frombuffer(scores_raw, dtype=np.float32)
        if skey is not None:
            rb = float(prep["run_w"][0] * prep["term_boost"][0]
                       * prep["term_lenb"][0])
            cache[skey] = (docs, scores, rb)
            while len(cache) > 64:          # frequent words are few
                cache.pop(next(iter(cache)))
        host_merges.add()
        return scores, docs

    def warm_frequent_singles(self, limit: int) -> int:
        """Pre-materialize the per-word top-k cache for the zipf head.

        A cold frequent single-term query streams its postings through the
        host merge; the result is a pure function of the word + holder
        revision, so running the head words once at commit time turns
        every later cold single into a dict hit. Only words that the cache
        keeps (>= SINGLE_CACHE_MIN postings) qualify. Returns the number
        warmed.
        """
        if limit <= 0 or self.mesh_ctx is not None:
            return 0
        h = self.holder
        if getattr(h, "word_start", None) is None or len(h.word_start) < 2:
            return 0
        counts = np.diff(h.word_start)
        eligible = np.nonzero(counts >= self.SINGLE_CACHE_MIN)[0]
        if eligible.size == 0:
            return 0
        order = eligible[np.argsort(counts[eligible])[::-1]][:limit]
        warmed = 0
        for wid in order:
            try:
                self.process(h.word_of(int(wid)))
            except QueryError:
                continue   # a head word that does not parse as a term
            warmed += 1
        return warmed

    # ------------------------------------------------------------------
    # Device-resident dense scorer for frequent words (device_dense.py):
    # the reference's heaviest merges (multi-term zipf-head queries,
    # mergerimpl.h:95-124) move from the host stream onto the device.
    # ------------------------------------------------------------------
    def _device_dense(self):
        if self.mesh_ctx is not None:
            from .dataholder import _pad_pow2 as _cap_pow2
            if (_cap_pow2(max(len(self.holder.doc_words), 1))
                    % self.mesh_ctx.n_shards != 0):
                return None   # tiny corpus: the capacity does not shard
        if self._ddense is None:
            self._ddense = device_dense.FtDeviceDense(self.holder, self.cfg,
                                                      self)
        return self._ddense

    def _try_dense(self, q, prep, merge_k: int, use_prox: bool,
                   use_fm: bool):
        """Single-query device-dense route: (scores, docs) numpy, or None
        for the other routes. Single-TERM queries stay on the host: its
        one-pass merge + per-word materialized top-k cache beat a device
        round trip."""
        if (prep.get("_no_dense") or q.fields
                or len(prep["must"]) < 2
                or prep["G"] < device_dense.DEVICE_MIN_SINGLE):
            return None
        dd = self._device_dense()
        if dd is None or not dd.ensure_built():
            return None
        pack = dd.pack_query(prep)
        if pack is None:
            return None
        sv, sd, ovf = dd.score_batch([pack], merge_k, use_prox, use_fm)
        if bool(ovf[0]):
            prep["_no_dense"] = True      # exactness fallback
            dense_overflows.add()
            return None
        dense_scores.add()
        return sv[0], sd[0]

    # ------------------------------------------------------------------
    def process_batch(self, dsls: list[str]) -> list[FtSelectResult]:
        """Batched serving path: the frequent queries share one dense
        device program, the large ones one sorted program per pow-2 gather
        bucket, and the rest merge on the host. Default field weights only
        (per-query @field lists fall back to per-query execution)."""
        h, cfg = self.holder, self.cfg
        empty = FtSelectResult(np.empty(0, dtype=np.int64),
                               np.empty(0, dtype=np.float32), set(), h)
        queries = [parse_ft_dsl(d) for d in dsls]
        if any(q.fields for q in queries):
            return [self.process_query(q) for q in queries]
        preps = [self._prepare(q) for q in queries]
        live = [i for i, p in enumerate(preps) if p is not None]
        if not live:
            return [empty for _ in queries]

        # routing: small gathers merge on host (C++ score_merge); big ones
        # group into pow2 gather-size BUCKETS with one device program per
        # bucket — the stacked program pads every query's sort to the
        # bucket max, so without bucketing one frequent word taxes the
        # whole batch
        from .dataholder import _native_module
        host_ok = _native_module() is not None
        # frequent queries whose variant words are all device-resident run
        # the dense device scorer in ONE stacked program (device_dense.py)
        dd_min = device_dense.DEVICE_MIN
        dense_pairs, dense_set = [], set()
        dd = None
        if any(preps[i]["G"] >= dd_min for i in live):
            dd = self._device_dense()
            if dd is not None and not dd.ensure_built():
                dd = None
        if dd is not None:
            for i in live:
                if preps[i]["G"] >= dd_min and len(preps[i]["must"]) >= 2:
                    pack = dd.pack_query(preps[i])
                    if pack is not None:
                        dense_pairs.append((i, pack))
                        dense_set.add(i)
        small, big = [], []
        for i in live:
            if i in dense_set:
                continue
            if preps[i]["G"] <= self.HOST_SCORE_MAX:
                if host_ok:
                    small.append(i)
                    continue
                native_fallbacks.add()
            big.append(i)

        # dispatch the dense-frequent program before anything blocks (its
        # device work runs behind the bucket dispatches + host merges)
        dense_handle = None
        if dense_pairs:
            prox_d = (cfg.distance_weight > 0.0
                      and any(len(preps[i]["terms"]) > 1
                              for i, _ in dense_pairs))
            dense_handle = dd.dispatch_batch(
                [p for _, p in dense_pairs],
                min(cfg.merge_limit, dd.cap), prox_d,
                cfg.full_match_boost != 1.0)

        out: list[Optional[FtSelectResult]] = [empty] * len(queries)
        buckets: dict[int, list[int]] = {}
        for i in big:
            buckets.setdefault(_pad_pow2(preps[i]["G"]), []).append(i)
        dev = h.device_arrays() if big else None
        fp = self._fp_tensors(queries[live[0]]) if big else None
        # dispatch every bucket before blocking on any result (device work
        # runs behind the host merges below)
        staged = []
        for G, idxs in sorted(buckets.items()):
            t_count = _pad_pow2(max(len(preps[i]["terms"]) for i in idxs), 2)
            n_q = _pad_pow2(len(idxs), 2)
            cap = dev["cap"]
            merge_k = min(cfg.merge_limit, cap)
            use_prox = (cfg.distance_weight > 0.0
                        and any(len(preps[i]["terms"]) > 1 for i in idxs))
            scores, docs = self._batch_sorted(preps, idxs, n_q, t_count, cap,
                                              merge_k, *fp, dev, use_prox)
            sorted_scores.add(len(idxs))
            staged.append((idxs, scores, docs))

        for i in small:
            out[i] = self.process_query(queries[i], _prep=preps[i])

        from ..core.rdxcontext import check_cancel
        for idxs, scores, docs in staged:
            check_cancel()      # between device dispatch and drain
            scores, docs = drain(scores, docs)
            for j, i in enumerate(idxs):
                out[i] = self._finish(queries[i], preps[i], scores[j],
                                      docs[j])

        if dense_handle is not None:
            check_cancel()
            sv, sdc, ovf = drain(*dense_handle)
            for j, (i, _) in enumerate(dense_pairs):
                q, p = queries[i], preps[i]
                if bool(ovf[j]):
                    p["_no_dense"] = True      # exactness fallback
                    dense_overflows.add()
                    out[i] = self.process_query(q, _prep=p)
                    continue
                dense_scores.add()
                out[i] = self._finish(q, p, sv[j], sdc[j])
        return out

    def _finish(self, q, p, s, d) -> FtSelectResult:
        """One batched query's drained row -> its result: padding dropped,
        phrases verified, ranks normalized."""
        keep = d >= 0
        s, d = s[keep], d[keep]
        if q.phrase_distance and len(d):
            pm = self._verify_phrases(q, p["terms"], p["variants"], d)
            s, d = s[pm], d[pm]
        d2, ranks = normalize_ranks(d, s, self.cfg.min_rank)
        return FtSelectResult(d2, ranks, p["matched_words"], self.holder,
                              matched_wids=p["matched_wids"])

    def _batch_sorted(self, preps, live, n_q, t_count, cap, merge_k,
                      fb, bb, bw, pb, pw, dev, use_prox):
        """Stacked [n_q, G] build for the sorted/segmented batch scorer —
        O(n_q*G) memory, no dense [n_q*t_count, cap] accumulator."""
        cfg = self.cfg
        h = self.holder
        G = _pad_pow2(max(preps[i]["G"] for i in live))
        term_boost = np.ones((n_q, t_count), np.float32)
        term_lenb = np.ones((n_q, t_count), np.float32)
        must = np.zeros((n_q, t_count), np.bool_)
        notm = np.zeros((n_q, t_count), np.bool_)
        n_pos = np.full(n_q, -1, np.int32)     # -1: never full-matches
        for j, i in enumerate(live):           # row j <-> query live[j]
            p = preps[i]
            n_pos[j] = int((~p["notm"]).sum()) or -1
            nt = len(p["terms"])
            term_boost[j, :nt] = p["term_boost"]
            term_lenb[j, :nt] = p["term_lenb"]
            must[j, :nt] = p["must"]
            notm[j, :nt] = p["notm"]
        # rows past the live queries stay empty (n_q is a power of two)
        gather = self._device_gather([preps[i] for i in live], G, n_q)

        def up(a):
            return torch.from_numpy(a).to(h.device)

        return score_and_merge_batch_sorted(
            *gather,
            dev["post_doc"], dev["post_field"], dev["post_tf"],
            dev["post_minpos"], dev["doc_words"], fb, bb, bw, pb, pw,
            up(term_boost), up(term_lenb), up(must), up(notm),
            cfg.bm25.k1, cfg.bm25.b, h.avg_doc_len,
            t_count, cap, merge_k, cfg.bm25.bm25_type,
            dist_w=cfg.distance_weight, dist_b=cfg.distance_boost,
            use_proximity=use_prox,
            field_words=dev["field_words"], n_terms=up(n_pos),
            fm_boost=cfg.full_match_boost,
            use_fullmatch=cfg.full_match_boost != 1.0)

    # ------------------------------------------------------------------
    def _cjk_expand(self, q: FtDslQuery) -> FtDslQuery:
        from .tokenizer import _split_cjk
        seg = segmenter_for_config(self.cfg)
        split = lambda pat: _split_cjk(pat, self.cfg.extra_word_symbols, seg)
        needs = any(len(split(t.pattern)) > 1 for t in q.terms)
        if not needs:
            return q
        out = FtDslQuery(fields=q.fields,
                         phrase_distance=dict(q.phrase_distance))
        next_gid = max(out.phrase_distance, default=-1) + 1
        for t in q.terms:
            parts = split(t.pattern)
            if len(parts) == 1:
                if t.phrase_group >= 0:
                    # keep ordering consistent with spliced CJK positions
                    t = dataclasses.replace(t,
                                            phrase_pos=t.phrase_pos * 1000)
                out.terms.append(t)
                continue
            if t.phrase_group >= 0:
                # splice characters into the existing phrase keeping order
                for j, p in enumerate(parts):
                    out.terms.append(dataclasses.replace(
                        t, pattern=p, exact=True,
                        phrase_pos=t.phrase_pos * 1000 + j))
            else:
                gid = next_gid
                next_gid += 1
                out.phrase_distance[gid] = 1
                op = "not" if t.op == "not" else "must"
                for j, p in enumerate(parts):
                    out.terms.append(dataclasses.replace(
                        t, pattern=p, op=op, exact=True,
                        phrase_group=gid, phrase_pos=j))
        return out

    def _term_len_bound(self, k: float) -> float:
        """bound(termLenBoost, weight, boost) (ftconfig.h:146)."""
        f = self.cfg.default_field
        return (1.0 - f.term_len_weight) + k * f.term_len_boost * f.term_len_weight

    def _field_params(self, q: FtDslQuery):
        names = self.holder.field_names
        fpad = _pad_pow2(max(len(names), 1), 8)
        fb = np.zeros(fpad, dtype=np.float32)
        bb = np.ones(fpad, dtype=np.float32)
        bw = np.full(fpad, self.cfg.default_field.bm25_weight, dtype=np.float32)
        pb = np.ones(fpad, dtype=np.float32)
        pw = np.full(fpad, self.cfg.default_field.position_weight,
                     dtype=np.float32)
        sel = {f.name: f.boost for f in q.fields} if q.fields else None
        all_fields = sel is None or "*" in (sel or {})
        for i, name in enumerate(names):
            fcfg = self.cfg.fields.get(name, self.cfg.default_field)
            bb[i] = fcfg.bm25_boost
            bw[i] = fcfg.bm25_weight
            pb[i] = fcfg.position_boost
            pw[i] = fcfg.position_weight
            if all_fields:
                fb[i] = (sel or {}).get("*", 1.0)
            elif name in sel:
                fb[i] = sel[name]
        return fb, bb, bw, pb, pw

    # ------------------------------------------------------------------
    # variant expansion (reference: Selector::prepareVariants)
    # ------------------------------------------------------------------
    def _expand(self, t: FtTerm) -> dict[int, float]:
        h, cfg, procs = self.holder, self.cfg, self.cfg.procs
        out: dict[int, float] = {}

        def add(wid: Optional[int], proc: float) -> None:
            if wid is not None and proc > out.get(wid, 0.0) \
                    and len(out) < _MAX_VARIANT_WORDS:
                out[wid] = proc

        pat = t.pattern
        add(h.word_id(pat), float(procs.full_match))
        if t.exact:
            return out

        if t.prefix or t.suffix:
            matched = max(len(pat), 1)
            if t.prefix and not t.suffix:
                for wid in h.prefix_match_ids(pat):
                    unmatched = len(h.word_of(wid)) - len(pat)
                    add(wid, max(float(procs.prefix_min),
                                 procs.full_match
                                 - cfg.partial_match_decrease * unmatched / matched))
            elif t.suffix and not t.prefix:
                for wid in h.suffix_match_ids(pat):
                    unmatched = len(h.word_of(wid)) - len(pat)
                    add(wid, max(float(procs.suffix_min),
                                 procs.full_match
                                 - cfg.partial_match_decrease * unmatched / matched))
            else:
                # *term*: contains — scan vocab (bounded)
                cnt = 0
                for wid, w in enumerate(h.words):
                    if pat in w:
                        unmatched = len(w) - len(pat)
                        add(wid, max(float(procs.suffix_min),
                                     procs.full_match
                                     - cfg.partial_match_decrease * unmatched / matched))
                        cnt += 1
                        if cnt >= _MAX_VARIANT_WORDS:
                            break

        if t.typos:
            td = h.typo_dict
            for wid, ntypos in td.candidates(pat, h.word_id, h.word_of).items():
                # reference proc formula (variants/typos.h:82-86): penalty
                # scales with the typo count and shrinks for longer words
                wlen = len(h.word_of(wid))
                add(wid, max(1.0, procs.typo
                             - procs.typo_penalty * ntypos
                             / max((wlen - ntypos) / 3.0, 1.0)))

        # stem variants as prefix searches (reference: selecterimpl.h:204-220)
        if not t.prefix and not t.suffix:
            stem_proc = float(procs.full_match - procs.stemmer_penalty)
            for lang in cfg.stemmers:
                st = get_stemmer(lang)
                if st is None:
                    continue
                stem = st(pat)
                if len(stem) < _MIN_STEM_LEN or stem == pat:
                    continue
                for wid in h.prefix_match_ids(stem):
                    w = h.word_of(wid)
                    # guard against wildly longer words
                    if len(w) - len(stem) <= 4:
                        add(wid, stem_proc)

        if cfg.enable_translit:
            for v in translit_variants(pat):
                add(h.word_id(v), float(procs.translit))
        if cfg.enable_kb_layout:
            for v in kblayout_variants(pat):
                add(h.word_id(v), float(procs.kblayout))
        for alt in self.synonyms.for_term(pat):
            for tok in tokenize(alt, cfg.extra_word_symbols,
                    segmenter_for_config(cfg)):
                add(h.word_id(tok), float(procs.synonyms))
        return out

    # ------------------------------------------------------------------
    # phrase verification (host, positions CSR)
    # ------------------------------------------------------------------
    def _verify_phrases(self, q: FtDslQuery, terms: list[FtTerm],
                        variants: list[dict[int, float]],
                        docs: np.ndarray) -> np.ndarray:
        h = self.holder
        groups: dict[int, list[int]] = {}
        for i, t in enumerate(terms):
            if t.phrase_group >= 0:
                groups.setdefault(t.phrase_group, []).append(i)
        mask = np.ones(len(docs), dtype=np.bool_)
        native = h.native_module()
        use_native = (native is not None
                      and hasattr(native, "verify_phrases"))
        for gid, tidx in groups.items():
            tidx.sort(key=lambda i: terms[i].phrase_pos)
            dist = q.phrase_distance.get(gid, 1)
            if use_native:
                # batched C++ walk over the positions CSR (reference:
                # PhraseMerger, ft_fast/phrasemerger*.h) — one call per
                # phrase group for ALL candidate docs
                slot_ranges = [
                    np.ascontiguousarray(
                        np.asarray([h.posting_range(w)
                                    for w in variants[ti]],
                                   dtype=np.int64).reshape(-1, 2))
                    for ti in tidx]
                raw = native.verify_phrases(
                    np.ascontiguousarray(h.post_doc, dtype=np.int32),
                    np.ascontiguousarray(h.post_field, dtype=np.int32),
                    np.ascontiguousarray(h.pos_start, dtype=np.int64),
                    np.ascontiguousarray(h.pos_flat, dtype=np.int32),
                    np.ascontiguousarray(docs, dtype=np.int32),
                    slot_ranges, int(dist))
                mask &= np.frombuffer(raw, dtype=np.uint8).astype(bool)
                continue
            # pure-Python fallback (semantically identical; tests enforce)
            for di, doc in enumerate(docs):
                if not mask[di]:
                    continue
                if not self._phrase_in_doc(int(doc), tidx, variants, dist):
                    mask[di] = False
        return mask

    def _phrase_in_doc(self, doc: int, tidx: list[int],
                       variants: list[dict[int, float]], dist: int) -> bool:
        h = self.holder
        # field -> list of position sets per slot
        per_slot: list[dict[int, np.ndarray]] = []
        for ti in tidx:
            fields: dict[int, list[np.ndarray]] = {}
            for wid in variants[ti]:
                s, e = h.posting_range(wid)
                lo = s + int(np.searchsorted(h.post_doc[s:e], doc, "left"))
                hi = s + int(np.searchsorted(h.post_doc[s:e], doc, "right"))
                for p in range(lo, hi):
                    fields.setdefault(int(h.post_field[p]), []).append(
                        h.positions_of(p))
            if not fields:
                return False
            per_slot.append({f: np.unique(np.concatenate(v))
                             for f, v in fields.items()})
        for f in per_slot[0]:
            cur = per_slot[0][f]
            ok = True
            for nxt_slot in per_slot[1:]:
                nxt = nxt_slot.get(f)
                if nxt is None:
                    ok = False
                    break
                # need next position within (0, dist] after some current pos
                hits = []
                for d in range(1, dist + 1):
                    hits.append(nxt[np.isin(nxt, cur + d)])
                cur = np.unique(np.concatenate(hits)) if hits else np.empty(0)
                if len(cur) == 0:
                    ok = False
                    break
            if ok:
                return True
        return False

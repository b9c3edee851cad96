"""FT posting store: host dictionary + device CSR posting arrays (port of
reindexer_tpu/ft/dataholder.py).

The build is the reference's host code. The device mirrors
(`device_arrays`) are torch tensors on the holder's explicit device, each
cast on purpose: `jnp.asarray` narrows int64 and float64 to 32 bits where
`torch.from_numpy` keeps them, so the port names int32 for the posting
columns and float32 for the word counts. They keep the reference's pow-2
padding, on which the scorers' shapes and their -inf / -1 padding rest.

The reference's notes follow.

TPU-native re-design of the reference DataHolder/DataProcessor
(cpp_src/core/ft/ft_fast/dataholder.h:69-207, dataprocessor.cc:23-75,
idrelset.h): instead of per-word hash maps with packed posting vectors walked
by a scalar merge loop, the inverted index is a flat CSR layout —

    word_start[W+1] -> postings  (one posting per (word, doc, field):
        post_doc[P] int32, post_field[P] int32, post_tf[P] f32,
        post_minpos[P] int32)
    pos_start[P+1] -> pos_flat   (all token positions, host-only: used for
                                  phrase verification and highlight areas)

The postings arrays are mirrored to device memory where the BM25 scorer
(scorer.py) consumes them with gathers + segment scatter-adds; the dictionary
(vocab, prefix/suffix ordering, typo map) stays host-side — the split
mandated by SURVEY.md §7 ("string-heavy FT dictionary ops don't fit TPU").

The whole build is vectorized numpy (np.unique/lexsort/bincount — the batch
analog of the reference's multithreaded buildWordsMap fan-out, P2 in
SURVEY.md §2.4).
"""
from __future__ import annotations

import bisect
from typing import Iterable, Optional

import numpy as np
import torch

from .config import FtFastConfig
from .tokenizer import tokenize
from .typos import TypoDict

_NATIVE = None
_NATIVE_TRIED = False
_TYPOS_NATIVE = None
_TYPOS_TRIED = False


def _typos_native_module():
    global _TYPOS_NATIVE, _TYPOS_TRIED
    if not _TYPOS_TRIED:
        _TYPOS_TRIED = True
        import os
        if os.environ.get("RX_TPU_DISABLE_NATIVE", "") not in ("1", "true"):
            from ..csrc import load
            _TYPOS_NATIVE = load("_typos_native", "typos_native.cpp")
    return _TYPOS_NATIVE


def _native_module():
    """Lazy-built C++ tokenizer (csrc/ft_native.cpp); None -> Python path."""
    global _NATIVE, _NATIVE_TRIED
    if not _NATIVE_TRIED:
        _NATIVE_TRIED = True
        import os
        if os.environ.get("RX_TPU_DISABLE_NATIVE", "") not in ("1", "true"):
            from ..csrc import load
            _NATIVE = load("_ft_native", "ft_native.cpp")
    return _NATIVE


def _pad_pow2(n: int, floor: int = 1024) -> int:
    c = floor
    while c < n:
        c *= 2
    return c


class FtDataHolder:
    """One committed full-text index build over a namespace's text fields."""

    def __init__(self, cfg: FtFastConfig, field_names: list[str],
                 device: torch.device | str = "cuda"):
        self.cfg = cfg
        self.device = torch.device(device)
        self.field_names = list(field_names)
        self.words: np.ndarray = np.empty(0, dtype=object)  # sorted vocab
        self.vocab: dict[str, int] = {}
        self.rev_words: list[str] = []        # sorted reversed words
        self.rev_ids: np.ndarray = np.empty(0, dtype=np.int64)
        self.word_start = np.zeros(1, dtype=np.int64)
        self.word_ndocs = np.empty(0, dtype=np.int64)
        self.post_doc = np.empty(0, dtype=np.int32)
        self.post_field = np.empty(0, dtype=np.int32)
        self.post_tf = np.empty(0, dtype=np.float32)
        self.post_minpos = np.empty(0, dtype=np.int32)
        self.pos_start = np.zeros(1, dtype=np.int64)
        self.pos_flat = np.empty(0, dtype=np.int32)
        self.doc_words = np.empty(0, dtype=np.float32)
        self.field_words = np.zeros((1, 0), dtype=np.int32)
        self.total_docs = 0
        self.avg_doc_len = 1.0
        self._typo_dict: Optional[TypoDict] = None
        # device mirrors (lazy)
        self._device: Optional[dict] = None

    # ------------------------------------------------------------------
    # build (reference: DataProcessor::Process, dataprocessor.cc:23)
    # ------------------------------------------------------------------
    def build(self, docs: Iterable[tuple[int, list[str]]], rows_capacity: int,
              ) -> None:
        """docs: iterable of (row_id, [text per ft field])."""
        docs = list(docs)
        max_row = max((row for row, _ in docs), default=-1)
        self.total_docs = len(docs)
        cap = max(rows_capacity, max_row + 1, 1)

        # mmseg_cn segmentation lives in Python (ft/mmseg.py); the C++
        # tokenizer implements the fast splitter only
        from .mmseg import segmenter_for_config
        self._segmenter = segmenter_for_config(self.cfg)
        collected = None if self._segmenter is not None else \
            self._collect_native(docs)
        if collected is None:
            collected = self._collect_python(docs)
        if collected is not None and self.cfg.enable_numbers_search:
            collected = self._add_virtual_number_words(collected)
        if collected is None:
            self.doc_words = np.zeros(cap, dtype=np.float32)
            self.field_words = np.zeros(
                (max(len(self.field_names), 1), cap), dtype=np.int32)
            self._device = None
            return
        self.words, tok_wid, doc_arr, field_arr, pos_arr = collected
        self.vocab = {w: i for i, w in enumerate(self.words)}
        rev = sorted(range(len(self.words)),
                     key=lambda i: self.words[i][::-1])
        self.rev_words = [self.words[i][::-1] for i in rev]
        self.rev_ids = np.asarray(rev, dtype=np.int64)

        # group tokens into postings: sort by (word, doc, field, pos)
        order = np.lexsort((pos_arr, field_arr, doc_arr, tok_wid))
        w_s = tok_wid[order]
        d_s = doc_arr[order]
        f_s = field_arr[order]
        p_s = pos_arr[order]

        # posting boundaries where (word, doc, field) changes
        change = np.empty(len(w_s), dtype=bool)
        change[0] = True
        change[1:] = ((w_s[1:] != w_s[:-1]) | (d_s[1:] != d_s[:-1])
                      | (f_s[1:] != f_s[:-1]))
        starts = np.flatnonzero(change)
        counts = np.diff(np.append(starts, len(w_s)))

        self.post_doc = d_s[starts].astype(np.int32)
        self.post_field = f_s[starts].astype(np.int32)
        self.post_tf = counts.astype(np.float32)
        self.post_minpos = p_s[starts].astype(np.int32)  # pos sorted per group
        self.pos_flat = p_s.astype(np.int32)
        self.pos_start = np.concatenate(
            [starts, [len(p_s)]]).astype(np.int64)

        post_wid = w_s[starts]
        self.word_start = np.searchsorted(
            post_wid, np.arange(len(self.words) + 1)).astype(np.int64)

        # per-word distinct-doc counts (M in the idf formula)
        wd_change = np.empty(len(w_s), dtype=bool)
        wd_change[0] = True
        wd_change[1:] = (w_s[1:] != w_s[:-1]) | (d_s[1:] != d_s[:-1])
        wd_words = w_s[wd_change]
        self.word_ndocs = np.bincount(
            wd_words, minlength=len(self.words)).astype(np.int64)

        self.doc_words = np.bincount(
            doc_arr, minlength=cap).astype(np.float32)
        # per-(field, doc) word counts: fullMatchBoost applies when the
        # matched field holds exactly as many words as the query has terms
        # (reference: Merger::addFullMatchBoost, merger.h:101-109)
        nf = max(len(self.field_names), 1)
        self.field_words = np.bincount(
            field_arr.astype(np.int64) * cap + doc_arr,
            minlength=nf * cap).astype(np.int32).reshape(nf, cap)
        used = self.doc_words > 0
        self.avg_doc_len = float(self.doc_words[used].mean()) if used.any() else 1.0
        self._typo_dict = None
        self._device = None

    def _add_virtual_number_words(self, collected) -> tuple:
        """Numbers search: numeric tokens additionally index their Russian
        spelling as "virtual words" at the same (doc, field, pos)
        (reference: dataprocessor.cc:274-277 + buildVirtualWord
        :325-345, numtotext.cc). Word counts bump per virtual word, as the
        reference bumps vdocWordsCounts."""
        from .numtotext import is_number, num_to_text
        words, tok_wid, doc_arr, field_arr, pos_arr = collected
        vmap = {}
        for i, w in enumerate(words):
            if is_number(w):
                vw = num_to_text(w)
                if vw:
                    vmap[i] = vw
        if not vmap:
            return collected
        vw_all = sorted({v for vws in vmap.values() for v in vws})
        new_words = np.unique(np.concatenate(
            [words, np.asarray(vw_all, dtype=object)]))
        old_remap = np.searchsorted(new_words, words)
        vw_id = {v: int(np.searchsorted(new_words, v)) for v in vw_all}
        parts_w = [old_remap[tok_wid]]
        parts_d, parts_f, parts_p = [doc_arr], [field_arr], [pos_arr]
        for wid, vws in vmap.items():
            sel = np.flatnonzero(tok_wid == wid)
            if len(sel) == 0:
                continue
            for v in vws:
                parts_w.append(np.full(len(sel), vw_id[v], dtype=np.int64))
                parts_d.append(doc_arr[sel])
                parts_f.append(field_arr[sel])
                parts_p.append(pos_arr[sel])
        return (new_words, np.concatenate(parts_w),
                np.concatenate(parts_d), np.concatenate(parts_f),
                np.concatenate(parts_p))

    # ------------------------------------------------------------------
    # token collection: native C++ fast path with pure-Python fallback
    # ------------------------------------------------------------------
    def _collect_python(self, docs) -> Optional[tuple]:
        tokens: list[str] = []
        t_doc: list[np.ndarray] = []
        t_field: list[np.ndarray] = []
        t_pos: list[np.ndarray] = []
        # BOTH stop-word types skip indexing (reference: dataprocessor.cc
        # :259 looks up the combined map; Stop vs Morpheme only differs on
        # the query side, ftdsl.cc:224)
        stop = self.cfg.stop_words | self.cfg.morpheme_stop_words
        extra = self.cfg.extra_word_symbols
        for row, field_texts in docs:
            for f_idx, text in enumerate(field_texts):
                if not text:
                    continue
                toks = tokenize(text, extra,
                                getattr(self, "_segmenter", None))
                if stop:
                    toks = [t for t in toks if t not in stop]
                if not toks:
                    continue
                n = len(toks)
                tokens.extend(toks)
                t_doc.append(np.full(n, row, dtype=np.int32))
                t_field.append(np.full(n, f_idx, dtype=np.int32))
                t_pos.append(np.arange(n, dtype=np.int32))
        if not tokens:
            return None
        tok_arr = np.asarray(tokens, dtype=object)
        doc_arr = np.concatenate(t_doc)
        field_arr = np.concatenate(t_field)
        pos_arr = np.concatenate(t_pos)
        words, tok_wid = np.unique(tok_arr, return_inverse=True)
        return words, tok_wid.astype(np.int64), doc_arr, field_arr, pos_arr

    def _collect_native(self, docs) -> Optional[tuple]:
        """C++ tokenizer/vocab path (csrc/ft_native.cpp) — identical token
        semantics, ~an order of magnitude faster on large corpora."""
        native = _native_module()
        if native is None:
            return None
        triples = [(row, f_idx, text)
                   for row, field_texts in docs
                   for f_idx, text in enumerate(field_texts) if text]
        if not triples:
            return None
        vocab, tid_b, did_b, fid_b, pos_b = native.build_tokens(
            triples, self.cfg.extra_word_symbols)
        if not vocab:
            return None
        tok_raw = np.frombuffer(tid_b, dtype=np.int64)
        doc_arr = np.frombuffer(did_b, dtype=np.int32)
        field_arr = np.frombuffer(fid_b, dtype=np.int32)
        pos_arr = np.frombuffer(pos_b, dtype=np.int32)

        vocab_arr = np.asarray(vocab, dtype=object)
        stop = self.cfg.stop_words | self.cfg.morpheme_stop_words
        if stop:
            stop_mask = np.asarray([w in stop for w in vocab], dtype=bool)
            if stop_mask.any():
                keep = ~stop_mask[tok_raw]
                tok_raw = tok_raw[keep]
                doc_arr = doc_arr[keep]
                field_arr = field_arr[keep]
                if len(tok_raw) == 0:
                    return None
                # recompute per-(doc, field) ordinals post-filter (matches
                # the Python path, which filters before assigning positions)
                change = np.empty(len(doc_arr), dtype=bool)
                change[0] = True
                change[1:] = ((doc_arr[1:] != doc_arr[:-1])
                              | (field_arr[1:] != field_arr[:-1]))
                starts = np.flatnonzero(change)
                counts = np.diff(np.append(starts, len(doc_arr)))
                pos_arr = (np.arange(len(doc_arr), dtype=np.int32)
                           - np.repeat(starts, counts).astype(np.int32))
                # drop words now unused
                used = np.zeros(len(vocab_arr), dtype=bool)
                used[tok_raw] = True
                vocab_arr = vocab_arr[used]
                remap_used = np.cumsum(used) - 1
                tok_raw = remap_used[tok_raw]

        # native vocab is insertion-ordered; sort it (prefix search relies
        # on sorted order) and remap token ids
        order = np.argsort(vocab_arr)
        words = vocab_arr[order]
        remap = np.empty(len(order), dtype=np.int64)
        remap[order] = np.arange(len(order))
        tok_wid = remap[tok_raw]
        return words, tok_wid, doc_arr, field_arr, pos_arr

    # ------------------------------------------------------------------
    # dictionary lookups (host)
    # ------------------------------------------------------------------
    def word_id(self, word: str) -> Optional[int]:
        return self.vocab.get(word)

    def word_of(self, wid: int) -> str:
        return self.words[wid]

    def prefix_match_ids(self, prefix: str, limit: int = 512) -> list[int]:
        """Vocabulary words starting with `prefix` (suffix-array analog:
        sorted-vocab bisect; reference: estl/suffix_map.h lookups)."""
        lo = np.searchsorted(self.words, prefix)
        hi = np.searchsorted(self.words, prefix + "￿")
        return list(range(int(lo), int(min(hi, lo + limit))))

    def suffix_match_ids(self, suffix: str, limit: int = 512) -> list[int]:
        rsuf = suffix[::-1]
        lo = bisect.bisect_left(self.rev_words, rsuf)
        out = []
        for i in range(lo, len(self.rev_words)):
            if not self.rev_words[i].startswith(rsuf):
                break
            out.append(int(self.rev_ids[i]))
            if len(out) >= limit:
                break
        return out

    @property
    def typo_dict(self) -> TypoDict:
        """Lazily-built deletion dictionary (reference builds typo maps during
        commit, dataprocessor buildTyposMap; we defer to first `~` query).
        Uses the native C++ builder (csrc/typos_native.cpp) when available."""
        if self._typo_dict is None:
            td = TypoDict(
                self.cfg.max_typos, self.cfg.max_typo_len,
                max_typo_distance=self.cfg.max_typo_distance,
                max_symbol_permutation_distance=(
                    self.cfg.max_symbol_permutation_distance),
                max_missing_letters=self.cfg.max_missing_letters,
                max_extra_letters=self.cfg.max_extra_letters)
            native = _typos_native_module()
            if native is not None:
                td.map = native.build_typo_dict(
                    list(self.words), td.index_deletes, td.min_word_len,
                    td.max_typo_len, td.max_candidates)
            else:
                for wid, w in enumerate(self.words):
                    td.add_word(w, wid)
            self._typo_dict = td
        return self._typo_dict

    # ------------------------------------------------------------------
    # postings access
    # ------------------------------------------------------------------
    def native_module(self):
        """C++ FT helpers (csrc/ft_native.cpp) or None (pure-Python path)."""
        return _native_module()

    def match_positions(self, wids, doc: int, field_idx: int) -> np.ndarray:
        """Token positions of the given words in (doc, field) — the
        AreaHolder analog (reference: core/ft/areaholder.h — the merge
        carries per-doc matched positions; highlight maps them to byte
        offsets). Resolved from the positions CSR only for docs actually
        being rendered."""
        parts = []
        for wid in wids:
            s, e = self.posting_range(int(wid))
            lo = s + int(np.searchsorted(self.post_doc[s:e], doc, "left"))
            hi = s + int(np.searchsorted(self.post_doc[s:e], doc, "right"))
            for p in range(lo, hi):
                if int(self.post_field[p]) == field_idx:
                    parts.append(self.positions_of(p))
        if not parts:
            return np.empty(0, dtype=np.int32)
        return np.unique(np.concatenate(parts))

    def posting_range(self, wid: int) -> tuple[int, int]:
        return int(self.word_start[wid]), int(self.word_start[wid + 1])

    def positions_of(self, posting_idx: int) -> np.ndarray:
        s, e = self.pos_start[posting_idx], self.pos_start[posting_idx + 1]
        return self.pos_flat[s:e]

    @property
    def num_postings(self) -> int:
        return len(self.post_doc)

    def device_arrays(self) -> dict:
        """Device mirrors on self.device, padded to pow-2 buckets so the
        scorers' shapes are stable across commits."""
        if self._device is None:
            p = len(self.post_doc)
            pp = _pad_pow2(max(p, 1))
            cap = len(self.doc_words)
            capp = _pad_pow2(max(cap, 1))

            def up(a, n, dtype):
                out = np.zeros(n, dtype=dtype)
                out[: len(a)] = a
                return torch.from_numpy(out).to(self.device)

            fw = np.zeros((self.field_words.shape[0], capp), np.int32)
            fw[:, : self.field_words.shape[1]] = self.field_words
            self._device = {
                "post_doc": up(self.post_doc, pp, np.int32),
                "post_field": up(self.post_field, pp, np.int32),
                "post_tf": up(self.post_tf, pp, np.float32),
                "post_minpos": up(self.post_minpos, pp, np.int32),
                "doc_words": up(self.doc_words, capp, np.float32),
                "field_words": torch.from_numpy(fw).to(self.device),
                "cap": capp,
            }
        return self._device

    def memstat(self) -> dict:
        return {
            "words_count": len(self.words),
            "postings_count": int(self.num_postings),
            "data_size": int(self.num_postings * 16 + self.pos_flat.nbytes),
        }

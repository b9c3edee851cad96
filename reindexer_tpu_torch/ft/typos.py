"""Delete-based typo dictionary (symmetric-delete fuzzy matching).

Semantic equivalent of the reference typo engine (cpp_src/core/ft/typos.cc +
per-step typo maps in ft_fast/dataholder.h): the index side stores every
word's deletion forms (up to MaxTyposInWord = ceil(maxTypos/2) deletions,
ftconfig.h:219); the query side generates the query term's deletion forms
and intersects. Every candidate is then verified against the reference's
typo model (fulltext.md "Typos handling details" + FtTyposDetailedConfig,
ftconfig.h:186-231):

- a typo decomposes into x deletions from the query term plus y deletions
  from the dictionary word with x + y <= maxTypos (TyposHandler::Process,
  variants/typos.h:41); the typo COUNT is max(x, y) ("each letter switch
  equals to 1 typo", typos.h:82);
- the query-side surplus (x - y) is bounded by MaxExtraLetters and the
  word-side surplus (y - x) by MaxMissingLetters (typos.h:51-67;
  -1 = unlimited);
- deletions on opposite sides pair up injectively (smaller side fully
  paired); each pair must satisfy |posT - posW| <= MaxTypoDistance
  (positions corrected by earlier same-side deletions, -1 = unlimited,
  checkMaxTyposDist) OR have EQUAL deleted characters within
  MaxSymbolPermutationDistance (switched letters, checkMaxLettPermDist).
"""
from __future__ import annotations

import itertools
from typing import Iterable, Optional


def deletions(word: str, max_deletes: int = 1) -> set[str]:
    """All forms of `word` with up to `max_deletes` single-char deletions
    (excluding the word itself)."""
    forms = {word}
    frontier = {word}
    for _ in range(max_deletes):
        nxt = set()
        for w in frontier:
            for i in range(len(w)):
                nxt.add(w[:i] + w[i + 1:])
        frontier = nxt - forms
        forms |= nxt
    forms.discard(word)
    return forms


def _del_sets(s: str, k: int) -> Iterable[tuple[int, ...]]:
    return itertools.combinations(range(len(s)), k)


def _is_subseq(small: str, big: str) -> bool:
    """small is obtainable from big by deletions only."""
    it = iter(big)
    return all(c in it for c in small)


_MISS = object()


def _apply(s: str, dels: tuple[int, ...]) -> str:
    if not dels:
        return s
    keep = [c for i, c in enumerate(s) if i not in dels]
    return "".join(keep)


class TypoDict:
    """deletion-form -> word ids map built at FT commit."""

    def __init__(self, max_typos: int = 2, max_typo_len: int = 15,
                 min_word_len: int = 3, max_candidates: int = 64,
                 max_typo_distance: int = 0,
                 max_symbol_permutation_distance: int = 1,
                 max_missing_letters: int = 2,
                 max_extra_letters: int = 2):
        # deletions per word on the index side (reference MaxTyposInWord)
        self.index_deletes = (max_typos // 2) + (max_typos % 2)
        self.max_typos = max_typos
        self.max_typo_len = max_typo_len
        self.min_word_len = min_word_len
        self.max_candidates = max_candidates
        self.max_typo_distance = max_typo_distance
        self.max_perm_distance = max_symbol_permutation_distance
        # surplus bounds; -1 = unlimited (ftconfig.h:220-223 accessors)
        self.max_missing = (max_missing_letters if max_missing_letters >= 0
                            else self.index_deletes)
        self.max_extra = (max_extra_letters if max_extra_letters >= 0
                          else self.index_deletes)
        self.map: dict[str, list[int]] = {}
        self._verify_cache: dict[tuple[str, str], Optional[int]] = {}

    def add_word(self, word: str, word_id: int) -> None:
        if not (self.min_word_len <= len(word) <= self.max_typo_len):
            return
        for form in deletions(word, self.index_deletes):
            lst = self.map.setdefault(form, [])
            if len(lst) < self.max_candidates:
                lst.append(word_id)

    # --- verification (reference typo model) ----------------------------
    def _pair_ok(self, pt: int, ct: str, pw: int, cw: str) -> bool:
        """checkMaxTyposDist OR (equal chars) checkMaxLettPermDist."""
        if (self.max_typo_distance < 0
                or abs(pt - pw) <= self.max_typo_distance):
            return True
        return ct == cw and (self.max_perm_distance < 0
                             or abs(pt - pw) <= self.max_perm_distance)

    @staticmethod
    def _corrected(s: str, dels: tuple[int, ...]) -> list[tuple[int, str]]:
        """(position corrected by earlier same-side deletions, deleted char)
        — the reference compares `foundRight - 1` style shifted positions
        (variants/typos.cc:25-30,95-97)."""
        return [(p - k, s[p]) for k, p in enumerate(sorted(dels))]

    def _pairing_ok(self, term: str, word: str,
                    dels_t: tuple[int, ...], dels_w: tuple[int, ...]) -> bool:
        """Opposite-side deletions pair injectively (smaller side fully
        paired, leftovers are pure missing/extra); every pair must pass
        _pair_ok under some assignment (checkMaxTyposDist/LettPermDist
        case tables generalized)."""
        a = self._corrected(term, dels_t)
        b = self._corrected(word, dels_w)
        if len(a) > len(b):
            a, b = b, a
        if not a:
            return True
        for chosen in itertools.permutations(b, len(a)):
            if all(self._pair_ok(pa, ca, pb, cb)
                   for (pa, ca), (pb, cb) in zip(a, chosen)):
                return True
        return False

    def typo_count(self, term: str, word: str) -> Optional[int]:
        """Minimal max(x, y) over valid deletion alignments, or None
        (reference tcount, variants/typos.h:82). Memoized per dict —
        words repeat across query terms and candidate forms."""
        if term == word:
            return 0
        hit = self._verify_cache.get((term, word), _MISS)
        if hit is not _MISS:
            return hit
        out = self._typo_count_impl(term, word)
        if len(self._verify_cache) >= 100_000:
            self._verify_cache.clear()
        self._verify_cache[(term, word)] = out
        return out

    def _typo_count_impl(self, term: str, word: str) -> Optional[int]:
        dlen = len(word) - len(term)
        # (tcount, x, y) candidates ordered cheapest-count first
        cands = []
        for x in range(self.index_deletes + 1):
            y = x + dlen
            if y < 0 or y > self.index_deletes or x + y > self.max_typos \
                    or x + y == 0:
                continue
            if x - y > self.max_extra or y - x > self.max_missing:
                continue
            cands.append((max(x, y), x, y))
        for tcount, x, y in sorted(cands):
            if x == 0:
                # pure missing letters: no opposite-side pair to check
                if _is_subseq(term, word):
                    return tcount
            elif y == 0:
                # pure extra letters
                if _is_subseq(word, term):
                    return tcount
            else:
                for dels_t in _del_sets(term, x):
                    tstr = _apply(term, dels_t)
                    for dels_w in _del_sets(word, y):
                        if tstr != _apply(word, dels_w):
                            continue
                        if self._pairing_ok(term, word, dels_t, dels_w):
                            return tcount
        return None

    def candidates(self, term: str, vocab_get, word_of_id) -> dict[int, int]:
        """word_id -> typo count for words within maxTypos of `term`.

        vocab_get(form) -> word_id|None resolves exact dictionary words;
        word_of_id(word_id) -> str for verification.
        """
        if not (self.min_word_len <= len(term) <= self.max_typo_len):
            return {}
        cand: set[int] = set()
        # query term == indexed word's deletion (extra letters in doc)
        cand.update(self.map.get(term, ()))
        term_forms = deletions(term, self.index_deletes)
        for form in term_forms:
            # query deletion == indexed word (missing letters in doc)
            wid = vocab_get(form)
            if wid is not None:
                cand.add(wid)
            # deletion == deletion (changed/switched symbols)
            if self.max_typos >= 2:
                cand.update(self.map.get(form, ()))
        out: dict[int, int] = {}
        for wid in cand:
            n = self.typo_count(term, word_of_id(wid))
            if n is not None and 0 < n <= self.max_typos:
                out[wid] = n
        return out

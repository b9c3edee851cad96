"""Query-term variant generators: transliteration, keyboard layout, synonyms.

Semantic equivalents of the reference's variant expanders
(cpp_src/core/ft/variants/: Translit ru<->en, KbLayout qwerty<->jcuken,
Synonyms multi-word; applied in Selector::prepareVariants,
selecterimpl.h:477-607). Each produced variant carries a base relevancy proc
from FtSubTermProcs (config.py).
"""
from __future__ import annotations

from typing import Iterable, Optional

# GOST-style ru -> latin transliteration (multi-char targets), as used for
# search-variant generation (reference: ft/variants/translit)
_RU2EN = {
    "а": "a", "б": "b", "в": "v", "г": "g", "д": "d", "е": "e", "ё": "yo",
    "ж": "zh", "з": "z", "и": "i", "й": "j", "к": "k", "л": "l", "м": "m",
    "н": "n", "о": "o", "п": "p", "р": "r", "с": "s", "т": "t", "у": "u",
    "ф": "f", "х": "h", "ц": "c", "ч": "ch", "ш": "sh", "щ": "sch",
    "ъ": "", "ы": "y", "ь": "", "э": "e", "ю": "yu", "я": "ya",
}
# longest-match-first latin -> ru
_EN2RU = [("sch", "щ"), ("yo", "ё"), ("zh", "ж"), ("ch", "ч"), ("sh", "ш"),
          ("yu", "ю"), ("ya", "я"), ("a", "а"), ("b", "б"), ("v", "в"),
          ("g", "г"), ("d", "д"), ("e", "е"), ("z", "з"), ("i", "и"),
          ("j", "й"), ("k", "к"), ("l", "л"), ("m", "м"), ("n", "н"),
          ("o", "о"), ("p", "п"), ("r", "р"), ("s", "с"), ("t", "т"),
          ("u", "у"), ("f", "ф"), ("h", "х"), ("c", "ц"), ("y", "ы"),
          ("w", "в"), ("q", "к"), ("x", "кс")]

# qwerty <-> jcuken physical-key mapping (reference: ft/variants/kblayout)
_QWERTY = "qwertyuiop[]asdfghjkl;'zxcvbnm,."
_JCUKEN = "йцукенгшщзхъфывапролджэячсмитьбю"
_KB_EN2RU = {a: b for a, b in zip(_QWERTY, _JCUKEN)}
_KB_RU2EN = {b: a for a, b in zip(_QWERTY, _JCUKEN)}


def translit_variants(term: str) -> list[str]:
    """ru->en and en->ru transliterations of a term (both directions tried;
    only variants that actually change the term are returned)."""
    out = []
    if any("а" <= c <= "я" or c == "ё" for c in term):
        t = "".join(_RU2EN.get(c, c) for c in term)
        if t and t != term:
            out.append(t)
    else:
        t = term
        res = []
        i = 0
        while i < len(t):
            for pat, rep in _EN2RU:
                if t.startswith(pat, i):
                    res.append(rep)
                    i += len(pat)
                    break
            else:
                res.append(t[i])
                i += 1
        t2 = "".join(res)
        if t2 and t2 != term:
            out.append(t2)
    return out


def kblayout_variants(term: str) -> list[str]:
    """Keyboard-layout correction both ways (reference: KbLayout)."""
    out = []
    en = "".join(_KB_RU2EN.get(c, c) for c in term)
    if en != term:
        out.append(en)
    ru = "".join(_KB_EN2RU.get(c, c) for c in term)
    if ru != term:
        out.append(ru)
    return out


class SynonymsMap:
    """Synonym expansion incl. multi-word token sequences
    (reference: ft/variants/synonyms; config FTConfig::Synonym)."""

    def __init__(self, synonyms: Iterable) -> None:
        self.single: dict[str, list[str]] = {}
        self.multi: list[tuple[tuple[str, ...], list[str]]] = []
        for syn in synonyms:
            tokens = tuple(syn.tokens)
            if not tokens or not syn.alternatives:
                continue
            if len(tokens) == 1:
                self.single.setdefault(tokens[0], []).extend(syn.alternatives)
            else:
                self.multi.append((tokens, list(syn.alternatives)))

    def for_term(self, term: str) -> list[str]:
        return self.single.get(term, [])

    def multi_matches(self, terms: list[str]) -> list[tuple[int, int, list[str]]]:
        """Find multi-word synonym spans in a term sequence; returns
        (start, end, alternatives) triples."""
        out = []
        for tokens, alts in self.multi:
            n = len(tokens)
            for i in range(0, len(terms) - n + 1):
                if tuple(terms[i:i + n]) == tokens:
                    out.append((i, i + n, alts))
        return out

"""Snowball stemmers (en/ru) for query-side stem variants.

The reference uses vendored libstemmer (cpp_src/core/ft/stemmer.h,
vendor/libstemmer/) with en+ru enabled by default (ftconfig.h:156). These are
pure-Python implementations of the same public Snowball algorithms
(snowballstem.org: "The English (Porter2) stemming algorithm", "The Russian
stemming algorithm"); stems are used as *prefix* searches at query time
(reference: selecterimpl.h stem variants marked suff/prefix), so mild
deviations only shift recall, not correctness.
"""
from __future__ import annotations

from typing import Callable, Optional

_VOWELS_EN = "aeiouy"


def _r_regions_en(word: str) -> tuple[int, int]:
    # special prefixes per Porter2 spec
    for pre in ("gener", "commun", "arsen"):
        if word.startswith(pre):
            r1 = len(pre)
            break
    else:
        r1 = len(word)
        for i in range(1, len(word)):
            if word[i] not in _VOWELS_EN and word[i - 1] in _VOWELS_EN:
                r1 = i + 1
                break
    r2 = len(word)
    for i in range(r1 + 1, len(word)):
        if word[i] not in _VOWELS_EN and word[i - 1] in _VOWELS_EN:
            r2 = i + 1
            break
    return r1, r2


def _is_short_syllable(w: str, i: int) -> bool:
    if i == 0:
        return len(w) >= 2 and w[0] in _VOWELS_EN and w[1] not in _VOWELS_EN
    return (w[i] in _VOWELS_EN and i + 1 < len(w)
            and w[i + 1] not in _VOWELS_EN and w[i + 1] not in "wxy"
            and w[i - 1] not in _VOWELS_EN)


def _is_short(w: str, r1: int) -> bool:
    return r1 >= len(w) and _is_short_syllable(w, len(w) - 2)


_EXCEPTIONS1 = {
    "skis": "ski", "skies": "sky", "dying": "die", "lying": "lie",
    "tying": "tie", "idly": "idl", "gently": "gentl", "ugly": "ugli",
    "early": "earli", "only": "onli", "singly": "singl", "sky": "sky",
    "news": "news", "howe": "howe", "atlas": "atlas", "cosmos": "cosmos",
    "bias": "bias", "andes": "andes",
}
_EXCEPTIONS2 = {"inning", "outing", "canning", "herring", "earring",
                "proceed", "exceed", "succeed"}

_STEP2_EN = [
    ("ization", "ize"), ("ational", "ate"), ("fulness", "ful"),
    ("ousness", "ous"), ("iveness", "ive"), ("tional", "tion"),
    ("biliti", "ble"), ("lessli", "less"), ("entli", "ent"), ("ation", "ate"),
    ("alism", "al"), ("aliti", "al"), ("ousli", "ous"), ("iviti", "ive"),
    ("fulli", "ful"), ("enci", "ence"), ("anci", "ance"), ("abli", "able"),
    ("izer", "ize"), ("ator", "ate"), ("alli", "al"), ("bli", "ble"),
]
_STEP3_EN = [("ational", "ate"), ("tional", "tion"), ("alize", "al"),
             ("icate", "ic"), ("iciti", "ic"), ("ical", "ic"),
             ("ful", ""), ("ness", "")]
_STEP4_EN = ["ement", "ance", "ence", "able", "ible", "ment",
             "ant", "ent", "ism", "ate", "iti", "ous", "ive", "ize",
             "ion", "al", "er", "ic"]


def stem_en(word: str) -> str:
    """Porter2 / Snowball English stemmer."""
    w = word.lower()
    if len(w) <= 2:
        return w
    if w in _EXCEPTIONS1:
        return _EXCEPTIONS1[w]
    w = w.replace("'", "")
    if w.startswith("y"):
        w = "Y" + w[1:]
    chars = list(w)
    for i in range(1, len(chars)):
        if chars[i] == "y" and chars[i - 1] in _VOWELS_EN:
            chars[i] = "Y"
    w = "".join(chars)
    r1, r2 = _r_regions_en(w.lower())

    # step 0
    for suf in ("'s'", "'s", "'"):
        if w.endswith(suf):
            w = w[: -len(suf)]
            break
    # step 1a
    if w.endswith("sses"):
        w = w[:-2]
    elif w.endswith("ied") or w.endswith("ies"):
        w = w[:-2] if len(w) > 4 else w[:-1]
    elif w.endswith("ss") or w.endswith("us"):
        pass
    elif w.endswith("s") and len(w) > 2:
        if any(c.lower() in _VOWELS_EN for c in w[:-2]):
            w = w[:-1]
    if w.lower() in _EXCEPTIONS2:
        return w.lower()
    # step 1b
    done1b = False
    for suf in ("eedly", "eed"):
        if w.endswith(suf):
            if len(w) - len(suf) >= r1:
                w = w[: -len(suf)] + "ee"
            done1b = True
            break
    if not done1b:
        for suf in ("ingly", "edly", "ing", "ed"):
            if w.endswith(suf):
                stem = w[: -len(suf)]
                if any(c.lower() in _VOWELS_EN for c in stem):
                    w = stem
                    if w.endswith(("at", "bl", "iz")):
                        w += "e"
                    elif len(w) >= 2 and w[-1] == w[-2] and w[-1] in "bdfgmnprt":
                        w = w[:-1]
                    elif _is_short(w.lower(), r1):
                        w += "e"
                break
    # step 1c
    if len(w) > 2 and w[-1] in "yY" and w[-2].lower() not in _VOWELS_EN:
        w = w[:-1] + "i"
    # step 2
    for suf, rep in _STEP2_EN:
        if w.endswith(suf):
            if len(w) - len(suf) >= r1:
                w = w[: -len(suf)] + rep
            break
    else:
        if w.endswith("ogi") and len(w) - 3 >= r1 and len(w) >= 4 and w[-4] == "l":
            w = w[:-1]
        elif w.endswith("li") and len(w) - 2 >= r1 and len(w) >= 3 \
                and w[-3] in "cdeghkmnrt":
            w = w[:-2]
    # step 3
    for suf, rep in _STEP3_EN:
        if w.endswith(suf):
            if len(w) - len(suf) >= r1:
                w = w[: -len(suf)] + rep
            break
    else:
        if w.endswith("ative") and len(w) - 5 >= r2:
            w = w[:-5]
    # step 4
    for suf in _STEP4_EN:
        if w.endswith(suf):
            if len(w) - len(suf) >= r2:
                if suf == "ion":
                    if len(w) >= 4 and w[-4] in "st":
                        w = w[:-3]
                else:
                    w = w[: -len(suf)]
            break
    # step 5
    if w.endswith("e"):
        stem = w[:-1]
        if len(w) - 1 >= r2 or (len(w) - 1 >= r1
                                and not _is_short_syllable(stem.lower(),
                                                           len(stem) - 2)):
            w = stem
    elif w.endswith("ll") and len(w) - 1 >= r2:
        w = w[:-1]
    return w.lower()


# --- Russian (Snowball) ----------------------------------------------------
_VOWELS_RU = "аеиоуыэюя"
_PERFECTIVE_GERUND_1 = ("вшись", "вши", "в")           # require а/я before
_PERFECTIVE_GERUND_2 = ("ившись", "ывшись", "ивши", "ывши", "ив", "ыв")
_ADJECTIVE = ("ими", "ыми", "его", "ого", "ему", "ому", "ее", "ие", "ые",
              "ое", "ей", "ий", "ый", "ой", "ем", "им", "ым", "ом", "их",
              "ых", "ую", "юю", "ая", "яя", "ою", "ею")
_PARTICIPLE_1 = ("ем", "нн", "вш", "ющ", "щ")          # require а/я before
_PARTICIPLE_2 = ("ивш", "ывш", "ующ")
_REFLEXIVE = ("ся", "сь")
_VERB_1 = ("ла", "на", "ете", "йте", "ли", "й", "л", "ем", "н", "ло", "но",
           "ет", "ют", "ны", "ть", "ешь", "нно")       # require а/я before
_VERB_2 = ("ила", "ыла", "ена", "ейте", "уйте", "ите", "или", "ыли", "ей",
           "уй", "ил", "ыл", "им", "ым", "ен", "ило", "ыло", "ено", "ят",
           "ует", "уют", "ит", "ыт", "ены", "ить", "ыть", "ишь", "ую", "ю")
_NOUN = ("иями", "ями", "ами", "ией", "иям", "ием", "иях", "ия", "ьев",
         "ев", "ов", "ие", "ье", "еи", "ии", "и", "ией", "ей", "ой", "ий",
         "й", "иям", "ям", "ием", "ем", "ам", "ом", "о", "у", "ах", "иях",
         "ях", "ы", "ь", "ию", "ью", "ю", "ия", "ья", "я", "а", "е")
_SUPERLATIVE = ("ейше", "ейш")
_DERIVATIONAL = ("ость", "ост")


def _longest(word: str, sufs: tuple[str, ...], require_ay: bool = False,
             ) -> Optional[str]:
    best = None
    for s in sufs:
        if word.endswith(s) and (best is None or len(s) > len(best)):
            if require_ay:
                i = len(word) - len(s) - 1
                if i < 0 or word[i] not in "ая":
                    continue
            best = s
    return best


def stem_ru(word: str) -> str:
    """Snowball Russian stemmer."""
    w = word.lower().replace("ё", "е")
    # RV: after first vowel; R2 via standard regions
    rv = len(w)
    for i, ch in enumerate(w):
        if ch in _VOWELS_RU:
            rv = i + 1
            break
    r1 = len(w)
    for i in range(1, len(w)):
        if w[i] not in _VOWELS_RU and w[i - 1] in _VOWELS_RU:
            r1 = i + 1
            break
    r2 = len(w)
    for i in range(r1 + 1, len(w)):
        if w[i] not in _VOWELS_RU and w[i - 1] in _VOWELS_RU:
            r2 = i + 1
            break

    def ends_in_rv(s: str) -> bool:
        return len(w) - len(s) >= rv

    # step 1: perfective gerund, else adjectival / reflexive+verb / noun
    s = _longest(w, _PERFECTIVE_GERUND_2)
    if s and ends_in_rv(s):
        w = w[: -len(s)]
    else:
        s = _longest(w, _PERFECTIVE_GERUND_1, require_ay=True)
        if s and ends_in_rv(s):
            w = w[: -len(s)]
        else:
            s = _longest(w, _REFLEXIVE)
            if s and ends_in_rv(s):
                w = w[: -len(s)]
            # adjectival
            s = _longest(w, _ADJECTIVE)
            if s and ends_in_rv(s):
                w = w[: -len(s)]
                p = _longest(w, _PARTICIPLE_2)
                if p and ends_in_rv(p):
                    w = w[: -len(p)]
                else:
                    p = _longest(w, _PARTICIPLE_1, require_ay=True)
                    if p and ends_in_rv(p):
                        w = w[: -len(p)]
            else:
                s = _longest(w, _VERB_2)
                if s and ends_in_rv(s):
                    w = w[: -len(s)]
                else:
                    s = _longest(w, _VERB_1, require_ay=True)
                    if s and ends_in_rv(s):
                        w = w[: -len(s)]
                    else:
                        s = _longest(w, _NOUN)
                        if s and ends_in_rv(s):
                            w = w[: -len(s)]
    # step 2: и
    if w.endswith("и") and len(w) - 1 >= rv:
        w = w[:-1]
    # step 3: derivational in R2
    s = _longest(w, _DERIVATIONAL)
    if s and len(w) - len(s) >= r2:
        w = w[: -len(s)]
    # step 4
    if w.endswith("нн") and len(w) - 1 >= rv:
        w = w[:-1]
    else:
        s = _longest(w, _SUPERLATIVE)
        if s and len(w) - len(s) >= rv:
            w = w[: -len(s)]
            if w.endswith("нн") and len(w) - 1 >= rv:
                w = w[:-1]
    if w.endswith("ь") and len(w) - 1 >= rv:
        w = w[:-1]
    return w


STEMMERS: dict[str, Callable[[str], str]] = {"en": stem_en, "ru": stem_ru}


def get_stemmer(lang: str) -> Optional[Callable[[str], str]]:
    return STEMMERS.get(lang)

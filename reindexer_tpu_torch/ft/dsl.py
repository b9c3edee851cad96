"""Full-text query DSL parser.

Parses the reference text-query format (spec: fulltext.md:105-139; reference
implementation cpp_src/core/ft/ftdsl.cc):

    [@[+]field[^boost][,field2[^boost]]]  [=][*]term[*][~][^boost]
    [+|-][*]term2[*][~][^boost]  "phrase words"[~N] ...

- `*` prefix/suffix wildcard, `~` typo tolerance, `=` exact (no stemming),
  `^x` term boost, `+`/`-` must/must-not, `\\` escapes specials,
  `@f1^2,f2` field list with boosts (`+f` marks rank-summable fields),
  `"w1 w2"~N` phrase with max word distance N.
Term-length boost = len(pattern)/max_pattern_len (reference: ftdsl.cc:250).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from ..core.errors import QueryError

_SPECIALS = set("+-@*^~=,\"\\")


@dataclasses.dataclass
class FtTerm:
    """One search pattern with options (reference: FtDSLEntry, ftdsl.h:106)."""

    pattern: str
    op: str = "or"               # or | must(+) | not(-)
    prefix: bool = False         # term*
    suffix: bool = False         # *term
    exact: bool = False          # =term -> no stem/typo variants
    typos: bool = False          # term~
    boost: float = 1.0
    term_len_boost: float = 1.0
    # phrase membership: terms inside "..." share a phrase group id
    phrase_group: int = -1
    phrase_pos: int = 0


@dataclasses.dataclass
class FtField:
    name: str
    boost: float = 1.0
    sum_rank: bool = False       # +field (SumRanksByFieldsRatio participant)


@dataclasses.dataclass
class FtDslQuery:
    terms: list[FtTerm] = dataclasses.field(default_factory=list)
    fields: list[FtField] = dataclasses.field(default_factory=list)  # empty = all
    # phrase groups: group id -> max word distance (default 1)
    phrase_distance: dict[int, int] = dataclasses.field(default_factory=dict)


def _read_boost(s: str, i: int) -> tuple[float, int]:
    if i < len(s) and s[i] == "^":
        j = i + 1
        while j < len(s) and (s[j].isdigit() or s[j] in ".-"):
            j += 1
        try:
            return float(s[i + 1: j]), j
        except ValueError:
            raise QueryError(f"bad boost value in FT DSL near '{s[i:j]}'")
    return 1.0, i


def _read_word(s: str, i: int) -> tuple[str, int]:
    out = []
    while i < len(s):
        c = s[i]
        if c == "\\" and i + 1 < len(s):
            out.append(s[i + 1])
            i += 2
            continue
        if c.isspace() or c in _SPECIALS:
            break
        out.append(c)
        i += 1
    return "".join(out), i


def parse_ft_dsl(dsl: str) -> FtDslQuery:
    q = FtDslQuery()
    s = dsl.strip()
    i = 0
    phrase_counter = 0
    while i < len(s):
        c = s[i]
        if c.isspace() or c == ",":
            i += 1
            continue
        if c == "@":
            # field list: @f1^2,+f2,f3  or  @* (all fields)
            i += 1
            while i < len(s) and not s[i].isspace():
                sum_rank = False
                if s[i] == "+":
                    sum_rank = True
                    i += 1
                if i < len(s) and s[i] == "*":
                    name, i = "*", i + 1
                else:
                    name, i = _read_word(s, i)
                boost, i = _read_boost(s, i)
                if name:
                    q.fields.append(FtField(name, boost, sum_rank))
                if i < len(s) and s[i] == ",":
                    i += 1
                else:
                    break
            continue
        op = "or"
        if c == "+":
            op = "must"
            i += 1
        elif c == "-":
            op = "not"
            i += 1
        if i < len(s) and s[i] == '"':
            # phrase
            i += 1
            j = s.find('"', i)
            if j < 0:
                raise QueryError("unterminated phrase in FT DSL")
            words = s[i:j].split()
            i = j + 1
            dist = 1
            if i < len(s) and s[i] == "~":
                k = i + 1
                while k < len(s) and s[k].isdigit():
                    k += 1
                dist = int(s[i + 1: k] or "1")
                i = k
            boost, i = _read_boost(s, i)
            gid = phrase_counter
            phrase_counter += 1
            q.phrase_distance[gid] = dist
            for pi, w in enumerate(words):
                q.terms.append(FtTerm(
                    pattern=w.lower(), op="must" if op != "not" else "not",
                    boost=boost, phrase_group=gid, phrase_pos=pi))
            continue
        exact = False
        if i < len(s) and s[i] == "=":
            exact = True
            i += 1
        suffix = False
        if i < len(s) and s[i] == "*":
            suffix = True
            i += 1
        word, i = _read_word(s, i)
        prefix = False
        if i < len(s) and s[i] == "*":
            prefix = True
            i += 1
        typos = False
        if i < len(s) and s[i] == "~":
            typos = True
            i += 1
        boost, i = _read_boost(s, i)
        if not word:
            i += 1
            continue
        q.terms.append(FtTerm(pattern=word.lower(), op=op, prefix=prefix,
                              suffix=suffix, exact=exact, typos=typos,
                              boost=boost))
    if not q.terms:
        return q
    max_len = max(len(t.pattern) for t in q.terms)
    for t in q.terms:
        t.term_len_boost = len(t.pattern) / max_len if max_len else 1.0
    return q

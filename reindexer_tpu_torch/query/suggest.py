"""Port of reindexer_tpu/query/suggest.py: a copy of the reference's module
(host only; the same wire format).

The reference's notes follow.

SQL autocompletion (reference: GetSQLSuggest route,
cpp_src/core/query/sql/sqlsuggester.cc): given a partial SQL string and
cursor position, propose keywords, namespace names, and index names."""
from __future__ import annotations

import re
from typing import Optional

_KEYWORDS = [
    "SELECT", "FROM", "WHERE", "ORDER BY", "LIMIT", "OFFSET", "AND", "OR",
    "NOT", "IN", "RANGE", "LIKE", "IS NULL", "IS NOT NULL", "JOIN",
    "INNER JOIN", "LEFT JOIN", "ON", "MERGE", "UPDATE", "SET", "DELETE",
    "TRUNCATE", "EXPLAIN", "KNN", "COUNT", "SUM", "AVG", "MIN", "MAX",
    "FACET", "DISTINCT", "ASC", "DESC",
]


def suggest(db, sql: str, pos: Optional[int] = None) -> list[str]:
    if pos is None:
        pos = len(sql)
    head = sql[:pos]
    m = re.search(r"([\w#*.]*)$", head)
    prefix = m.group(1) if m else ""
    before = head[: len(head) - len(prefix)].rstrip().lower()

    candidates: list[str] = []
    last_word = before.split()[-1] if before.split() else ""
    if last_word in ("from", "update", "truncate", "join"):
        candidates = db.namespace_names()
    elif last_word in ("where", "and", "or", "not", "by", "set", "on"):
        ns = _current_ns(db, before)
        if ns is not None:
            candidates = [d.name for d in ns.index_defs()]
        candidates += _KEYWORDS
    else:
        candidates = list(_KEYWORDS) + db.namespace_names()

    p = prefix.lower()
    out = [c for c in candidates if c.lower().startswith(p)] if p else candidates
    seen, uniq = set(), []
    for c in out:
        if c not in seen:
            seen.add(c)
            uniq.append(c)
    return uniq[:32]


def _current_ns(db, before: str):
    m = re.search(r"\bfrom\s+([\w#]+)", before) or \
        re.search(r"\bupdate\s+([\w#]+)", before)
    if not m:
        return None
    try:
        return db.get_namespace(m.group(1))
    except Exception:
        return None

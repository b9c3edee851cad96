"""FT select functions: highlight(), snippet(), snippet_n(), debug_rank().

Semantic equivalents of the reference's select functions
(cpp_src/core/ft/functions/: highlight.cc, snippet.cc, ft_function.cc)
applied to result items.

Source-offset fidelity (reference: ft/areaholder.h — the merge carries
per-doc matched AREAS): for FT-indexed fields the matched token POSITIONS
resolve from the postings' positions CSR (RankSource.area_sources ->
FtDataHolder.match_positions), and highlight maps positions to char spans
by re-tokenizing only the rendered page with the exact index tokenization
(stop words skipped without consuming a position). A word that matched in
field A therefore does NOT highlight in field B, mirroring the reference's
per-field areas. Non-FT-indexed display fields fall back to matched-word
set highlighting.

Function string format mirrors the Go connector (query.go Functions()):
    field = highlight(<b>,</b>)
    field = snippet(<b>,</b>,5,5[,delim])
"""
from __future__ import annotations

import re
from typing import Optional

from ..core.errors import QueryError
from ..core.payload import get_json_path, set_json_path
from .tokenizer import tokenize_with_offsets

_FN_RE = re.compile(
    r"^\s*(?P<field>[\w.]+)\s*=\s*(?P<fn>\w+)\s*\((?P<args>.*)\)\s*$", re.S)


def _split_args(argstr: str) -> list[str]:
    """Split on commas, honoring single quotes (reference: ft function arg
    parser)."""
    out, cur, in_q = [], [], False
    for c in argstr:
        if c == "'":
            in_q = not in_q
            continue
        if c == "," and not in_q:
            out.append("".join(cur))
            cur = []
            continue
        cur.append(c)
    if cur or out:
        out.append("".join(cur))
    return out


def apply_select_function(ns, fn_str: str, items: list,
                          sources: dict) -> None:
    m = _FN_RE.match(fn_str)
    if not m:
        raise QueryError(f"bad select function: '{fn_str}'")
    field, fn, args = m.group("field"), m.group("fn").lower(), \
        _split_args(m.group("args"))

    matched: set = set()
    area_sources: list = []
    for src in sources.values():
        mw = getattr(src, "matched_words", None)
        if mw:
            matched |= mw
        asrc = getattr(src, "area_sources", None)
        if asrc:
            area_sources.extend(asrc)
    if not matched:
        return

    def spans_of(it, text):
        """Positionally-exact spans from the areas when the field is
        FT-indexed (areaholder.h semantics); word-set spans otherwise."""
        positional = False
        positions: set = set()
        cfg = None
        for holder, wids, searched in area_sources:
            if field in holder.field_names and wids:
                positional = True
                cfg = holder.cfg
                f_idx = holder.field_names.index(field)
                if searched is not None and f_idx not in searched:
                    continue        # field not targeted by the query
                pos = holder.match_positions(wids, int(it.row_id), f_idx)
                positions.update(int(p) for p in pos)
        if not positional:
            return _match_spans(text, matched)
        return _match_spans_positional(text, positions, cfg)

    if fn == "highlight":
        if len(args) < 2:
            raise QueryError("highlight(pre, post) requires 2 arguments")
        pre, post = args[0], args[1]
        for it in items:
            text = get_json_path(it.doc, field)
            if isinstance(text, str):
                set_json_path(it.doc, field,
                              _highlight(text, pre, post,
                                         spans_of(it, text)))
    elif fn in ("snippet", "snippet_n"):
        if len(args) < 4:
            raise QueryError(
                "snippet(pre, post, before, after[, delim]) requires >=4 args")
        pre, post = args[0], args[1]
        before, after = int(float(args[2])), int(float(args[3]))
        delim = args[4] if len(args) > 4 else " "
        for it in items:
            text = get_json_path(it.doc, field)
            if isinstance(text, str):
                set_json_path(it.doc, field,
                              _snippet(text, pre, post, before,
                                       after, delim, spans_of(it, text)))
    elif fn == "debug_rank":
        for it in items:
            if it.rank is not None:
                set_json_path(it.doc, "_debug_rank", float(it.rank))
    else:
        raise QueryError(f"unknown select function '{fn}'")


def _match_spans(text: str, matched: set) -> list[tuple[int, int]]:
    spans = []
    for tok, s, e in tokenize_with_offsets(text):
        if tok in matched:
            spans.append((s, e))
    return spans


def _match_spans_positional(text: str, positions: set,
                            cfg) -> list[tuple[int, int]]:
    """Char spans of the tokens at the given index positions — the index
    numbered kept (non-stop) tokens per field, so stop tokens are skipped
    without consuming a position (dataholder._collect_python)."""
    if not positions:
        return []
    from .mmseg import segmenter_for_config
    extra = cfg.extra_word_symbols if cfg else "-/+_`'"
    stop = ((cfg.stop_words | cfg.morpheme_stop_words) if cfg else ())
    seg = segmenter_for_config(cfg) if cfg else None
    spans = []
    p = 0
    for tok, s, e in tokenize_with_offsets(text, extra, seg):
        if stop and tok in stop:
            continue
        if p in positions:
            spans.append((s, e))
        p += 1
    return spans


def _highlight(text: str, pre: str, post: str,
               spans: list[tuple[int, int]]) -> str:
    if not spans:
        return text
    out, last = [], 0
    for s, e in spans:
        out.append(text[last:s])
        out.append(pre)
        out.append(text[s:e])
        out.append(post)
        last = e
    out.append(text[last:])
    return "".join(out)


def _snippet(text: str, pre: str, post: str,
             before: int, after: int, delim: str,
             spans: list[tuple[int, int]],
             max_areas: int = 5) -> str:
    if not spans:
        return ""
    # merge overlapping context windows (reference: areas merge,
    # ft/areaholder.h)
    areas: list[list[int]] = []
    for s, e in spans:
        lo, hi = max(0, s - before), min(len(text), e + after)
        if areas and lo <= areas[-1][1]:
            areas[-1][1] = max(areas[-1][1], hi)
            areas[-1][2].append((s, e))
        else:
            if len(areas) >= max_areas:
                break
            areas.append([lo, hi, [(s, e)]])
    parts = []
    for lo, hi, sps in areas:
        seg = []
        last = lo
        for s, e in sps:
            seg.append(text[last:s])
            seg.append(pre)
            seg.append(text[s:e])
            seg.append(post)
            last = e
        seg.append(text[last:hi])
        parts.append("".join(seg))
    return delim.join(parts)

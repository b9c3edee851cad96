"""Fast word splitter for the full-text engine.

Semantic equivalent of the reference's UTF-8 splitter
(cpp_src/core/ft/ft_fast/splitter.cc, tools/stringstools.cc word split with
`kDefaultExtraWordsSymbols = "-/+_`'"`): a word is a run of unicode
letters/digits plus the configured extra symbols; tokens are lower-cased.
Regex-based so the split rides C speed on host; the C++ native splitter
(csrc/) replaces this on the hot build path when available.
"""
from __future__ import annotations

import functools
import re
from typing import Iterable, Iterator


@functools.lru_cache(maxsize=32)
def _word_re(extra_symbols: str) -> "re.Pattern[str]":
    extra = re.escape(extra_symbols)
    # a word starts/ends with \w (letter/digit) but may contain extra symbols
    # inside — mirrors the reference splitter which strips leading/trailing
    # delimiters (stringstools.cc word boundaries)
    return re.compile(rf"[^\W_](?:[\w{extra}]*[^\W_])?", re.UNICODE)


# CJK ideograph ranges (BMP unified + extension A + compat + kana)
_CJK_RE = re.compile(
    "([぀-ヿ㐀-䶿一-鿿豈-﫿])")


def _split_cjk(tok: str, extra_symbols: str = "-/+_`'",
               segmenter=None) -> list[str]:
    """CJK-aware post-split. By default ideographs/kana index as
    single-character tokens (the unigram analog of the reference's MMSeg
    Chinese splitter, ft_fast/frisosplitter.cc — segmentation quality
    differs, searchability matches: every character is findable and
    phrases use positions). With a `segmenter` (ft/mmseg.py, ftconfig
    'splitter': 'mmseg_cn') CJK runs segment into dictionary words.
    Non-CJK residue re-applies the word rule (trims dangling delimiters)."""
    if not _CJK_RE.search(tok):
        return [tok]
    out = []
    word_re = _word_re(extra_symbols)
    run: list[str] = []

    def flush_run():
        if run:
            out.extend(segmenter.segment("".join(run)) if segmenter
                       else run)
            run.clear()

    for part in _CJK_RE.split(tok):
        if not part:
            continue
        if _CJK_RE.fullmatch(part):
            run.append(part)
        else:
            flush_run()
            out.extend(word_re.findall(part))
    flush_run()
    return out


def tokenize(text: str, extra_symbols: str = "-/+_`'",
             segmenter=None) -> list[str]:
    """Split text into lower-cased word tokens (CJK runs split into
    single-character tokens, or dictionary words with a segmenter)."""
    if not text:
        return []
    out: list[str] = []
    for tok in _word_re(extra_symbols).findall(text.lower()):
        out.extend(_split_cjk(tok, extra_symbols, segmenter))
    return out


def tokenize_with_offsets(text: str, extra_symbols: str = "-/+_`'",
                          segmenter=None,
                          ) -> Iterator[tuple[str, int, int]]:
    """Yield (token, char_start, char_end) — used by highlight/snippet
    (reference: areas in ft/areaholder.h)."""
    if not text:
        return
    for m in _word_re(extra_symbols).finditer(text.lower()):
        tok = m.group(0)
        parts = _split_cjk(tok, extra_symbols, segmenter)
        if len(parts) == 1 and parts[0] == tok:
            yield tok, m.start(), m.end()
        else:
            pos = m.start()
            for part in parts:
                yield part, pos, pos + len(part)
                pos += len(part)


def is_number(tok: str) -> bool:
    return tok.isdigit()

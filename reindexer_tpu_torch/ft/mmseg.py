"""MMSEG dictionary segmentation for Chinese text.

Semantic equivalent of the reference's friso-based splitter
(cpp_src/core/ft/ft_fast/frisosplitter.cc — the MMSEG algorithm of Chih-Hao
Tsai as implemented by friso): for each position, enumerate 3-word "chunks"
of dictionary matches and disambiguate with the four MMSEG rules in order:

  1. maximum total chunk length,
  2. largest average word length,
  3. smallest variance of word lengths,
  4. largest sum of single-character word frequencies (morphemic freedom —
     friso uses log-scaled corpus frequencies).

The reference ships friso's lexicon; this module ships a small built-in
demo lexicon and loads a real one from `splitter_dict_path` (one
`word[<tab>freq]` per line — the friso lex format's payload). With no
dictionary entry available, characters segment as unigrams, which degrades
exactly to the fast splitter's CJK behavior (ft/tokenizer.py _split_cjk).
Enabled via ft config `"splitter": "mmseg_cn"` (reference ftconfig.h
splitter field).
"""
from __future__ import annotations

import math
from functools import lru_cache
from typing import Optional

# Minimal demonstration lexicon (word -> corpus frequency). Deployments
# index real Chinese corpora with `splitter_dict_path` pointing at a full
# lexicon; this built-in set keeps the algorithm exercisable offline.
_BUILTIN = {
    "研究": 500, "研究生": 120, "生命": 400, "起源": 150, "命": 300,
    "中国": 900, "北京": 600, "大学": 550, "科学": 450, "技术": 420,
    "数据": 380, "数据库": 260, "索引": 90, "搜索": 210, "引擎": 130,
    "搜索引擎": 80, "全文": 60, "向量": 50, "时间": 470, "世界": 520,
    "我们": 800, "他们": 640, "学习": 310, "机器": 180, "机器学习": 95,
    "语言": 270, "模型": 140, "信息": 330, "系统": 360, "计算": 220,
    "计算机": 160, "网络": 290, "人工": 110, "智能": 170, "人工智能": 100,
    "的": 2000, "是": 1500, "了": 1200, "在": 1100, "有": 1000,
}


class MmsegSplitter:
    """Stateful dictionary + the MMSEG chunk scorer."""

    def __init__(self, dict_path: str = ""):
        self.words: dict[str, float] = dict(_BUILTIN)
        if dict_path:
            with open(dict_path, encoding="utf-8") as fh:
                for line in fh:
                    parts = line.strip().split("\t")
                    if not parts or not parts[0]:
                        continue
                    freq = float(parts[1]) if len(parts) > 1 else 1.0
                    self.words[parts[0]] = freq
        self.max_len = max((len(w) for w in self.words), default=1)

    def _matches(self, text: str, i: int) -> list[str]:
        """Dictionary words starting at i (single char always matches)."""
        out = [text[i]]
        end = min(len(text), i + self.max_len)
        for j in range(i + 2, end + 1):
            if text[i:j] in self.words:
                out.append(text[i:j])
        return out

    def _freedom(self, w: str) -> float:
        """log corpus frequency of a single-char word (rule 4)."""
        return math.log(self.words.get(w, 0.0) + 1.0)

    def segment(self, text: str) -> list[str]:
        """Segment one CJK run into dictionary words (unigrams when no
        entry covers a character)."""
        out: list[str] = []
        i = 0
        n = len(text)
        while i < n:
            best_key = None
            best_w1 = text[i]
            for w1 in self._matches(text, i):
                j = i + len(w1)
                for w2 in (self._matches(text, j) if j < n else [""]):
                    k = j + len(w2)
                    for w3 in (self._matches(text, k) if k < n else [""]):
                        lens = [len(w) for w in (w1, w2, w3) if w]
                        total = sum(lens)
                        avg = total / len(lens)
                        var = sum((l - avg) ** 2 for l in lens) / len(lens)
                        freedom = sum(self._freedom(w)
                                      for w in (w1, w2, w3) if len(w) == 1)
                        key = (total, avg, -var, freedom)
                        if best_key is None or key > best_key:
                            best_key = key
                            best_w1 = w1
            out.append(best_w1)
            i += len(best_w1)
        return out


@lru_cache(maxsize=8)
def get_splitter(dict_path: str = "") -> MmsegSplitter:
    return MmsegSplitter(dict_path)


def segmenter_for_config(cfg) -> Optional[MmsegSplitter]:
    """The configured CJK segmenter, or None for the fast unigram split
    (ftconfig 'splitter': 'fast' default)."""
    if getattr(cfg, "splitter", "fast") == "mmseg_cn":
        return get_splitter(getattr(cfg, "splitter_dict_path", "") or "")
    return None

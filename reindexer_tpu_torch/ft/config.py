"""Full-text index configuration.

Mirrors the reference `FTConfig` / `FTFieldConfig` / `FtSubTermProcs`
(cpp_src/core/ft/config/ftconfig.h:36-238) at the semantic level: the same
knobs with the same defaults, parsed from the index-definition JSON config
(the `config` object of a `text` index).
"""
from __future__ import annotations

import dataclasses
from typing import Optional


def _default_morpheme_stop_words() -> set:
    from .stopwords import DEFAULT_MORPHEME_STOP_WORDS
    return set(DEFAULT_MORPHEME_STOP_WORDS)


@dataclasses.dataclass
class SubTermProcs:
    """Per-variant base relevancy percentages (reference: FtSubTermProcs,
    ftconfig.h:79-116 defaults)."""

    full_match: int = 100
    concat: int = 90
    split: int = 90
    prefix_min: int = 20
    suffix_min: int = 10
    typo: int = 85
    typo_penalty: int = 15
    stemmer_penalty: int = 15
    kblayout: int = 90
    translit: int = 90
    synonyms: int = 95
    delimited: int = 80


@dataclasses.dataclass
class FtFieldConfig:
    """Per-field ranking weights (reference: FTFieldConfig, ftconfig.h:118-147)."""

    bm25_boost: float = 1.0
    bm25_weight: float = 0.1
    term_len_boost: float = 1.0
    term_len_weight: float = 0.3
    position_boost: float = 1.0
    position_weight: float = 0.1


@dataclasses.dataclass
class Bm25Config:
    """BM25 variant config (reference: FTConfig::Bm25Config, ftconfig.h:199-206)."""

    k1: float = 2.0
    b: float = 0.75
    bm25_type: str = "rx"  # rx | classic | word_count


@dataclasses.dataclass
class Synonym:
    tokens: list[str] = dataclasses.field(default_factory=list)
    alternatives: list[str] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class FtFastConfig:
    """Semantic mirror of the reference FTConfig (ftconfig.h:150-238)."""

    merge_limit: int = 20000
    stemmers: list[str] = dataclasses.field(default_factory=lambda: ["en", "ru"])
    enable_translit: bool = True
    enable_kb_layout: bool = True
    enable_numbers_search: bool = False
    stop_words: set = dataclasses.field(default_factory=set)
    # stop words of morpheme type (reference: StopWord::Type::Morpheme) —
    # skipped at index time like plain stop words; the bundled en/ru
    # dictionaries apply BY DEFAULT (ftconfig.cc:30-36) and a custom
    # "stop_words" config key replaces them (ftconfig.cc:248-251)
    morpheme_stop_words: set = dataclasses.field(
        default_factory=lambda: _default_morpheme_stop_words())
    synonyms: list[Synonym] = dataclasses.field(default_factory=list)
    log_level: int = 0
    extra_word_symbols: str = "-/+_`'"   # reference kDefaultExtraWordsSymbols
    # "fast" (default) or "mmseg_cn" (reference ftconfig.h splitter;
    # frisosplitter.cc) — mmseg_cn segments CJK runs by dictionary
    splitter: str = "fast"
    splitter_dict_path: str = ""         # lexicon file (word[\tfreq] lines)
    distance_boost: float = 1.0
    distance_weight: float = 0.5
    full_match_boost: float = 1.1
    partial_match_decrease: int = 15
    min_relevancy: float = 0.05
    min_rank: int = 5
    max_typos: int = 2
    max_typo_len: int = 15
    # detailed typos config (reference: FtTyposDetailedConfig,
    # ftconfig.h:186-231 + fulltext.md "Typos handling details";
    # -1 = unlimited for all four)
    max_typo_distance: int = 0
    max_symbol_permutation_distance: int = 1
    max_missing_letters: int = 2
    max_extra_letters: int = 2
    max_rebuild_steps: int = 50
    max_step_size: int = 4000
    # framework-native addition (no reference analog): at commit time,
    # pre-run the N most frequent indexed words through the selector so
    # their materialized per-word top-k caches (selector._score_host
    # skey cache) are hot — a cold zipf-head single-term query is a
    # ~20 ms/1M-posting 1-core host stream otherwise. Only words big
    # enough for the per-word cache (>= FtSelector.SINGLE_CACHE_MIN
    # postings) are warmed, so small corpora pay nothing. 0 disables.
    warmup_frequent_words: int = 32
    bm25: Bm25Config = dataclasses.field(default_factory=Bm25Config)
    sum_ranks_by_fields_ratio: float = 0.0
    max_areas_in_doc: int = 5
    fields: dict[str, FtFieldConfig] = dataclasses.field(default_factory=dict)
    default_field: FtFieldConfig = dataclasses.field(default_factory=FtFieldConfig)
    procs: SubTermProcs = dataclasses.field(default_factory=SubTermProcs)

    @property
    def max_typos_in_word(self) -> int:
        """(reference: FTConfig::MaxTyposInWord, ftconfig.h:219)"""
        return (self.max_typos // 2) + (self.max_typos % 2)

    @classmethod
    def from_dict(cls, d: Optional[dict]) -> "FtFastConfig":
        cfg = cls()
        if not d:
            return cfg
        cfg.merge_limit = int(d.get("merge_limit", cfg.merge_limit))
        if "stemmers" in d:
            cfg.stemmers = list(d["stemmers"])
        cfg.enable_translit = bool(d.get("enable_translit", cfg.enable_translit))
        cfg.enable_kb_layout = bool(d.get("enable_kb_layout", cfg.enable_kb_layout))
        cfg.enable_numbers_search = bool(
            d.get("enable_numbers_search", cfg.enable_numbers_search))
        if "stop_words" in d:
            # a custom list REPLACES the bundled defaults
            # (reference: ftconfig.cc:248-251 stopWords.clear())
            cfg.stop_words = set()
            cfg.morpheme_stop_words = set()
        for sw in d.get("stop_words") or []:
            if isinstance(sw, dict):
                # {"word": ..., "is_morpheme": bool} (reference: stop-word obj)
                if sw.get("is_morpheme"):
                    cfg.morpheme_stop_words.add(str(sw["word"]).lower())
                else:
                    cfg.stop_words.add(str(sw["word"]).lower())
            else:
                cfg.stop_words.add(str(sw).lower())
        for syn in d.get("synonyms", []):
            cfg.synonyms.append(Synonym(
                tokens=[t.lower() for t in syn.get("tokens", [])],
                alternatives=[a.lower() for a in syn.get("alternatives", [])]))
        cfg.extra_word_symbols = d.get("extra_word_symbols", cfg.extra_word_symbols)
        cfg.splitter = str(d.get("splitter", cfg.splitter))
        cfg.splitter_dict_path = str(
            d.get("splitter_dict_path", cfg.splitter_dict_path))
        cfg.partial_match_decrease = int(
            d.get("partial_match_decrease", cfg.partial_match_decrease))
        cfg.min_relevancy = float(d.get("min_relevancy", cfg.min_relevancy))
        # min_relevancy is the deprecated alias initializing min_rank
        # (reference: ftconfig.cc:121-123 — minRank = 100 * minRelevancy)
        if "min_relevancy" in d and "min_rank" not in d:
            cfg.min_rank = int(100.0 * cfg.min_relevancy)
        cfg.min_rank = int(d.get("min_rank", cfg.min_rank))
        cfg.max_typos = int(d.get("max_typos", d.get("max_typos_in_word",
                                                     cfg.max_typos)))
        cfg.max_typo_len = int(d.get("max_typo_len", cfg.max_typo_len))
        tdc = d.get("typos_detailed_config") or {}
        cfg.max_typo_distance = int(
            tdc.get("max_typo_distance", cfg.max_typo_distance))
        cfg.max_symbol_permutation_distance = int(
            tdc.get("max_symbol_permutation_distance",
                    cfg.max_symbol_permutation_distance))
        cfg.max_missing_letters = int(
            tdc.get("max_missing_letters", cfg.max_missing_letters))
        cfg.max_extra_letters = int(
            tdc.get("max_extra_letters", cfg.max_extra_letters))
        cfg.max_rebuild_steps = int(d.get("max_rebuild_steps", cfg.max_rebuild_steps))
        cfg.max_step_size = int(d.get("max_step_size", cfg.max_step_size))
        cfg.warmup_frequent_words = int(
            d.get("warmup_frequent_words", cfg.warmup_frequent_words))
        cfg.distance_boost = float(d.get("distance_boost", cfg.distance_boost))
        cfg.distance_weight = float(d.get("distance_weight", cfg.distance_weight))
        cfg.full_match_boost = float(d.get("full_match_boost", cfg.full_match_boost))
        cfg.sum_ranks_by_fields_ratio = float(
            d.get("sum_ranks_by_fields_ratio", cfg.sum_ranks_by_fields_ratio))
        cfg.max_areas_in_doc = int(d.get("max_areas_in_doc", cfg.max_areas_in_doc))
        bm = d.get("bm25") or {}
        cfg.bm25 = Bm25Config(
            k1=float(bm.get("bm25_k1", 2.0)),
            b=float(bm.get("bm25_b", 0.75)),
            bm25_type=str(bm.get("bm25_type", "rx")),
        )
        def field_cfg(fd: dict, base: FtFieldConfig) -> FtFieldConfig:
            return FtFieldConfig(
                bm25_boost=float(fd.get("bm25_boost", base.bm25_boost)),
                bm25_weight=float(fd.get("bm25_weight", base.bm25_weight)),
                term_len_boost=float(fd.get("term_len_boost", base.term_len_boost)),
                term_len_weight=float(fd.get("term_len_weight", base.term_len_weight)),
                position_boost=float(fd.get("position_boost", base.position_boost)),
                position_weight=float(fd.get("position_weight", base.position_weight)),
            )
        cfg.default_field = field_cfg(d, FtFieldConfig())
        for fd in d.get("fields", []):
            name = fd.get("field_name", "")
            cfg.fields[name] = field_cfg(fd, cfg.default_field)
        return cfg

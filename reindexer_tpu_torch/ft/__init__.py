"""Full-text engine (ft_fast analog) of reindexer_tpu_torch (port of
reindexer_tpu/ft/).

Host side: tokenizer, stemmers, DSL parser, variant expanders, dictionary,
the C++ host merge (csrc/ft_native.cpp). Device side: CSR posting arrays on
a torch device, BM25 scoring in plain PyTorch (scorer.py, device_dense.py;
the JAX package's full-text device code has no Pallas kernel).
Reference: cpp_src/core/ft/ (SURVEY.md §2.1 L3a).
"""
from .config import FtFastConfig
from .dsl import parse_ft_dsl
from .selector import FtSelector
from .dataholder import FtDataHolder

__all__ = ["FtFastConfig", "parse_ft_dsl", "FtSelector", "FtDataHolder"]

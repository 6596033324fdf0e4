"""The paper's own test configuration (§2): an artificially-generated
ROOT-tree-like event file with 2,000 events, used by the figure benchmarks
and by the compression test-suite.

Structure mirrors a CMS-NanoAOD-style tree (the paper's Fig. 6 sample):
float kinematics columns, small-int multiplicity columns, and var-size
(C-array) branches whose serialization yields the (payload, offset-array)
pairs the paper's §2.2 preconditioner discussion is about.
"""

from __future__ import annotations

import dataclasses

__all__ = ["PaperIOConfig", "PAPER_IO"]


@dataclasses.dataclass(frozen=True)
class PaperIOConfig:
    n_events: int = 2000            # the paper's test-tree size
    basket_bytes: int = 32 * 1024   # ROOT default basket size
    seed: int = 20190511            # the paper's "accessed" date, for fun
    # survey axes (paper Figures 2-3): every codec at levels 1, 6, 9 (+0)
    levels: tuple = (1, 6, 9)
    codecs: tuple = ("zlib", "lz4", "zstd", "lzma",
                     "repro-deflate", "repro-deflate-ref", "repro-zstd")
    preconds: tuple = ("none", "shuffle4", "bitshuffle4", "delta4+shuffle4")


PAPER_IO = PaperIOConfig()

"""repro_torch.io — the parallel I/O engine (DESIGN.md §5).

* :class:`~repro_torch.io.engine.CompressionEngine` — pipelined parallel
  basket compression with in-order streaming commit and backpressure;
* :class:`~repro_torch.io.prefetch.PrefetchReader` — decompress-ahead reads
  with an LRU decompressed-basket cache (the TTreeCache analogue);
* :class:`~repro_torch.io.merger.BufferMerger` / ``BasketBuffer`` —
  multi-producer single-file output without recompression (the
  TBufferMerger analogue), plus :func:`~repro_torch.io.merger.merge_files`
  fast file splicing;
* :mod:`~repro_torch.io.shmem` — shared-memory slab pool: the zero-pickle
  transport behind the process-pool codecs;
* :mod:`~repro_torch.io.fdcache` — one cached fd per container path with
  ``os.pread`` basket reads.
"""

from .engine import CompressionEngine, cpu_count
from .merger import BasketBuffer, BufferMerger, merge_files
from .prefetch import PrefetchReader

__all__ = ["CompressionEngine", "cpu_count", "PrefetchReader",
           "BasketBuffer", "BufferMerger", "merge_files"]

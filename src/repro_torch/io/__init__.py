"""repro_torch.io — the parallel I/O engine (DESIGN.md §5).

* :class:`~repro_torch.io.engine.CompressionEngine` — pipelined parallel
  basket compression with in-order streaming commit and backpressure;
* :mod:`~repro_torch.io.shmem` — shared-memory slab pool: the zero-pickle
  transport behind the process-pool codecs;
* :mod:`~repro_torch.io.fdcache` — one cached fd per container path with
  ``os.pread`` basket reads.

The reference's decompress-ahead reader and buffer merger are not ported
yet (ROADMAP.md queue A).
"""

from .engine import CompressionEngine, cpu_count

__all__ = ["CompressionEngine", "cpu_count"]

"""repro_torch.core — the paper's contribution: columnar basket compression.

Codecs (zlib/lz4/lzma/repro-deflate/repro-zstd + dictionaries), Blosc-style
preconditioners, vectorized checksums, the basket/file container, and the
per-branch codec policy.  See DESIGN.md §1-4.
"""

from .codec import (CODECS, CompressionConfig, compress, decompress,
                    decompress_into, get_codec)
from .policy import PROFILES, choose, precond_for_array
from .basket import BasketMeta, pack_basket, unpack_basket, unpack_basket_into
from .bfile import BasketFile, BasketWriter, read_arrays, write_arrays
from .dictionary import train_dictionary, suggest_dict_size

__all__ = [
    "CODECS", "CompressionConfig", "compress", "decompress",
    "decompress_into", "get_codec",
    "PROFILES", "choose", "precond_for_array",
    "BasketMeta", "pack_basket", "unpack_basket", "unpack_basket_into",
    "BasketFile", "BasketWriter", "read_arrays", "write_arrays",
    "train_dictionary", "suggest_dict_size",
]

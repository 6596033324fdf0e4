"""repro_torch.repair — XOR parity sidecars (DESIGN.md §15).

Only :mod:`repro_torch.repair.stripe` is ported: it backs
``save_pytree(parity=k)`` and restore's ``heal="auto"``.
"""

from .stripe import (ParityError, ParitySidecar, ParityWriter, content_stamp,
                     parity_path)

__all__ = ["ParityError", "ParitySidecar", "ParityWriter", "content_stamp",
           "parity_path"]

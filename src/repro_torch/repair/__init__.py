"""repro_torch.repair — self-healing storage (DESIGN.md §15).

Three layers over the container + remote fleet:

* :mod:`repro_torch.repair.stripe` — XOR parity sidecars written alongside a
  container (``BasketWriter(parity=k)``) and the reconstruction math a
  ``BasketFile(heal="auto")`` uses to rebuild a rotted basket in place.
* :mod:`repro_torch.repair.scrub` — the background scrubber: verify every
  basket checksum at a byte-rate budget, heal from parity, persist a
  resumable per-container cursor.
* :mod:`repro_torch.repair.reconcile` — anti-entropy replica repair: diff
  per-basket checksums across replicas via CATALOG and pull good bytes
  from a healthy peer to converge a damaged one.
"""

from .stripe import (ParityError, ParitySidecar, ParityWriter, content_stamp,
                     parity_path)
from .scrub import Scrubber, scrub_container
from .reconcile import diff_catalogs, repair_replica

__all__ = [
    "ParityError", "ParitySidecar", "ParityWriter", "content_stamp",
    "parity_path", "Scrubber", "scrub_container", "diff_catalogs",
    "repair_replica",
]

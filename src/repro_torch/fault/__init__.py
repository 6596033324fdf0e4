"""repro_torch.fault — deterministic fault injection (DESIGN.md §14).

The failure-hardening in ``repro_torch.remote`` and ``repro_torch.core.bfile`` is only
as real as the failures it has been run against.  This package supplies
those failures *reproducibly*:

* :class:`FaultPlan` / :class:`FaultRule` — a seeded description of what
  to break, when: drop/delay/reset/garble/short-read, triggered per verb,
  per direction, per frame count, or per byte offset.  Decisions are pure
  functions of ``(seed, rule, connection, frame)`` — the same plan
  replays the same faults, so a chaos-soak failure is a test case, not a
  weather report.
* :class:`ChaosProxy` — an in-process TCP proxy speaking raw RBSP framing
  that applies a plan between a real client and a real server.
* :func:`pread_fault_hook` — the local-storage analogue: a hook for
  ``repro_torch.io.fdcache.set_fault_hook`` that garbles, truncates, or delays
  basket preads underneath a live server or local reader.
* :func:`rot_container` — persistent bit-rot: deterministically garble
  every Nth basket of a container *on disk* (TOC walk + ``pwrite``), the
  damage the self-healing tier (DESIGN.md §15) exists to repair.  With
  parity width ``k``, ``every >= k + 1`` keeps every stripe healable.

``tools/chaos.py`` is the CLI: stand a chaos proxy in front of any
running basket server and point clients at it.
"""

from .inject import (FaultPlan, FaultRule, parse_rule, pread_fault_hook,
                     rot_container)
from .proxy import ChaosProxy

__all__ = ["FaultPlan", "FaultRule", "parse_rule", "pread_fault_hook",
           "rot_container", "ChaosProxy"]

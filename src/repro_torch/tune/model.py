"""Cost model: measured trials, objectives, and Pareto selection.

The paper's survey measures every (algorithm, level, preconditioner) on
real branch data and reads the answer off a three-axis trade surface:
compression ratio, compression speed, decompression speed.  This module is
that surface as code:

* :class:`TrialResult` — one measured point (a candidate config run on a
  sampled payload).
* :class:`Objective` — a declared operating point: log-linear weights over
  (ratio, write MB/s, read MB/s).  ``min_bytes`` / ``max_write_tput`` /
  ``max_read_tput`` are the pure axes (with a whisper of weight on the
  other axes so exact ties break toward better all-round configs);
  ``production`` / ``analysis`` / ``checkpoint`` are the paper's §3 use
  cases as weighted blends.
* :func:`pareto_front` / :func:`select` — dominated candidates can never
  win any objective, so selection filters to the Pareto front first and
  then takes the objective's argmax with a fully deterministic tie-break.

Scores are log-linear (``w·log(metric)``) so weights express *relative*
improvements — "10% better ratio" trades against "10% faster decode" at
the weight ratio, independent of absolute magnitudes.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Iterable, Optional, Sequence

from repro_torch.core.codec import CompressionConfig

__all__ = ["TrialResult", "Objective", "OBJECTIVES", "resolve_objective",
           "pareto_front", "select"]

_EPS = 1e-9


@dataclasses.dataclass(frozen=True)
class TrialResult:
    """One measured (config, cost) point on the survey surface."""

    algo: str
    level: int
    precond: str
    orig_len: int        # sample bytes in
    comp_len: int        # compressed bytes out
    comp_s: float        # best-of-reps compress wall seconds
    decomp_s: float      # best-of-reps decompress wall seconds

    @property
    def ratio(self) -> float:
        return self.orig_len / max(self.comp_len, 1)

    @property
    def comp_mbps(self) -> float:
        return self.orig_len / max(self.comp_s, _EPS) / 1e6

    @property
    def decomp_mbps(self) -> float:
        return self.orig_len / max(self.decomp_s, _EPS) / 1e6

    def config(self, dictionary: Optional[bytes] = None) -> CompressionConfig:
        return CompressionConfig(algo=self.algo, level=self.level,
                                 precond=self.precond, dictionary=dictionary)

    def to_json(self) -> dict:
        return dataclasses.asdict(self)

    @staticmethod
    def from_json(d: dict) -> "TrialResult":
        return TrialResult(**{f.name: d[f.name]
                              for f in dataclasses.fields(TrialResult)})


@dataclasses.dataclass(frozen=True)
class Objective:
    """Log-linear operating point over (ratio, write tput, read tput)."""

    name: str
    w_ratio: float = 0.0
    w_write: float = 0.0
    w_read: float = 0.0

    def score(self, t: TrialResult) -> float:
        return (self.w_ratio * math.log(max(t.ratio, _EPS))
                + self.w_write * math.log(max(t.comp_mbps, _EPS))
                + self.w_read * math.log(max(t.decomp_mbps, _EPS)))


OBJECTIVES: dict[str, Objective] = {
    # pure axes (tiny secondary weights = deterministic sane tie-breaks)
    "min_bytes": Objective("min_bytes", 1.0, 0.01, 0.01),
    "max_write_tput": Objective("max_write_tput", 0.01, 1.0, 0.0),
    "max_read_tput": Objective("max_read_tput", 0.01, 0.0, 1.0),
    # the paper's §3 operating points as blends
    "production": Objective("production", 1.0, 0.05, 0.25),   # ratio-bound, CPU-rich
    "analysis": Objective("analysis", 0.3, 0.05, 1.0),        # decode-speed-bound
    "checkpoint": Objective("checkpoint", 0.6, 0.5, 0.1),     # write-often read-rarely
}


def resolve_objective(obj) -> Objective:
    """Accept an :class:`Objective`, a registered name, or a weight dict
    ``{"ratio": w, "write": w, "read": w}``."""
    if isinstance(obj, Objective):
        return obj
    if isinstance(obj, str):
        try:
            return OBJECTIVES[obj]
        except KeyError:
            raise ValueError(
                f"unknown objective {obj!r}; valid objectives: "
                f"{', '.join(sorted(OBJECTIVES))}") from None
    if isinstance(obj, dict):
        extra = set(obj) - {"name", "ratio", "write", "read"}
        if extra:
            raise ValueError(f"unknown objective weight keys {sorted(extra)}; "
                             "use 'ratio', 'write', 'read'")
        return Objective(name=obj.get("name", "custom"),
                         w_ratio=float(obj.get("ratio", 0.0)),
                         w_write=float(obj.get("write", 0.0)),
                         w_read=float(obj.get("read", 0.0)))
    raise TypeError(f"objective must be str, dict, or Objective, "
                    f"got {type(obj).__name__}")


def _dominates(a: TrialResult, b: TrialResult) -> bool:
    """a dominates b: no worse on every axis, strictly better on one."""
    ge = (a.ratio >= b.ratio and a.comp_mbps >= b.comp_mbps
          and a.decomp_mbps >= b.decomp_mbps)
    gt = (a.ratio > b.ratio or a.comp_mbps > b.comp_mbps
          or a.decomp_mbps > b.decomp_mbps)
    return ge and gt


def pareto_front(trials: Iterable[TrialResult]) -> list[TrialResult]:
    """Non-dominated subset of ``trials`` (input order preserved)."""
    ts = list(trials)
    return [t for t in ts
            if not any(_dominates(o, t) for o in ts if o is not t)]


def select(trials: Sequence[TrialResult], objective) -> TrialResult:
    """The Pareto-optimal trial maximizing ``objective``.

    Deterministic: exact score ties break by (ratio, write tput, read
    tput, then config identity), so re-running selection on the same cost
    table always returns the same config.
    """
    obj = resolve_objective(objective)
    front = pareto_front(trials)
    if not front:
        raise ValueError("no trials to select from")
    return max(front, key=lambda t: (obj.score(t), t.ratio, t.comp_mbps,
                                     t.decomp_mbps,
                                     (t.algo, t.level, t.precond)))

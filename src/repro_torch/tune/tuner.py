"""The measurement-driven autotuner: the paper's survey as a feedback loop.

``core.policy`` hard-codes the survey's *conclusions* (static profiles +
dtype heuristics).  This module re-runs the survey's *method* online, on
the user's actual branch data:

    sampler -> trial matrix -> cost model -> decision cache -> drift loop

Per branch, the :class:`Tuner` draws a deterministic stratified sample
(:mod:`repro_torch.tune.sampler`), runs trial compressions for a candidate
matrix built from the codec/preconditioner registries (optionally in
parallel through a shared :class:`repro_torch.io.engine.CompressionEngine`),
fits the measured (ratio, compress MB/s, decompress MB/s) cost table, and
selects the Pareto-optimal config under the declared objective
(:mod:`repro_torch.tune.model`).  Decisions are cached per branch; writers
persist them in the BasketFile TOC so appends and re-opens reuse them
without re-measurement (:func:`load_decisions` / :meth:`Tuner.from_file`).

Cheap drift guard: each decision remembers the byte-entropy of the sample
it was measured on, and every written basket's observed ratio feeds a
per-branch EWMA.  A reuse request re-fingerprints the fresh data; if the
entropy or the observed ratio has shifted past the thresholds, the cached
decision is discarded and the branch re-tunes.

``policy.choose`` remains the zero-measurement fallback: branches too
small to sample meaningfully (``min_tune_bytes``), non-numeric blobs, and
any trial-matrix failure all fall back to the static heuristic.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Optional, Sequence

import numpy as np

from repro_torch import obs
from repro_torch.core.codec import CompressionConfig
from repro_torch.core.policy import PROFILES, choose, precond_for_array

from .model import (Objective, TrialResult, resolve_objective, select)
from .sampler import (DEFAULT_SAMPLE_BYTES, DEFAULT_WINDOWS, byte_entropy,
                      stratified_sample)

__all__ = ["Decision", "Tuner", "default_candidates", "load_decisions"]


@dataclasses.dataclass
class Decision:
    """One cached per-branch choice plus the evidence it rests on."""

    trial: TrialResult
    objective: str
    sample_entropy: float
    n_candidates: int = 0
    source: str = "measured"      # "measured" | "shared" | "persisted"

    def config(self, dictionary: Optional[bytes] = None) -> CompressionConfig:
        return self.trial.config(dictionary)

    def to_json(self) -> dict:
        d = self.trial.to_json()
        d.update(objective=self.objective,
                 sample_entropy=round(self.sample_entropy, 4),
                 n_candidates=self.n_candidates)
        return d

    @staticmethod
    def from_json(d: dict) -> "Decision":
        return Decision(trial=TrialResult.from_json(d),
                        objective=d.get("objective", "checkpoint"),
                        sample_entropy=float(d.get("sample_entropy", -1.0)),
                        n_candidates=int(d.get("n_candidates", 0)),
                        source="persisted")


class _Drift:
    """Per-branch EWMA of observed basket compression ratios."""

    __slots__ = ("ewma", "n")

    def __init__(self):
        self.ewma = 0.0
        self.n = 0

    def update(self, ratio: float, alpha: float = 0.3) -> None:
        self.ewma = ratio if self.n == 0 else \
            (1.0 - alpha) * self.ewma + alpha * ratio
        self.n += 1


def default_candidates(arr: np.ndarray, objective: Objective
                       ) -> list[tuple[str, int, str]]:
    """(algo, level, precond) trial matrix from the registries.

    Algo/level pairs come from the static :data:`PROFILES` table (so the
    tuned choice can never lose to a static profile it refused to try on
    the axes it is allowed to win), pruned by objective — a candidate
    class that cannot win the declared objective is not worth measuring:

    * ``lzma`` only when the objective is ratio-bound (``w_ratio >= 0.8``):
      its trials are expensive and it can't win a throughput axis;
    * pure-Python codecs (the profile table only ever contributes our LZ4
      block format here) dropped when writes carry real weight
      (``w_write >= 0.5``) — they compress at single-digit MB/s — and when
      the objective is ratio-bound — an LZ-only format with no entropy
      stage can't win ``min_bytes`` against the deflate/lzma family;
    * pure-Python high-compression levels (``>= 4``) dropped everywhere:
      they share level 1's decoder (same block format, ~same decode
      speed), so on the one axis they could still win — read throughput —
      they measure nothing level 1 doesn't, at 3-10x the trial cost;
    * high levels (``>= 4``) dropped when the objective is purely
      write-bound (``w_write >= 0.8``): more search never compresses
      faster.

    Preconditioners: the dtype heuristic, the plain byte shuffle, and
    none.
    """
    from repro_torch.core.codec import is_pure_python

    heur = precond_for_array(arr)
    preconds = {heur, "none"}
    dt = arr.dtype
    if dt.kind in "iu":
        preconds.add(f"shuffle{min(dt.itemsize, 8)}")
    elif dt.kind == "f" or dt.name == "bfloat16" or \
            (dt.kind == "V" and dt.itemsize == 2):
        preconds.add(f"shuffle{max(dt.itemsize, 2)}")
    pairs, seen = [], set()
    for prof, p in PROFILES.items():
        algo, level = p["algo"], p["level"]
        if algo == "none" or (algo, level) in seen:
            continue
        if algo == "lzma" and objective.w_ratio < 0.8:
            continue
        if is_pure_python(algo) and (objective.w_write >= 0.5
                                     or objective.w_ratio >= 0.8
                                     or level >= 4):
            continue
        if level >= 4 and objective.w_write >= 0.8:
            continue
        seen.add((algo, level))
        pairs.append((algo, level))
    if objective.w_ratio >= 0.8:
        # pure ratio axis: within one algo only its strongest level can
        # win, so lower levels are dead trials
        top = {}
        for a, lv in pairs:
            top[a] = max(top.get(a, -1), lv)
        pairs = [(a, lv) for a, lv in pairs if lv == top[a]]
    elif objective.w_read >= 0.8:
        # pure decode axis: decode speed is ~level-independent within an
        # algo, so one level each measures the axis; the lowest is the
        # cheapest to trial
        lo = {}
        for a, lv in pairs:
            lo[a] = min(lo.get(a, 99), lv)
        pairs = [(a, lv) for a, lv in pairs if lv == lo[a]]
    return [(a, lv, pc) for a, lv in pairs for pc in sorted(preconds)]


class Tuner:
    """Per-branch adaptive (algo, level, precond) selection.

    ``objective`` — a name from :data:`repro_torch.tune.model.OBJECTIVES`
    (``min_bytes`` / ``max_write_tput`` / ``max_read_tput`` or the paper's
    ``production`` / ``analysis`` / ``checkpoint`` blends), a weight dict,
    or an :class:`Objective`.

    ``engine`` — optional shared :class:`repro_torch.io.engine.CompressionEngine`;
    when it has workers, trial compressions run concurrently through its
    pools (:meth:`CompressionEngine.submit_trial`).

    Thread-safe: one tuner may serve many producer threads (the
    ``producers>1`` checkpoint path); tuning a given branch is serialized.
    """

    def __init__(self, objective="checkpoint", *,
                 candidates: Optional[Sequence[tuple]] = None,
                 sample_bytes: int = DEFAULT_SAMPLE_BYTES,
                 sample_windows: int = DEFAULT_WINDOWS,
                 min_tune_bytes: int = 1 << 16,
                 trial_reps: int = 1,
                 trial_budget_s: Optional[float] = None,
                 engine=None,
                 fallback_profile: Optional[str] = None,
                 drift_ratio: float = 0.35,
                 drift_entropy: float = 0.75,
                 drift_min_baskets: int = 4,
                 share_signatures: bool = True):
        self.objective = resolve_objective(objective)
        self.candidates = list(candidates) if candidates is not None else None
        self.sample_bytes = int(sample_bytes)
        self.sample_windows = int(sample_windows)
        self.min_tune_bytes = int(min_tune_bytes)
        self.trial_reps = max(int(trial_reps), 1)
        # per-candidate wall budget: a slow candidate is ranked from a
        # probe (an eighth of the sample) instead of running in full —
        # ratio-bound objectives get a larger budget because their win
        # condition (compressed bytes) benefits from full-sample ratios
        if trial_budget_s is None:
            trial_budget_s = 0.06 if self.objective.w_ratio >= 0.8 else 0.04
        self.trial_budget_s = float(trial_budget_s)
        self.engine = engine
        # too-small-to-measure branches use the static profile nearest the
        # declared objective
        axis_fallback = {"min_bytes": "archive", "max_write_tput": "wire",
                         "max_read_tput": "analysis"}
        self.fallback_profile = fallback_profile or axis_fallback.get(
            self.objective.name,
            self.objective.name if self.objective.name in PROFILES
            else "checkpoint")
        self.drift_ratio = float(drift_ratio)
        self.drift_entropy = float(drift_entropy)
        self.drift_min_baskets = int(drift_min_baskets)
        # content-signature sharing: branches with the same (dtype,
        # heuristic precond, quantized sample entropy, objective) run the
        # trial matrix once — a corpus of N same-statistics weight planes
        # pays for one measurement, not N.  Every branch still gets its
        # own persisted decision and its own drift state (a branch whose
        # data later diverges re-tunes individually).
        self.share_signatures = bool(share_signatures)
        self._sig_cache: dict[tuple, Decision] = {}
        self.decisions: dict[str, Decision] = {}
        self.stats = {"tuned": 0, "reused": 0, "shared": 0, "fallback": 0,
                      "retuned": 0, "trials": 0, "trial_s": 0.0}
        self._drift: dict[str, _Drift] = {}
        self._lock = threading.RLock()
        self._branch_locks: dict[str, threading.Lock] = {}

    # -- persistence -----------------------------------------------------

    def decisions_json(self, names=None) -> dict[str, dict]:
        """JSON-able {branch: decision} map (the BasketFile TOC payload)."""
        with self._lock:
            keep = set(names) if names is not None else None
            return {n: d.to_json() for n, d in self.decisions.items()
                    if keep is None or n in keep}

    def load(self, mapping: dict[str, dict]) -> None:
        """Seed the cache with persisted decisions (no re-measurement).
        Malformed entries (foreign format revision, partial corruption)
        are skipped — those branches simply re-tune."""
        with self._lock:
            for name, d in mapping.items():
                try:
                    self.decisions[name] = Decision.from_json(d)
                except (KeyError, TypeError, ValueError):
                    continue

    @classmethod
    def from_file(cls, path: str, objective=None, **kw) -> "Tuner":
        """A tuner pre-seeded with the decisions persisted in ``path``'s
        TOC — the append/re-open path: matching branches reuse their
        persisted config with zero trial compressions."""
        decisions = load_decisions(path)
        if objective is None:
            objs = {d.get("objective") for d in decisions.values()}
            objective = objs.pop() if len(objs) == 1 else "checkpoint"
        t = cls(objective, **kw)
        t.load(decisions)
        return t

    # -- the decision loop ------------------------------------------------

    def config_for(self, name: str, data, dtype=None) -> CompressionConfig:
        """The per-branch decision: cached -> reused (after the drift
        check), new + big enough -> measured, otherwise the static
        ``policy.choose`` fallback.

        ``data`` is the branch array, or any buffer (+ ``dtype``) — e.g.
        the first staged chunk on the streaming checkpoint path.
        """
        arr = self._as_array(data, dtype)
        with self._lock:
            dec = self.decisions.get(name)
            if dec is not None:
                if dec.objective == self.objective.name \
                        and not self._stale(name, dec, arr):
                    self.stats["reused"] += 1
                    obs.counter("tune.decisions", outcome="reused").inc()
                    return dec.config()
                self.decisions.pop(name, None)
                self._drift.pop(name, None)
                retune = True
            else:
                retune = False
            if arr.nbytes < self.min_tune_bytes:
                self.stats["fallback"] += 1
                obs.counter("tune.decisions", outcome="fallback").inc()
                return choose(name, arr, self.fallback_profile)
        t0 = time.perf_counter()
        sample = self._sample(arr)
        h = byte_entropy(sample)
        sig = None
        if self.share_signatures:
            sig = (arr.dtype.str, precond_for_array(arr),
                   round(h * 4) / 4, self.objective.name)
        # trial compressions run OUTSIDE the tuner-wide lock: concurrent
        # producers tune different branches in parallel and observe()
        # never stalls behind a trial matrix.  The tuning lock is keyed by
        # signature when sharing is on — same-statistics branches
        # serialize so the first wave pays ONE matrix, not one each —
        # and by branch name otherwise.
        with self._lock:
            blk = self._branch_locks.setdefault(sig or name,
                                                threading.Lock())
        with blk:
            with self._lock:
                dec = self.decisions.get(name)
                if dec is not None and dec.objective == self.objective.name:
                    # another thread tuned this branch while we waited
                    self.stats["reused"] += 1
                    obs.counter("tune.decisions", outcome="reused").inc()
                    return dec.config()
                # a drift-triggered re-tune must NOT be satisfied from the
                # signature cache: the fingerprint (order-0 entropy) can't
                # see the order/correlation change the ratio EWMA caught,
                # so the cached entry may be exactly the stale decision —
                # re-measure, then overwrite it
                if sig is not None and not retune:
                    hit = self._sig_cache.get(sig)
                    if hit is not None:
                        dec = Decision(trial=hit.trial,
                                       objective=hit.objective,
                                       sample_entropy=h, n_candidates=0,
                                       source="shared")
                        self.decisions[name] = dec
                        self._drift.pop(name, None)
                        self.stats["shared"] += 1
                        self.stats["trial_s"] += time.perf_counter() - t0
                        obs.counter("tune.decisions", outcome="shared").inc()
                        return dec.config()
            dec = self._tune(name, arr, sample, h, sig, t0)
            with self._lock:
                if dec is None:     # every trial failed: static fallback
                    self.stats["fallback"] += 1
                    obs.counter("tune.decisions", outcome="fallback").inc()
                    return choose(name, arr, self.fallback_profile)
                kind = "retuned" if retune else "tuned"
                self.stats[kind] += 1
                obs.counter("tune.decisions", outcome=kind).inc()
                return dec.config()

    def observe(self, name: str, meta) -> None:
        """Feed one written basket's metadata to the drift detector."""
        orig = getattr(meta, "orig_len", None)
        comp = getattr(meta, "comp_len", None)
        if orig is None:            # plain dict (TOC-shaped) metas work too
            orig, comp = meta.get("orig_len", 0), meta.get("comp_len", 0)
        if not orig:
            return
        with self._lock:
            self._drift.setdefault(name, _Drift()).update(
                orig / max(comp, 1))

    # -- internals --------------------------------------------------------

    @staticmethod
    def _as_array(data, dtype) -> np.ndarray:
        if isinstance(data, np.ndarray):
            arr = data
        elif hasattr(data, "dtype") and hasattr(data, "shape"):
            arr = np.asarray(data)      # jax / array-likes
        else:
            arr = np.frombuffer(data, dtype=np.dtype(dtype or np.uint8))
        if arr.dtype.name == "bfloat16":
            arr = arr.view(np.uint16)
        return arr

    def _sample(self, arr: np.ndarray) -> np.ndarray:
        flat = np.ascontiguousarray(arr).reshape(-1).view(np.uint8)
        # relative cap: never sample more than ~3% of the branch, so the
        # trial matrix stays a bounded fraction of the branch's own write
        # cost (the <=5% tuning-overhead budget); floor at 16 KiB so small
        # branches still measure something meaningful
        eff = min(self.sample_bytes, max(flat.size // 32, 1 << 14))
        return stratified_sample(flat, max(arr.dtype.itemsize, 1),
                                 eff, self.sample_windows)

    def _stale(self, name: str, dec: Decision, arr: np.ndarray) -> bool:
        d = self._drift.get(name)
        if d is not None and d.n >= self.drift_min_baskets:
            ref = max(dec.trial.ratio, 1e-9)
            if abs(d.ewma - dec.trial.ratio) > self.drift_ratio * ref:
                return True
        if dec.sample_entropy >= 0.0 and arr.nbytes >= self.min_tune_bytes:
            h = byte_entropy(self._sample(arr))
            if abs(h - dec.sample_entropy) > self.drift_entropy:
                return True
        return False

    def _tune(self, name: str, arr: np.ndarray, sample: np.ndarray,
              entropy: float, sig, t0: float) -> Optional[Decision]:
        from repro_torch.io.engine import _trial_task
        cands = self.candidates if self.candidates is not None \
            else default_candidates(arr, self.objective)
        with obs.profile.mem_phase("tune.matrix"):
            trials = self._run_trials(sample, cands)
        # fairness pass: a budget-cut candidate was measured on a probe,
        # and ratio (and fixed-overhead-diluted MB/s) at probe size is not
        # comparable to full-sample numbers — so before the final pick,
        # re-measure any probe-sized finalist on the full sample (bounded:
        # top 3 by score, budget off)
        full_n = len(sample)
        for t in sorted(trials, key=self.objective.score, reverse=True)[:3]:
            if t.orig_len >= full_n:
                continue
            try:
                r = _trial_task(sample, (t.algo, t.level, t.precond, None),
                                self.trial_reps)
            except Exception:
                continue
            trials[trials.index(t)] = TrialResult(t.algo, t.level,
                                                  t.precond, *r)
        obs.histogram("tune.matrix_s").observe(time.perf_counter() - t0)
        with self._lock:
            self.stats["trials"] += len(cands)
            self.stats["trial_s"] += time.perf_counter() - t0
            if not trials:
                return None
            best = select(trials, self.objective)
            dec = Decision(trial=best, objective=self.objective.name,
                           sample_entropy=entropy,
                           n_candidates=len(cands))
            self.decisions[name] = dec
            if sig is not None:
                self._sig_cache[sig] = dec      # refreshes a stale entry
            self._drift.pop(name, None)
            return dec

    def _run_trials(self, sample, cands) -> list[TrialResult]:
        from repro_torch.core.codec import is_pure_python
        from repro_torch.io.engine import _trial_task
        trials: list[TrialResult] = []

        def run_inline(c):
            try:
                trials.append(TrialResult(*c, *_trial_task(
                    sample, (*c, None), self.trial_reps,
                    self.trial_budget_s)))
            except Exception:
                pass                # unusable candidate (bad precond, ...)

        if self.engine is not None and getattr(self.engine, "workers", 0):
            futs = []
            for c in cands:
                # pure-Python candidates would make the engine spawn its
                # process pool (~1 s of forkserver warmup) for a
                # probe-sized task; trial them inline instead
                if is_pure_python(c[0]):
                    run_inline(c)
                else:
                    futs.append((c, self.engine.submit_trial(
                        sample, (*c, None), self.trial_reps,
                        self.trial_budget_s)))
            for c, f in futs:
                try:
                    trials.append(TrialResult(*c, *f.result()))
                except Exception:
                    continue
            return trials
        for c in cands:
            run_inline(c)
        return trials


def load_decisions(path: str) -> dict[str, dict]:
    """The tuning decisions persisted in a BasketFile's TOC (may be {})."""
    from repro_torch.core.bfile import BasketFile
    f = BasketFile(path, verify=False)
    try:
        return dict(f.tuning)
    finally:
        f.close()

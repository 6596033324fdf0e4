"""Synthetic NanoAOD-like event generator — the paper's test tree.

The paper benchmarks on (a) an artificially-generated ROOT tree with 2,000
events and (b) a CMS NanoAOD file (Fig. 6).  This generator reproduces the
*structure* that drives their compression results deterministically:

* float kinematics columns (pt/eta/phi/mass) — near-incompressible mantissa
  bits, compressible exponent/sign bit-planes -> BitShuffle territory;
* small-int multiplicity and id columns — byte-sparse -> Shuffle territory;
* variable-size branches (per-event jet lists) serialized exactly like ROOT:
  a flattened payload plus a strictly-increasing **offset array** — the
  paper's §2.2 LZ4-incompressible sequence, Delta+Shuffle territory;
* monotone run/lumi/event counters.

``write_event_file`` lays these out column-wise into baskets, reproducing
Figure 1 of the paper.
"""

from __future__ import annotations

import numpy as np

from repro_torch.core import CompressionConfig, write_arrays
from repro_torch.core.policy import choose

__all__ = ["make_events", "write_event_file", "EVENT_BRANCHES"]

EVENT_BRANCHES = [
    "run", "luminosityBlock", "event",
    "nJet", "Jet_pt", "Jet_eta", "Jet_phi", "Jet_mass", "Jet_jetId",
    "Jet_offsets",
    "nMuon", "Muon_pt", "Muon_eta", "Muon_phi", "Muon_charge",
    "Muon_offsets",
    "MET_pt", "MET_phi",
]


def make_events(n_events: int = 2000, seed: int = 0) -> dict[str, np.ndarray]:
    rng = np.random.default_rng(seed)
    run = np.full(n_events, 362_104, np.uint32)
    lumi = (np.arange(n_events, dtype=np.uint32) // 500) + 1
    event = np.arange(1, n_events + 1, dtype=np.uint64) * 7 + 13

    njet = rng.poisson(6.0, n_events).clip(0, 32).astype(np.int32)
    total_jets = int(njet.sum())
    # pt: falling spectrum; eta: central; phi: uniform — realistic value stats
    jet_pt = (20.0 + rng.exponential(35.0, total_jets)).astype(np.float32)
    jet_eta = rng.normal(0.0, 2.0, total_jets).clip(-4.7, 4.7).astype(np.float32)
    jet_phi = rng.uniform(-np.pi, np.pi, total_jets).astype(np.float32)
    jet_mass = np.abs(rng.normal(12.0, 6.0, total_jets)).astype(np.float32)
    jet_id = rng.integers(0, 7, total_jets, dtype=np.int32)
    jet_off = np.concatenate([[0], np.cumsum(njet)]).astype(np.int64)

    nmu = rng.poisson(1.2, n_events).clip(0, 8).astype(np.int32)
    total_mu = int(nmu.sum())
    mu_pt = (3.0 + rng.exponential(18.0, total_mu)).astype(np.float32)
    mu_eta = rng.normal(0.0, 1.8, total_mu).clip(-2.4, 2.4).astype(np.float32)
    mu_phi = rng.uniform(-np.pi, np.pi, total_mu).astype(np.float32)
    mu_q = rng.choice(np.array([-1, 1], np.int32), total_mu)
    mu_off = np.concatenate([[0], np.cumsum(nmu)]).astype(np.int64)

    met_pt = np.abs(rng.normal(35.0, 18.0, n_events)).astype(np.float32)
    met_phi = rng.uniform(-np.pi, np.pi, n_events).astype(np.float32)

    return {
        "run": run, "luminosityBlock": lumi, "event": event,
        "nJet": njet, "Jet_pt": jet_pt, "Jet_eta": jet_eta,
        "Jet_phi": jet_phi, "Jet_mass": jet_mass, "Jet_jetId": jet_id,
        "Jet_offsets": jet_off,
        "nMuon": nmu, "Muon_pt": mu_pt, "Muon_eta": mu_eta,
        "Muon_phi": mu_phi, "Muon_charge": mu_q, "Muon_offsets": mu_off,
        "MET_pt": met_pt, "MET_phi": met_phi,
    }


def write_event_file(path: str, n_events: int = 2000, seed: int = 0,
                     profile: str = "analysis",
                     basket_bytes: int = 32 * 1024) -> dict:
    """Generate + write an event file under a codec profile; returns events."""
    events = make_events(n_events, seed)
    write_arrays(path, events,
                 cfg_for=lambda name, arr: choose(name, arr, profile),
                 target_basket_bytes=basket_bytes)
    return events

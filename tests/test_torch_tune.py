"""The port's codec tuner against the JAX package's ``repro.tune``: the
sampler and the candidate matrix are the reference's, a tuned save with
one candidate writes the reference's bytes, decisions the reference
persisted steer the port's save to the reference's file, the manager
reuses decisions across steps and re-tunes on drift, tuned token shards
read in both packages, and a tuned ``zigzag`` (a stage the reference runs
on the host only) writes the reference's bytes from a CPU tensor, loads in
both packages, and from a CUDA tensor writes the CPU tensor's bytes.

Trial timings are measured, so decisions with several candidates may
differ from run to run; the byte comparisons pin one candidate, or the
decisions themselves.  The JAX package's checkpoint module imports JAX,
so the tests that need it import it themselves (this file also runs on
the card, where JAX is absent)."""

import dataclasses
import hashlib
import json
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import tune as jtune  # noqa: E402
from repro.core.bfile import BasketFile as JaxBasketFile  # noqa: E402
from repro.data import TokenPipeline as JaxPipeline  # noqa: E402
from repro_torch import tune  # noqa: E402
from repro_torch.checkpoint import (CheckpointManager, load_pytree,  # noqa: E402
                                    save_pytree)
from repro_torch.core.bfile import BasketFile, BasketWriter  # noqa: E402
from repro_torch.data import TokenPipeline, write_token_shards  # noqa: E402

_FAST = [("zlib", 1, "none"), ("zlib", 1, "shuffle4"),
         ("zlib", 6, "bitshuffle4")]


def _jax_checkpoint():
    """The JAX package's checkpoint module (it imports JAX)."""
    pytest.importorskip("jax")
    from repro import checkpoint
    return checkpoint


def _tree(rng):
    """A state with every kind of leaf the tuner sees: float32 weights
    over several baskets, bf16 bits, offsets, ids, and leaves too small to
    tune (the static fallback)."""
    return {"params": {"w": rng.standard_normal((600, 1024)).astype(np.float32),
                       "emb": (rng.standard_normal((256, 300)).astype(np.float32)
                               .view(np.uint32) >> 16).astype(np.uint16)},
            "opt": {"count": np.int32(7),
                    "off": np.cumsum(rng.integers(0, 9, 60_000)).astype(np.int64)},
            "ids": rng.integers(-(1 << 30), 1 << 30, 50_000).astype(np.int32),
            "tiny": rng.standard_normal(100).astype(np.float32)}


_BF16 = {"params.emb"}


def _torch_tree(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        name = prefix + k
        if isinstance(v, dict):
            out[k] = _torch_tree(v, name + ".")
        else:
            t = torch.from_numpy(np.array(v))
            out[k] = t.view(torch.bfloat16) if name in _BF16 else t
    return out


def _jax_tree(tree, prefix=""):
    import jax.numpy as jnp
    out = {}
    for k, v in tree.items():
        name = prefix + k
        if isinstance(v, dict):
            out[k] = _jax_tree(v, name + ".")
        elif name in _BF16:
            out[k] = jnp.asarray(v.view(jnp.bfloat16))
        else:   # int64 stays numpy (jax holds it only with x64 on)
            out[k] = v if v.dtype == np.int64 else jnp.asarray(v)
    return out


def _data_and_toc(path):
    """(sha256 of the bytes before the TOC, the TOC's branches, the TOC's
    tuning decisions without their timings)."""
    with open(path, "rb") as fh:
        blob = fh.read()
    with BasketFile(path) as f:
        branches, tuning = f.branches, f.tuning_decisions()
    end = max(b["offset"] + b["meta"]["comp_len"]
              for e in branches.values() for b in e["baskets"])
    timeless = {n: {k: v for k, v in d.items() if k not in ("comp_s", "decomp_s")}
                for n, d in tuning.items()}
    return hashlib.sha256(blob[:end]).hexdigest(), branches, timeless


# ---------------------------------------------------------------------------
# sampler and candidates
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,itemsize,target,windows", [
    (10_000_000, 8, 1 << 16, 8), (1 << 20, 4, 1 << 15, 8), (4096, 1, 1 << 16, 8),
    (200_001, 2, 1 << 14, 3), (70_000, 8, 1 << 16, 1), (65_537, 4, 1 << 16, 8)])
def test_sampler_matches_reference(n, itemsize, target, windows):
    assert tune.sample_offsets(n, itemsize, target, windows) == \
        jtune.sample_offsets(n, itemsize, target, windows)
    buf = np.random.default_rng(n).integers(0, 256, n, dtype=np.uint8)
    a = tune.stratified_sample(buf, itemsize, target, windows)
    b = jtune.stratified_sample(buf, itemsize, target, windows)
    assert a.tobytes() == b.tobytes()
    assert tune.byte_entropy(a) == jtune.byte_entropy(b)


_ARRAYS = {
    "f32": lambda r: r.standard_normal(50_000).astype(np.float32),
    "bf16_bits": lambda r: r.integers(0, 1 << 16, 50_000).astype(np.uint16),
    "offsets": lambda r: np.cumsum(r.integers(0, 9, 50_000)).astype(np.int64),
    "int32": lambda r: r.integers(-1000, 1000, 50_000).astype(np.int32),
    "bytes": lambda r: r.integers(0, 255, 50_000).astype(np.uint8),
}


@pytest.mark.parametrize("objective", sorted(jtune.OBJECTIVES))
@pytest.mark.parametrize("kind", sorted(_ARRAYS))
def test_default_candidates_match_reference(objective, kind):
    arr = _ARRAYS[kind](np.random.default_rng(1))
    assert tune.default_candidates(arr, tune.OBJECTIVES[objective]) == \
        jtune.default_candidates(arr, jtune.OBJECTIVES[objective])
    assert dataclasses.asdict(tune.OBJECTIVES[objective]) == \
        dataclasses.asdict(jtune.OBJECTIVES[objective])


def test_selection_matches_reference():
    rows = [("lzma", 6, "shuffle8", 8.0, 3, 20), ("zstd", 8, "shuffle8", 6.0, 80, 400),
            ("zstd", 4, "shuffle8", 5.0, 200, 450), ("lz4", 1, "shuffle8", 3.0, 400, 900),
            ("zlib", 6, "none", 4.0, 30, 120)]

    def table(mod):
        n = 1 << 20
        return [mod.TrialResult(a, lv, p, n, int(n / r), n / (c * 1e6), n / (d * 1e6))
                for a, lv, p, r, c, d in rows]

    for name in jtune.OBJECTIVES:
        got, want = tune.select(table(tune), name), jtune.select(table(jtune), name)
        assert got.to_json() == want.to_json(), name
    assert [t.to_json() for t in tune.pareto_front(table(tune))] == \
        [t.to_json() for t in jtune.pareto_front(table(jtune))]


# ---------------------------------------------------------------------------
# tuned bytes against the reference's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cand", _FAST + [("zlib", 4, "delta8+shuffle8"),
                                  ("zlib", 1, "zigzag4"),
                                  ("zlib", 1, "zigzag4+shuffle4")])
@pytest.mark.parametrize("producers", [1, 2])
def test_one_candidate_tuned_bytes_equal_reference(tmp_path, rng, cand, producers):
    """One producer: the reference's data bytes, TOC and decisions (less
    their timings).  Two: the merger's branch order follows thread timing,
    so the same configs, decisions and loaded values."""
    tree = _tree(rng)
    port, ref = str(tmp_path / "port.bskt"), str(tmp_path / "ref.bskt")
    save_pytree(port, _torch_tree(tree), workers=2, producers=producers,
                tuner=tune.Tuner("checkpoint", candidates=[cand]))
    _jax_checkpoint().save_pytree(ref, _jax_tree(tree), workers=2,
                                  tuner=jtune.Tuner("checkpoint", candidates=[cand]))
    got, want = _data_and_toc(port), _data_and_toc(ref)
    assert set(got[2]) == {"params.w", "params.emb", "opt.off", "ids"}
    assert all((d["algo"], d["level"], d["precond"]) == cand
               for d in got[2].values())
    if producers == 1:
        assert got == want
        return
    assert got[2] == want[2]
    assert {n: e["config"] for n, e in got[1].items()} == \
        {n: e["config"] for n, e in want[1].items()}
    a, b = load_pytree(port, device="cpu")[0], load_pytree(ref, device="cpu")[0]
    assert sorted(a) == sorted(b)
    assert all(torch.equal(a[k], b[k]) for k in a)


def test_reference_decisions_reused_give_reference_bytes(tmp_path, rng):
    """The reference tunes and persists; the port's ``Tuner.from_file``
    reads the decisions and its save runs no trial and writes the
    reference's file, byte for byte."""
    tree = _tree(rng)
    ref, port = str(tmp_path / "ref.bskt"), str(tmp_path / "port.bskt")
    _jax_checkpoint().save_pytree(ref, _jax_tree(tree), objective="checkpoint")
    t = tune.Tuner.from_file(ref)
    assert t.objective.name == "checkpoint"
    assert set(t.decisions) == set(jtune.load_decisions(ref))
    save_pytree(port, _torch_tree(tree), tuner=t)
    assert t.stats["trials"] == 0 and t.stats["reused"] == len(t.decisions)
    with open(ref, "rb") as a, open(port, "rb") as b:
        assert hashlib.sha256(a.read()).digest() == hashlib.sha256(b.read()).digest()
    # and the other way: the port's decisions read by the reference
    port2 = str(tmp_path / "port2.bskt")
    save_pytree(port2, _torch_tree(tree), objective="max_read_tput")
    jt = jtune.Tuner.from_file(port2)
    assert jt.objective.name == "max_read_tput"
    assert {n: d.to_json() for n, d in jt.decisions.items()} == \
        json.loads(json.dumps(tune.load_decisions(port2)))


# ---------------------------------------------------------------------------
# the manager across steps
# ---------------------------------------------------------------------------

def test_manager_reuses_decisions_across_steps_and_reopen(tmp_path, rng):
    tree = _torch_tree(_tree(rng))
    mgr = CheckpointManager(str(tmp_path), tune=True, producers=2, workers=2)
    mgr._tuner.candidates = _FAST
    mgr.save(1, tree, wait=True)
    first = mgr._tuner.stats["trials"]
    assert first > 0
    mgr.save(2, tree, wait=True)
    assert mgr._tuner.stats["trials"] == first          # all reused
    got, _ = mgr.restore(2, device="cpu")
    assert torch.equal(got["params.w"], tree["params"]["w"])
    # a fresh manager (a restarted process) seeds from the latest header
    mgr2 = CheckpointManager(str(tmp_path), tune=True)
    mgr2._tuner.candidates = _FAST
    mgr2.save(3, tree, wait=True)
    assert mgr2._tuner.stats["trials"] == 0
    assert mgr2._tuner.stats["reused"] > 0
    assert tune.load_decisions(str(tmp_path / "ckpt-00000003.bskt")) == \
        jtune.load_decisions(str(tmp_path / "ckpt-00000002.bskt"))


def test_manager_retunes_on_drift(tmp_path, rng):
    tree = _torch_tree(_tree(rng))
    mgr = CheckpointManager(str(tmp_path), tune=True)
    mgr._tuner.candidates = _FAST
    mgr.save(1, tree, wait=True)
    assert mgr._tuner.stats["retuned"] == 0
    # the weights turn to zeros: the probe's entropy moves past the bound
    tree["params"]["w"] = torch.zeros_like(tree["params"]["w"])
    mgr.save(2, tree, wait=True)
    assert mgr._tuner.stats["retuned"] == 1
    got, _ = mgr.restore(2, device="cpu")
    assert not got["params.w"].any()


def test_ratio_drift_retune_matches_reference(rng):
    """The drift loop itself, the port's tuner beside the reference's."""
    arr = np.cumsum(rng.integers(1, 9, 200_000)).astype(np.int64)
    stats = []
    for mod in (tune, jtune):
        t = mod.Tuner("min_bytes", candidates=[("zlib", 1, "none"),
                                               ("zlib", 1, "shuffle8")],
                      drift_min_baskets=2, drift_ratio=0.25, drift_entropy=1e9)
        t.config_for("off", arr)
        for _ in range(4):
            t.observe("off", types.SimpleNamespace(orig_len=1 << 20,
                                                   comp_len=1 << 20))
        t.config_for("off", arr)
        t.config_for("off", arr)
        stats.append({k: v for k, v in t.stats.items() if k != "trial_s"})
    assert stats[0] == stats[1]
    assert stats[0]["retuned"] == 1 and stats[0]["reused"] == 1


# ---------------------------------------------------------------------------
# token shards, the writer
# ---------------------------------------------------------------------------

def test_tuned_token_shards_read_in_both_packages(tmp_path):
    paths = [str(tmp_path / f"s{i}.bskt") for i in range(3)]
    plain = [str(tmp_path / f"p{i}.bskt") for i in range(3)]
    t = tune.Tuner("max_read_tput", candidates=_FAST)
    write_token_shards(paths, vocab=1000, tokens_per_shard=64_000, tuner=t)
    assert t.stats["tuned"] == 1 and t.stats["reused"] == 2
    write_token_shards(plain, vocab=1000, tokens_per_shard=64_000)
    for p, q in zip(paths, plain):
        with BasketFile(p) as f, JaxBasketFile(p) as g, BasketFile(q) as h:
            want = h.read_branch("tokens")
            np.testing.assert_array_equal(f.read_branch("tokens"), want)
            np.testing.assert_array_equal(g.read_branch("tokens"), want)
            assert "tokens" in g.tuning_decisions()
    batches = []
    for pipe in (TokenPipeline(paths, batch=4, seq_len=32),
                 JaxPipeline(paths, batch=4, seq_len=32),
                 TokenPipeline(plain, batch=4, seq_len=32)):
        try:
            batches.append([next(pipe)["tokens"] for _ in range(5)])
        finally:
            pipe.close()
    for a, b, c in zip(*batches):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)
    # tune=True alone takes the reference's default objective
    write_token_shards(paths[:1], vocab=1000, tokens_per_shard=64_000, tune=True)
    assert tune.load_decisions(paths[0])["tokens"]["objective"] == "max_read_tput"


def test_writer_objective_kwarg(tmp_path, rng):
    arr = np.cumsum(rng.integers(1, 9, 100_000)).astype(np.int64)
    p = str(tmp_path / "o.bskt")
    with BasketWriter(p, objective="max_read_tput") as w:
        assert w._tuner is not None
        w._tuner.candidates = _FAST
        w.write_branch("off", arr)
    with JaxBasketFile(p) as f:
        np.testing.assert_array_equal(f.read_branch("off"), arr)
        assert "off" in f.tuning_decisions()


# ---------------------------------------------------------------------------
# zigzag: tuned decisions only, on tensors of every device
# ---------------------------------------------------------------------------

_ZIGZAG = [("zlib", 1, "zigzag4")]


def _signed_tree(rng):
    """A signed int32 tensor of small magnitudes of both signs (zigzag's
    case), an int16 one with the extremes, and float32 weights."""
    ints = rng.integers(-50_000, 50_000, 300_000).astype(np.int32)
    ints[:4] = [np.iinfo(np.int32).min, np.iinfo(np.int32).max, -1, 0]
    return {"ids": ints,
            "q": np.array([-32768, 32767, -1, 0, 1] * 9_001, np.int16),
            "w": rng.standard_normal(70_000).astype(np.float32)}


def test_tuned_zigzag_loads_in_both_packages(tmp_path, rng):
    """The port's tuned ``zigzag4`` save of CPU tensors and the reference's
    of the same values: the same data bytes and decisions, and each file
    loads in the other package bitwise."""
    tree = _signed_tree(rng)
    port, ref = str(tmp_path / "port.bskt"), str(tmp_path / "ref.bskt")
    save_pytree(port, {k: torch.from_numpy(v) for k, v in tree.items()},
                tuner=tune.Tuner("min_bytes", candidates=_ZIGZAG))
    jck = _jax_checkpoint()
    jck.save_pytree(ref, _jax_tree(tree),
                    tuner=jtune.Tuner("min_bytes", candidates=_ZIGZAG))
    got, want = _data_and_toc(port), _data_and_toc(ref)
    assert got == want
    assert {d["precond"] for d in got[2].values()} == {"zigzag4"}
    mine = load_pytree(ref, device="cpu")[0]
    theirs = jck.load_pytree(port)[0]
    for k, v in tree.items():
        assert mine[k].numpy().tobytes() == v.tobytes(), k
        assert np.asarray(theirs[k]).tobytes() == v.tobytes(), k


@pytest.mark.cuda
def test_tuned_zigzag_raises_for_a_cuda_tensor(tmp_path):
    """It raised while zigzag had no kernel; now a tuned ``zigzag4`` save
    of CUDA tensors runs the kernels and writes the CPU tensors' bytes
    (which the test above holds to the reference's), and the restore on
    the card is bitwise."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.kernels import ops
    tree = _signed_tree(np.random.default_rng(0))
    cpu = {k: torch.from_numpy(v) for k, v in tree.items()}
    gpu = {k: v.cuda() for k, v in cpu.items()}
    pc, pg = str(tmp_path / "cpu.bskt"), str(tmp_path / "gpu.bskt")
    save_pytree(pc, cpu, tuner=tune.Tuner("min_bytes", candidates=_ZIGZAG))
    ops.reset_launch_counts()
    save_pytree(pg, gpu, tuner=tune.Tuner("min_bytes", candidates=_ZIGZAG))
    assert ops.launch_counts()["zigzag"] > 0
    assert _data_and_toc(pg) == _data_and_toc(pc)
    back = load_pytree(pg, device="cuda")[0]
    assert ops.launch_counts()["unzigzag"] > 0
    for k, v in gpu.items():
        assert torch.equal(back[k].view(torch.uint8), v.view(torch.uint8)), k

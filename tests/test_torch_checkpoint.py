"""The port's checkpoint on the CPU, byte for byte against the JAX package:
the same values saved by both give the same container, the ``ckpt_pr2``
golden checkpoint comes back from torch tensors, files load across the two
packages both ways, an async save is immune to in-place updates, and the
entry points refuse to land on the CPU unasked."""

import hashlib
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.checkpoint import load_pytree as jax_load  # noqa: E402
from repro.checkpoint import save_pytree as jax_save  # noqa: E402
from repro.core.bfile import BasketFile as JaxBasketFile  # noqa: E402
from repro_torch.checkpoint import (CheckpointManager, load_pytree,  # noqa: E402
                                    save_pytree, tree_from_numpy)
from repro_torch.core.bfile import CorruptBasketError  # noqa: E402
from repro_torch.core.codec import HAVE_ZSTD  # noqa: E402

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")


def _host_tree(rng):
    """The mixed state, as numpy (bf16 leaves as uint16 bit patterns: the
    top half of a float32)."""
    bf16_bits = (rng.standard_normal((64, 300)).astype(np.float32)
                 .view(np.uint32) >> 16).astype(np.uint16)
    return {
        "params": {"w": rng.standard_normal((300, 257)).astype(np.float32),
                   "big_row": rng.standard_normal((3, 300_000)).astype(np.float32)},
        "opt": {"m": bf16_bits, "zeros": np.zeros((128, 64), np.uint16),
                "count": np.int32(7)},
        "offsets": np.cumsum(rng.integers(0, 9, 60_000)).astype(np.int64),
        "ids": rng.integers(-(1 << 30), 1 << 30, 50_000).astype(np.int32),
        "scalar": np.float32(3.25),
        "empty": np.zeros((0, 3), np.int32),
    }


_BF16 = ["opt.m", "opt.zeros"]


def _as_jax(host):
    """The JAX package's state: jax arrays, bf16 as bf16.  The int64 leaf
    stays numpy (jax holds int64 only with x64 on); it fits one basket, so
    both packages probe all of it."""
    def j(a):
        return jnp.asarray(a)

    def bf(a):
        return jnp.asarray(a.view(jnp.bfloat16))

    return {"params": {"w": j(host["params"]["w"]),
                       "big_row": j(host["params"]["big_row"])},
            "opt": {"m": bf(host["opt"]["m"]), "zeros": bf(host["opt"]["zeros"]),
                    "count": j(host["opt"]["count"])},
            "offsets": host["offsets"], "ids": j(host["ids"]),
            "scalar": j(host["scalar"]), "empty": j(host["empty"])}


def _toc(path):
    with JaxBasketFile(path) as f:
        return f.branches


@pytest.mark.parametrize("staging", ["stream", "gather"])
def test_cpu_tensor_save_equals_jax_save(tmp_path, rng, staging):
    host = _host_tree(rng)
    jp, tp = str(tmp_path / "jax.bskt"), str(tmp_path / "torch.bskt")
    jax_save(jp, _as_jax(host), staging=staging)
    save_pytree(tp, tree_from_numpy(host, "cpu", bf16=_BF16), staging=staging)
    assert open(tp, "rb").read() == open(jp, "rb").read()
    toc = _toc(tp)
    # hazard: bf16 is probed as its uint16 pattern (shuffle2; all-zero reads
    # as offset-like), floats bitshuffle, big rows are one basket each
    assert toc["opt.m"]["config"]["precond"] == "shuffle2"
    assert toc["opt.zeros"]["config"]["precond"] == "delta2+shuffle2"
    assert toc["params.w"]["config"]["precond"] == "bitshuffle4"
    assert toc["offsets"]["config"]["precond"] == "delta8+shuffle8"
    assert len(toc["params.big_row"]["baskets"]) == 3
    assert toc["params.w"]["dtype"] == "<f4" and toc["opt.m"]["dtype"] == "<u2"


def _golden_tree():
    rng = np.random.default_rng(42)
    rng.standard_normal(40_000)          # advance the stream as test_zerocopy does
    rng.integers(1, 9, 30_000)
    rng.integers(0, 255, 50_000)
    return {"w": rng.standard_normal((300, 257)).astype(np.float32),
            "emb": {"table": rng.integers(0, 1 << 20, 70_000).astype(np.int64)},
            "step": np.int64(123)}


@pytest.mark.parametrize("staging", ["stream", "gather"])
@pytest.mark.parametrize("workers", [0, 4])
def test_golden_ckpt_from_cpu_tensors(tmp_path, staging, workers):
    """tests/golden/ckpt_pr2.bskt from torch tensors.  Its ``__meta__`` blob
    takes the default codec, zstd where the zstandard wheel is installed, so
    the whole file's sha holds only without it; the data baskets before the
    blob and their TOC entries must match everywhere."""
    man = json.load(open(os.path.join(GOLDEN, "container_manifest.json")))
    golden = open(os.path.join(GOLDEN, "ckpt_pr2.bskt"), "rb").read()
    p = str(tmp_path / "c.bskt")
    save_pytree(p, tree_from_numpy(_golden_tree(), "cpu"), profile="analysis",
                workers=workers, staging=staging)
    blob = open(p, "rb").read()
    want, got = _toc(os.path.join(GOLDEN, "ckpt_pr2.bskt")), _toc(p)
    meta_at = want["__meta__"]["baskets"][0]["offset"]
    assert blob[:meta_at] == golden[:meta_at]
    assert {k: v for k, v in got.items() if k != "__meta__"} == \
        {k: v for k, v in want.items() if k != "__meta__"}
    if not HAVE_ZSTD:
        assert hashlib.sha256(blob).hexdigest() == man["ckpt_pr2.bskt"]


def _assert_same(flat_torch: dict, host_flat: dict):
    for k, v in host_flat.items():
        t = flat_torch[k]
        got = t.view(torch.int16).numpy().view(np.uint16) if t.dtype == torch.bfloat16 \
            else t.numpy()
        np.testing.assert_array_equal(got, np.asarray(v), err_msg=k)
        assert got.shape == np.asarray(v).shape


def _host_flat(host):
    out = {}
    for k, v in host.items():
        if isinstance(v, dict):
            out.update({f"{k}.{kk}": vv for kk, vv in v.items()})
        else:
            out[k] = v
    return out


def test_jax_file_loads_in_port(tmp_path, rng):
    host = _host_tree(rng)
    p = str(tmp_path / "j.bskt")
    jax_save(p, _as_jax(host), workers=2)
    flat, meta = load_pytree(p, device="cpu")
    assert sorted(meta["bf16"]) == sorted(_BF16)
    assert flat["opt.m"].dtype == torch.bfloat16
    _assert_same(flat, _host_flat(host))
    tree, _ = load_pytree(p, template=host, device="cpu", workers=0)
    assert torch.equal(tree["params"]["w"], torch.from_numpy(host["params"]["w"]))


def test_port_file_loads_in_jax(tmp_path, rng):
    host = _host_tree(rng)
    p = str(tmp_path / "t.bskt")
    save_pytree(p, tree_from_numpy(host, "cpu", bf16=_BF16), workers=2)
    flat, meta = jax_load(p)
    assert sorted(meta["bf16"]) == sorted(_BF16)
    for k, v in _host_flat(host).items():
        got = np.asarray(flat[k])
        if k in _BF16:
            got = got.view(np.uint16)
        np.testing.assert_array_equal(got, np.asarray(v), err_msg=k)


def test_async_save_ignores_inplace_update(tmp_path, rng):
    """torch updates in place: after save() returns, an update to the tree
    must not reach the file (the manager snapshots first)."""
    host = _host_tree(rng)
    state = tree_from_numpy(host, "cpu", bf16=_BF16)
    mgr = CheckpointManager(str(tmp_path), workers=2)
    mgr.save(1, state)                      # returns before the write ends
    state["params"]["w"].add_(1.0)
    state["opt"]["m"].mul_(2)
    state["ids"].zero_()
    mgr.wait()
    flat, _ = mgr.restore(device="cpu")
    _assert_same(flat, _host_flat(host))
    assert mgr.latest_step() == 1


def test_default_device_is_the_gpu(tmp_path, rng):
    """With no card, the entry points raise rather than return CPU tensors."""
    p = str(tmp_path / "c.bskt")
    save_pytree(p, {"x": torch.arange(10)})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        load_pytree(p)
    mgr = CheckpointManager(str(tmp_path / "m"))
    mgr.save(3, {"x": torch.arange(10)}, wait=True)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mgr.restore()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tree_from_numpy({"x": np.zeros(3)})


def test_parity_heals_a_rotted_basket(tmp_path, rng):
    x = torch.from_numpy(rng.standard_normal(600_000).astype(np.float32))
    p = str(tmp_path / "h.bskt")
    save_pytree(p, {"x": x}, parity=2)
    b = _toc(p)["x"]["baskets"][1]
    with open(p, "r+b") as fh:               # flip bytes inside a payload
        fh.seek(b["offset"] + 40)
        fh.write(b"\xff" * 16)
    with pytest.raises(CorruptBasketError):
        load_pytree(p, device="cpu", heal=None)
    flat, _ = load_pytree(p, device="cpu", heal="auto")
    assert torch.equal(flat["x"], x)


def test_prefetching_restore_is_bitwise(tmp_path, rng):
    """``load_pytree(prefetch=2)`` gives the tensors of ``prefetch=0`` bit
    for bit, and the values the reference's ``load_pytree(prefetch=2)``
    reads from the same file."""
    tree = tree_from_numpy(_host_tree(rng), device="cpu", bf16=["opt.m"])
    p = str(tmp_path / "c.bskt")
    save_pytree(p, tree)
    plain, meta0 = load_pytree(p, device="cpu", prefetch=0)
    ahead, meta2 = load_pytree(p, device="cpu", prefetch=2, workers=2)
    ref, _ = jax_load(p, prefetch=2)
    assert meta0 == meta2 and plain.keys() == ahead.keys() == ref.keys()
    for k in plain:
        assert ahead[k].dtype == plain[k].dtype
        assert torch.equal(ahead[k].reshape(-1).view(torch.uint8),
                           plain[k].reshape(-1).view(torch.uint8)), k
        want = np.asarray(ref[k])
        if ahead[k].dtype == torch.bfloat16:
            want = want.view(np.uint16)
            got = ahead[k].view(torch.uint16).numpy()
        else:
            got = ahead[k].numpy()
        assert np.array_equal(got, want), k

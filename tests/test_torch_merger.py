"""The port's buffer merger against the JAX package's: several producer
threads fill BasketBuffers that one BufferMerger drains into one file,
``merge_files`` splices the same inputs into the same bytes in both
packages, ``save_pytree(producers>1)`` loads equal in both, and a save
through the forkserver pool leaves no process behind.

Every wait has a timeout.  With producers > 1 the branch order (hence the
container's bytes) depends on thread timing, so those files are compared
by what they load, not by sha256."""

import hashlib
import os
import subprocess
import sys
import textwrap
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.bfile import BasketFile as JaxBasketFile  # noqa: E402
from repro.core.bfile import write_arrays as jax_write_arrays  # noqa: E402
from repro.io import merge_files as jax_merge_files  # noqa: E402
from repro_torch.checkpoint import load_pytree, save_pytree  # noqa: E402
from repro_torch.core import CompressionConfig  # noqa: E402
from repro_torch.core.bfile import BasketFile  # noqa: E402
from repro_torch.io import BasketBuffer, BufferMerger, merge_files  # noqa: E402

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                   "src")
JOIN_S = 60


def _sha(path) -> str:
    with open(path, "rb") as fh:
        return hashlib.sha256(fh.read()).hexdigest()


def _join_all(threads):
    for t in threads:
        t.join(timeout=JOIN_S)
    assert not any(t.is_alive() for t in threads)


def _jax_checkpoint():
    """The JAX package's checkpoint module (it imports JAX)."""
    pytest.importorskip("jax")
    from repro import checkpoint
    return checkpoint


@pytest.mark.parametrize("workers", [0, 2])
def test_merger_multi_producer_roundtrip(tmp_path, rng, workers):
    base = rng.standard_normal(50_000).astype(np.float32)
    offs = np.cumsum(rng.integers(1, 9, 30_000)).astype(np.int64)
    path = str(tmp_path / "m.bskt")
    errors = []
    with BufferMerger(path, workers=workers) as m:
        def produce(k):
            try:
                buf = m.buffer()
                buf.write_branch(f"shard{k}", base + k,
                                 CompressionConfig("zlib", 3, "bitshuffle4"),
                                 32 * 1024)
                buf.write_branch(f"off{k}", offs + k,
                                 CompressionConfig("zlib", 1, "delta8+shuffle8"),
                                 16 * 1024)
                m.merge(buf)
            except Exception as e:  # surfaced below
                errors.append(e)

        threads = [threading.Thread(target=produce, args=(k,)) for k in range(6)]
        for t in threads:
            t.start()
        _join_all(threads)
    assert not errors
    for f in (BasketFile(path), JaxBasketFile(path)):
        with f:
            assert sorted(f.branch_names()) == sorted(
                [f"shard{k}" for k in range(6)] + [f"off{k}" for k in range(6)])
            for k in range(6):
                np.testing.assert_array_equal(f.read_branch(f"shard{k}"), base + k)
                np.testing.assert_array_equal(f.read_branch(f"off{k}"), offs + k)


def test_merger_keeps_buffered_payloads(tmp_path, rng):
    """Merged payload bytes equal the buffered (pre-compressed) ones."""
    path = str(tmp_path / "nr.bskt")
    buf = BasketBuffer()
    buf.write_branch("f", rng.standard_normal(40_000).astype(np.float32),
                     CompressionConfig("zlib", 5, "shuffle4"), 32 * 1024)
    payloads = list(buf._payloads["f"])
    with BufferMerger(path) as m:
        m.merge(buf, clear=False)
    with BasketFile(path) as f:
        got = [f.read_basket_payload("f", i)
               for i in range(len(f.branches["f"]["baskets"]))]
    assert got == payloads and len(got) > 1


@pytest.mark.parametrize("rename", [False, True])
def test_merge_files_same_bytes_as_reference(tmp_path, rng, rename):
    ins = []
    for i, (name, arr, cfg) in enumerate([
            ("a", rng.standard_normal(30_000).astype(np.float32),
             CompressionConfig("zlib", 5, "bitshuffle4")),
            ("b", np.cumsum(rng.integers(0, 7, 30_000)).astype(np.int64),
             CompressionConfig("zlib", 1, "delta8+shuffle8")),
            ("c", rng.integers(0, 255, 20_000).astype(np.uint8),
             CompressionConfig("lzma", 1, "none"))]):
        p = str(tmp_path / f"in{i}.bskt")
        jax_write_arrays(p, {name: arr}, lambda n, a, c=cfg: c,
                         target_basket_bytes=16 * 1024)
        ins.append(p)
    fn = (lambda path, branch: f"{os.path.basename(path)}:{branch}") \
        if rename else None
    port, ref = str(tmp_path / "port.bskt"), str(tmp_path / "ref.bskt")
    merge_files(port, ins, rename=fn)
    jax_merge_files(ref, ins, rename=fn)
    assert _sha(port) == _sha(ref)
    with BasketFile(port) as f:
        assert len(f.branch_names()) == 3
        assert f.compressed_bytes() == sum(BasketFile(p).compressed_bytes()
                                           for p in ins)


def _tree(rng):
    bf16 = torch.from_numpy(rng.standard_normal((96, 300)).astype(np.float32)
                            ).to(torch.bfloat16)
    return {"params": {"w": torch.from_numpy(
                rng.standard_normal((300, 1030)).astype(np.float32)),
                       "emb": bf16},
            "opt": {"count": torch.tensor(7, dtype=torch.int32),
                    "offsets": torch.from_numpy(np.cumsum(
                        rng.integers(0, 9, 60_000)).astype(np.int64))},
            "ids": torch.from_numpy(rng.integers(-(1 << 30), 1 << 30, 50_000)
                                    .astype(np.int32)),
            "step": torch.tensor(3, dtype=torch.int64)}


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


def test_save_pytree_producers_loads_equal_in_both_packages(tmp_path, rng):
    tree = _tree(rng)
    p = str(tmp_path / "prod.bskt")
    stats = save_pytree(p, tree, producers=3, workers=2)
    want = _flat(tree)
    assert stats["branches"] == len(want)
    flat, meta = load_pytree(p, device="cpu")
    assert meta["bf16"] == ["params.emb"]
    assert sorted(flat) == sorted(want)
    for k, v in want.items():
        assert flat[k].dtype == v.dtype and torch.equal(flat[k], v), k
    jflat, _ = _jax_checkpoint().load_pytree(p)
    for k, v in want.items():
        got = np.asarray(jflat[k])
        if v.dtype == torch.bfloat16:
            got, v = got.view(np.uint16), v.view(torch.int16).numpy().view(np.uint16)
        else:
            v = v.numpy()
        np.testing.assert_array_equal(got, v, err_msg=k)


def test_save_pytree_producers_reads_the_reference_producers_save(tmp_path, rng):
    tree = _tree(rng)
    host = {k: (v.view(torch.int16).numpy().view(np.uint16)
                if v.dtype == torch.bfloat16 else v.numpy())
            for k, v in _flat(tree).items()}
    p = str(tmp_path / "jprod.bskt")
    _jax_checkpoint().save_pytree(p, host, producers=3, workers=2)
    flat, _ = load_pytree(p, device="cpu")
    for k, v in host.items():
        np.testing.assert_array_equal(flat[k].numpy(), v, err_msg=k)


def test_producer_error_propagates(tmp_path):
    tree = {"a": torch.arange(10), "b": torch.zeros(4, dtype=torch.complex64),
            "c": torch.arange(5)}
    with pytest.raises(TypeError, match="no container dtype"):
        save_pytree(str(tmp_path / "bad.bskt"), tree, producers=2)
    assert not os.path.exists(tmp_path / "bad.bskt")
    assert not [t for t in threading.enumerate()
                if t.name.startswith("ckpt-producer") and t.is_alive()]


_CHILD = textwrap.dedent("""
    import multiprocessing.forkserver as fs, os, sys
    import numpy as np, torch
    from repro_torch.checkpoint import load_pytree, save_pytree
    rng = np.random.default_rng(0)
    tree = {"w": torch.from_numpy(rng.standard_normal((64, 4096)).astype(np.float32)),
            "i": torch.arange(100_000, dtype=torch.int32)}
    p = os.path.join(sys.argv[1], "c.bskt")
    # profile "analysis" is lz4, a pure-Python codec: the engine's
    # forkserver process pool compresses it
    save_pytree(p, tree, profile="analysis", producers=2, workers=2)
    flat, _ = load_pytree(p, device="cpu")
    assert all(torch.equal(flat[k], v) for k, v in tree.items())
    print("forkserver", fs._forkserver._forkserver_pid)
""")


def _session_members(sid: int) -> list:
    """Live processes (not zombies) whose session id is ``sid``."""
    out = []
    for pid in os.listdir("/proc"):
        if not pid.isdigit():
            continue
        try:
            with open(f"/proc/{pid}/stat") as fh:
                stat = fh.read()
        except OSError:
            continue
        fields = stat[stat.rindex(")") + 2:].split()
        if int(fields[3]) == sid and fields[0] not in "ZX":
            out.append(int(pid))
    return out


def test_forkserver_save_leaves_no_process(tmp_path):
    env = dict(os.environ, PYTHONPATH=SRC)
    child = subprocess.Popen([sys.executable, "-c", _CHILD, str(tmp_path)],
                             env=env, stdout=subprocess.PIPE,
                             stderr=subprocess.PIPE, text=True,
                             start_new_session=True)
    try:
        out, err = child.communicate(timeout=120)
    finally:
        if child.poll() is None:
            os.killpg(child.pid, 9)
            child.wait(timeout=30)
    assert child.returncode == 0, err[-3000:]
    fs_pid = out.split("forkserver ")[-1].strip()
    assert fs_pid.isdigit(), out          # the forkserver pool really ran
    deadline = time.monotonic() + 5.0
    left = _session_members(child.pid)
    while left and time.monotonic() < deadline:
        time.sleep(0.1)
        left = _session_members(child.pid)
    assert not left, f"processes of the child's session still alive: {left}"

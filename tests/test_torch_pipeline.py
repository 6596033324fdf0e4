"""The port's token pipeline and decompress-ahead reader against the JAX
package's: the same seed writes byte-identical shards, both pipelines hand
out the same batches, the restart cursor moves between them in both
directions, and ``BasketFile(prefetch=k)`` reads what ``prefetch=0``
reads.  Integer outputs: compared exactly."""

import numpy as np
import pytest

from repro.core.bfile import BasketWriter as JaxWriter
from repro.data import TokenPipeline as JaxPipeline
from repro.data import write_token_shards as jax_write_shards
from repro_torch.core.bfile import BasketFile, BasketWriter
from repro_torch.core.policy import choose
from repro_torch.data import TokenPipeline, write_token_shards
from repro_torch.io import PrefetchReader

VOCAB, TOKENS = 512, 6000
BATCH, SEQ = 4, 32


@pytest.fixture(scope="module")
def shards(tmp_path_factory):
    d = tmp_path_factory.mktemp("shards")
    port = [str(d / f"port-{i}.bskt") for i in range(3)]
    ref = [str(d / f"ref-{i}.bskt") for i in range(3)]
    write_token_shards(port, vocab=VOCAB, tokens_per_shard=TOKENS, seed=5)
    jax_write_shards(ref, vocab=VOCAB, tokens_per_shard=TOKENS, seed=5)
    return port, ref


def _take(pipe, n: int) -> list[dict]:
    try:
        return [next(pipe) for _ in range(n)]
    finally:
        pipe.close()


def _equal(a: list[dict], b: list[dict]) -> None:
    assert len(a) == len(b)
    for i, (x, y) in enumerate(zip(a, b)):
        assert sorted(x) == sorted(y) == ["targets", "tokens"]
        for k in x:
            assert x[k].dtype == y[k].dtype == np.int32, (i, k)
            assert np.array_equal(x[k], y[k]), (i, k)


def test_shards_are_byte_identical(shards):
    for p, r in zip(*shards):
        with open(p, "rb") as a, open(r, "rb") as b:
            assert a.read() == b.read(), p


# 3 shards of 181 windows: 45 batches a shard, so 140 batches cross every
# shard boundary and start the second epoch
@pytest.mark.parametrize("host_id,n_hosts", [(0, 1), (1, 2)])
def test_pipelines_give_the_same_batches(shards, host_id, n_hosts):
    port, ref = shards
    kw = dict(batch=BATCH, seq_len=SEQ, host_id=host_id, n_hosts=n_hosts)
    a = _take(TokenPipeline(port, **kw), 140)
    b = _take(JaxPipeline(port, **kw), 140)
    _equal(a, b)
    assert a[0]["tokens"].shape == (BATCH, SEQ)
    assert np.array_equal(a[0]["targets"][:, :-1], a[0]["tokens"][:, 1:])


@pytest.mark.parametrize("first", ["port", "reference"])
@pytest.mark.parametrize("at", [3, 44, 46])
def test_cursor_round_trips_across_the_packages(shards, first, at):
    """One package's ``state_dict()`` after ``at`` batches, loaded into the
    other's pipeline, continues the uninterrupted stream."""
    port, _ = shards
    kinds = {"port": TokenPipeline, "reference": JaxPipeline}
    other = "reference" if first == "port" else "port"
    kw = dict(batch=BATCH, seq_len=SEQ)
    stream = _take(kinds[first](port, **kw), at + 8)
    p1 = kinds[first](port, **kw)
    try:
        _equal([next(p1) for _ in range(at)], stream[:at])
        cursor = p1.state_dict()
    finally:
        p1.close()
    p2 = kinds[other](port, **kw)
    p2.load_state_dict(dict(cursor))
    assert p2.state_dict() == cursor
    _equal(_take(p2, 8), stream[at:])


def test_prefetch_reads_what_a_plain_read_reads(tmp_path):
    rng = np.random.default_rng(2)
    arrays = {"f": rng.standard_normal(700_000).astype(np.float32),
              "i": np.cumsum(rng.integers(0, 5, 500_000)).astype(np.int64),
              "m": rng.standard_normal((3000, 97)).astype(np.float32)}
    p = str(tmp_path / "a.bskt")
    with BasketWriter(p) as w:
        for k, v in arrays.items():
            w.write_branch(k, v, choose(k, v), target_basket_bytes=1 << 18)
    with BasketFile(p) as plain, BasketFile(p, prefetch=4, workers=2) as pre:
        for k, v in arrays.items():
            assert len(pre.branches[k]["baskets"]) > 1, k
            assert np.array_equal(pre.read_branch(k), v)
            assert np.array_equal(pre.read_branch(k), plain.read_branch(k))
            n = v.shape[0]
            for lo, hi in ((0, 10), (n // 3, n // 3 + 70_001), (n - 5, n)):
                assert np.array_equal(pre.read_entries(k, lo, hi), v[lo:hi])
    with BasketFile(p) as f:
        r = PrefetchReader(f, "i", ahead=2)
        try:
            assert np.array_equal(r.read_all(), arrays["i"])
            assert bytes(r.basket(1)) == f.read_basket_raw("i", 1)
            assert r.hits + r.misses > 0
        finally:
            r.close()


def test_reads_a_reference_written_file_with_prefetch(tmp_path):
    v = np.random.default_rng(3).integers(0, 1 << 30, 400_000).astype(np.int32)
    p = str(tmp_path / "r.bskt")
    with JaxWriter(p) as w:
        w.write_branch("x", v, target_basket_bytes=1 << 17)
    with BasketFile(p, prefetch=3) as f:
        assert np.array_equal(f.read_branch("x"), v)


def test_unported_options_raise():
    pipe = TokenPipeline(["repro://localhost:1/x.bskt"], batch=BATCH, seq_len=SEQ)
    try:
        with pytest.raises(NotImplementedError, match="ROADMAP.md A9"):
            next(pipe)
    finally:
        pipe.close()

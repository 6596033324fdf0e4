"""The port's model under a mesh, on real values: gloo CPU ranks run the
mesh form of the model (its state as DTensors on the sharding rules'
placements, ``activation_context(mesh)``, as the dry run runs it) and hold
it against the plain port on the same float32 weights, in the same
process:

  * the loss and its gradients (``model.loss``; the vocab-parallel
    cross-entropy, ``constrain``'s gradient layout, ZeRO-3's weight gather);
  * a train step with compressed gradients (``make_train_step``; the
    error feedback's ``_sub_product`` on DTensors, which also gives the
    same bits as on whole tensors);
  * a prefill into a longer cache and two decode steps, one into each TP
    rank's half of the cache's slots (the per-head kv expansion, the
    time-split cache written slot by slot and read with the flash-decode
    combine).

Cases: the reduced qwen3-8b with its two kv heads (split over TP) and with
one (MQA: TP splits the query heads, and the cache by time), on (1, 2) and
(2, 2) meshes; ``tests/test_torch_mesh_families.py`` runs the reduced
jamba (attention, Mamba and MoE layers) and rwkv6 on (2, 2) the same way.  Tolerances: the mesh form sums in other orders (the TP
reductions, the sharded products), so float32 values agree to rounding
amplified through the layers; each is stated where it is checked.

The ranks are this file run as a script (``python test_torch_mesh_model.py
<case> <rank> <world> <dir>``), meeting through a ``FileStore``; each
launch leads a session of its own, has a timeout, and is killed as a group
on timeout or failure."""

import contextlib
import dataclasses
import os
import signal
import subprocess
import sys
import time

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "src")
TIMEOUT_S = 120

# case -> (arch, kv heads (None: the reduced config's), mesh)
CASES = {
    "qwen3-gqa-1x2": ("qwen3-8b", None, (1, 2)),
    "qwen3-mqa-1x2": ("qwen3-8b", 1, (1, 2)),
    "qwen3-gqa-2x2": ("qwen3-8b", None, (2, 2)),
    "qwen3-mqa-2x2": ("qwen3-8b", 1, (2, 2)),
    "jamba-2x2": ("jamba-v0.1-52b", None, (2, 2)),
    "rwkv6-2x2": ("rwkv6-1.6b", None, (2, 2)),
}
B, S, PROMPT, MAX_LEN = 4, 16, 15, 32


def _start(case: str, workdir: str) -> list:
    dp, tp = CASES[case][2]
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    return [subprocess.Popen([sys.executable, __file__, case, str(r), str(dp * tp), workdir],
                             env=env, cwd=ROOT, stdout=subprocess.PIPE,
                             stderr=subprocess.PIPE, text=True, start_new_session=True)
            for r in range(dp * tp)]


def run_cases(cases, tmp_path_factory) -> dict:
    """{case: the first failing rank's stderr, or None}: every case's ranks
    run at once, each case in a directory of its own."""
    dirs = {c: str(tmp_path_factory.mktemp(c)) for c in cases}
    procs = {}
    out = {}
    deadline = time.monotonic() + TIMEOUT_S
    try:
        for c in cases:
            procs[c] = _start(c, dirs[c])
        for c, ps in procs.items():
            errs = []
            for p in ps:
                _, err = p.communicate(timeout=max(deadline - time.monotonic(), 1))
                if p.returncode:
                    errs.append(err[-4000:])
            out[c] = errs[0] if errs else None
    finally:
        for ps in procs.values():
            for p in ps:
                if p.poll() is None:
                    os.killpg(p.pid, signal.SIGKILL)
                    p.communicate()
    return out


DENSE = ("qwen3-gqa-1x2", "qwen3-mqa-1x2", "qwen3-gqa-2x2", "qwen3-mqa-2x2")


@pytest.fixture(scope="module")
def outcomes(tmp_path_factory):
    return run_cases(DENSE, tmp_path_factory)


@pytest.mark.parametrize("case", DENSE)
def test_mesh_model_matches_plain(case, outcomes):
    assert outcomes[case] is None, outcomes[case]


# ---------------------------------------------------------------------------
# the ranks (this file as a script)
# ---------------------------------------------------------------------------

def _full(t):
    from torch.distributed.tensor import DTensor
    return t.full_tensor() if isinstance(t, DTensor) else t


def _rel(got, want) -> float:
    """||got - want|| / ||want|| (a DTensor gathered first)."""
    import torch
    got, want = _full(got).double(), _full(want).double()
    assert got.shape == want.shape, (got.shape, want.shape)
    return (torch.linalg.vector_norm(got - want)
            / torch.linalg.vector_norm(want).clamp_min(1e-300)).item()


def _within(name, got, want, sens: float, floor: float = 1e-5) -> None:
    """``got`` (the mesh form) within 10 times ``sens`` of ``want`` (the
    plain port), in norm: ``sens`` is how far the plain port moves the
    same quantity when a weight in two moves by one float32 ulp."""
    err = _rel(got, want)
    assert err <= max(floor, 10 * sens), (name, err, sens)


def _far(got, want, tol) -> int:
    """How many elements of ``got`` lie further than ``tol`` from ``want``."""
    return int(((_full(got).double() - want.double()).abs() > tol).sum())


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{path}.{k}" if path else k)
    else:
        yield path, tree


def _check(case: str, rank: int, workdir: str) -> None:
    import torch
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.configs import ShapeSpec, get_config, reduced
    from repro_torch.launch.dryrun import _map
    from repro_torch.launch.mesh import _mesh
    from repro_torch.launch.specs import build_cell, parallelism_for
    from repro_torch.models import Model
    from repro_torch.parallel import activation_context
    from repro_torch.parallel.sharding import (batch_shardings, cache_shardings,
                                               param_shardings, shard_tensor)
    from repro_torch.train.step import _quantize_ef, init_train_state, make_train_step

    arch, kv, mesh_shape = CASES[case]
    cfg = reduced(get_config(arch))
    # float32; one group of layers (a stack of one: the rules' "layers" dim)
    cfg = dataclasses.replace(cfg, dtype="float32", n_layers=len(cfg.pattern))
    if kv:
        cfg = dataclasses.replace(cfg, n_kv_heads=kv, n_heads=kv * (cfg.n_heads // cfg.n_kv_heads))
    model = Model(cfg)
    mesh = _mesh("cpu", mesh_shape, ("data", "model"))
    pcfg = parallelism_for(cfg)

    def lay_out(tree, sh):
        return _map(lambda t, s: shard_tensor(t, s)
                    if isinstance(t, torch.Tensor) and s is not None else t, tree, sh)

    @contextlib.contextmanager
    def meshed():
        with implicit_replication(), activation_context(mesh):
            yield

    gen = torch.Generator().manual_seed(0)
    toks = torch.randint(0, cfg.vocab, (B, S + 1), generator=gen, dtype=torch.int32)
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
    kw = {"accum": 1, "compress_grads": True, "warmup": 0}
    cell = build_cell(cfg, ShapeSpec("train", S, B, "train"), mesh, pcfg, dict(kw))
    state_sh, batch_sh = cell.in_shardings
    state = init_train_state(model, torch.Generator().manual_seed(1), compress_grads=True)
    _tame(model, state.params)
    names = [n for n, _ in _leaves(state.params)]
    # the plain port's sensitivity: a one-ulp move of about half the weights
    g2 = torch.Generator().manual_seed(2)
    nudged = dataclasses.replace(state, params=_unflat(names, [
        p * (1 + 2.0 ** -24 * torch.randn(p.shape, generator=g2))
        for _, p in _leaves(state.params)]))
    dstate, dbatch = lay_out(state, state_sh), lay_out(batch, batch_sh)

    # -- loss and gradients -------------------------------------------------
    def loss_grads(params, bt):
        leaves = [p.detach().requires_grad_() for _, p in _leaves(params)]
        loss, metrics = model.loss(_unflat(names, leaves), bt)
        return loss, metrics, torch.autograd.grad(loss, leaves)

    loss, metrics, grads = loss_grads(state.params, batch)
    nloss, _, ngrads = loss_grads(nudged.params, batch)
    with meshed():
        dloss, dmetrics, dgrads = loss_grads(dstate.params, dbatch)
    _within("loss", dloss, loss, _rel(nloss, loss))
    assert _full(dmetrics["accuracy"]).item() == metrics["accuracy"].item()
    sens = max(_rel(n, g) for n, g in zip(ngrads, grads))
    for n, g, dg in zip(names, grads, dgrads):
        _within(f"grad {n}", dg, g, sens)

    # the error feedback on DTensors is elementwise but for its amax: the
    # same bits as on whole tensors
    for n, g, e in zip(names, grads, (e for _, e in _leaves(state.err))):
        sh = dict(_leaves(state_sh.params))[n]
        deq, err = _quantize_ef(g, e)
        ddeq, derr = _quantize_ef(shard_tensor(g, sh), shard_tensor(e, sh))
        assert torch.equal(_full(ddeq), deq) and torch.equal(_full(derr), err), n

    # -- a train step with compressed gradients -----------------------------
    # a weight whose int8 gradient rounds the other way moves by up to the
    # learning rate: count the weights and residuals that move further than
    # rounding, against the nudged plain steps' count
    step = make_train_step(model, **kw)
    s1, m1 = step(state, batch)
    n1, nm1 = step(nudged, batch)
    with meshed():
        d1, dm1 = cell.fn(dstate, dbatch)
    _within("step grad norm", dm1["grad_norm"], m1["grad_norm"],
            _rel(nm1["grad_norm"], m1["grad_norm"]))
    lr, eps = 3e-4, torch.finfo(torch.float32).eps
    far, nfar, total = 0, 0, 0
    for (n, p), (_, q), (_, dq) in zip(_leaves(s1.params), _leaves(n1.params),
                                      _leaves(d1.params)):
        tol = 1e-3 * lr + 8 * eps * p.abs()
        far, nfar, total = far + _far(dq, p, tol), nfar + _far(q, p, tol), total + p.numel()
        assert (_full(dq) - p).abs().max() <= 2 * lr, n
    for (n, e), (_, ne), (_, de) in zip(_leaves(s1.err), _leaves(n1.err), _leaves(d1.err)):
        e = e.float()
        tol = 2.0 ** -7 * e.abs()
        far, nfar = far + _far(de.float(), e, tol), nfar + _far(ne.float(), e, tol)
    assert far <= 10 * nfar + 1e-3 * total, (far, nfar, total)

    # -- serving: prefill into a longer cache, two decode steps ------------
    params, nparams = state.params, nudged.params
    dparams = lay_out(params, param_shardings(model, mesh, pcfg))
    prompt = {"tokens": toks[:, :PROMPT]}
    logits, cache = model.prefill(params, prompt, max_len=MAX_LEN)
    nlogits, ncache = model.prefill(nparams, prompt, max_len=MAX_LEN)
    with meshed():
        dlogits, dcache = model.prefill(
            dparams, lay_out(prompt, batch_shardings(mesh, prompt)), max_len=MAX_LEN)
    _within("prefill logits", dlogits, logits, _rel(nlogits, logits))
    for (n, c), (_, nc), (_, dc) in zip(_leaves(cache), _leaves(ncache), _leaves(dcache)):
        # a bf16 cache: an element may round the other way
        floor = 2.0 ** -8 if c.dtype == torch.bfloat16 else 1e-5
        _within(f"prefill cache {n}", dc, c, _rel(nc, c), floor)

    # decode from the plain prefill's cache, laid out by cache_shardings:
    # slot PROMPT is rank 0's last of the time split, PROMPT + 1 rank 1's
    # first
    csh = cache_shardings(model, mesh, pcfg, cache)
    dcache = _tree_map2(shard_tensor, cache, csh)
    ncache = _tree_map2(lambda t, s: t.clone(), cache, csh)
    for pos in (PROMPT, PROMPT + 1):
        tok = toks[:, pos:pos + 1]
        logits, cache = model.decode_step(params, cache, tok, pos)
        nlogits, ncache = model.decode_step(nparams, ncache, tok, pos)
        with meshed():
            dlogits, dcache = model.decode_step(
                dparams, dcache, shard_tensor(tok, batch_shardings(mesh, {"t": tok})["t"]), pos)
        _within(f"decode logits {pos}", dlogits, logits, _rel(nlogits, logits))
    for (n, c), (_, nc), (_, dc) in zip(_leaves(cache), _leaves(ncache), _leaves(dcache)):
        floor = 2.0 ** -8 if c.dtype == torch.bfloat16 else 1e-5
        _within(f"decode cache {n}", dc, c, _rel(nc, c), floor)


def _tree_map2(fn, a, b):
    if isinstance(a, dict):
        return {k: _tree_map2(fn, a[k], b[k]) for k in a}
    return fn(a, b)


def _tame(model, params) -> None:
    """The init draws a group-stacked leaf at fan_in = the group count
    (reference behaviour 6), which makes the layers chaotic: rounding
    grows through them.  Each such leaf is scaled in place to fan_in = its
    input dim (the second last)."""
    import math

    from repro_torch.models.specs import tree_paths
    flat = dict(_leaves(params))
    for path, spec in tree_paths(model.param_specs()).items():
        if spec.init == "normal" and spec.axes[0] == "layers":
            flat[path].mul_(math.sqrt(spec.shape[0] / spec.shape[-2]))


def _unflat(names, values):
    tree: dict = {}
    for n, v in zip(names, values):
        *head, last = n.split(".")
        d = tree
        for h in head:
            d = d.setdefault(h, {})
        d[last] = v
    return tree


def _rank_main(case: str, rank: int, world: int, workdir: str) -> None:
    import torch.distributed as dist
    dist.init_process_group("gloo", init_method=f"file://{workdir}/store",
                            rank=rank, world_size=world)
    try:
        _check(case, rank, workdir)
        dist.barrier()
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    _rank_main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])

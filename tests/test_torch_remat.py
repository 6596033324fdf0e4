"""Rematerialization in the port (``cfg.remat``) on the CPU, against itself
and against the JAX package.

The reference recomputes at five boundaries: each group of ``forward``,
each encoder layer, each loss chunk (``remat`` other than ``"none"``),
each query chunk of the attention and each mamba chunk step (always).
The port does the same with ``torch.utils.checkpoint``.  Checked here:

  * the loss and every gradient are bitwise equal for ``"none"``,
    ``"full"`` and ``"dots"`` (dense, MoE, Mamba and encoder-decoder
    reduced configs, with and without ``q_chunk``): the recompute runs the
    same operations on the same values;
  * a train step with ``remat="dots"`` (and ``"none"``) matches the
    reference's with the same ``remat`` within ``tests/test_torch_train.py``'s
    float32 bound, 1e-5 (``"full"`` is every config's default, so
    ``tests/test_torch_families_train.py`` holds it there);
  * the bytes autograd saves fall under ``"full"``, and the chunk steps
    keep no (chunk, T) scores and no (B, L, d_inner, d_state) tensor;
  * ``"dots"`` saves the products the reference's policy saves;
  * on a (1, 2) gloo mesh, ``"full"`` and ``"dots"`` give the gradients
    of ``"none"`` bit for bit;
  * the dry run's peak falls under remat, its counts still extend from 1, 2
    and 3 groups to a trace of 4 under ``"dots"`` (exactly; the peak within
    5 %), and a product the ``"dots"`` policy saved is not counted again.

The mesh ranks are this file run as a script (``python test_torch_remat.py
mesh <rank> <world> <dir>``), meeting through a ``FileStore``."""

import collections
import dataclasses
import json
import os
import signal
import subprocess
import sys
import textwrap

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "src")
ARCHS = ["qwen3-8b", "llama4-scout-17b-a16e", "jamba-v0.1-52b",
         "seamless-m4t-medium"]
MODES = ("none", "full", "dots")
F32_RTOL = 1e-5
TIMEOUT_S = 240


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread: these small CPU steps run hundreds of tiny ops
    (the scan's levels, recomputed), which stall when the suite's workers
    all spin up thread pools over the same cores."""
    torch = pytest.importorskip("torch")
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _port_cfg(arch: str, remat: str, q_chunk: int = 0):
    from repro_torch import configs
    return dataclasses.replace(configs.reduced(configs.get_config(arch)),
                               dtype="float32", remat=remat, q_chunk=q_chunk)


def _raw(vocab: int, b: int, s: int, seed: int = 0) -> dict:
    tok = np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(np.int32)
    return {"tokens": tok, "targets": np.roll(tok, -1, axis=1)}


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{path}.{k}" if path else k)
    else:
        yield path, tree


def _unflat(names, leaves):
    out: dict = {}
    for n, v in zip(names, leaves):
        d = out
        *head, last = n.split(".")
        for k in head:
            d = d.setdefault(k, {})
        d[last] = v
    return out


def _loss_grads(cfg, params, raw):
    import torch
    from repro_torch.launch import train as port_train
    from repro_torch.models import Model
    batch = port_train.build_batch(cfg, raw, 1, "cpu")
    names = [n for n, _ in _leaves(params)]
    leaves = [p.detach().requires_grad_() for _, p in _leaves(params)]
    loss, _ = Model(cfg).loss(_unflat(names, leaves), batch)
    return loss.detach(), torch.autograd.grad(loss, leaves, allow_unused=True)


@pytest.mark.parametrize("q_chunk", [0, 8], ids=["whole", "q_chunk"])
@pytest.mark.parametrize("arch", ARCHS)
def test_remat_modes_give_the_same_bits(arch, q_chunk):
    """S = 128: two mamba chunks of 64, sixteen query chunks of 8."""
    torch = pytest.importorskip("torch")
    from repro_torch.models import Model
    base = _port_cfg(arch, "none", q_chunk)
    params = Model(base).init(torch.Generator().manual_seed(0))
    raw = _raw(base.vocab, 2, 128)
    want = _loss_grads(base, params, raw)
    for remat in ("full", "dots"):
        loss, grads = _loss_grads(dataclasses.replace(base, remat=remat), params, raw)
        assert torch.equal(loss, want[0]), remat
        for (name, _), g, w in zip(_leaves(params), grads, want[1]):
            assert (g is None) == (w is None) and (g is None or torch.equal(g, w)), \
                (remat, name)


@pytest.mark.parametrize("arch,remat", [(a, "dots") for a in ARCHS]
                         + [("qwen3-8b", "none")])
def test_remat_step_matches_the_reference(arch, remat):
    torch = pytest.importorskip("torch")
    import jax

    import repro.launch.train as jax_train
    from repro import configs as jconfigs
    from repro.models import Model as JaxModel
    from repro.train import init_train_state as jinit_state
    from repro.train import make_train_step as jmake_step
    from repro_torch.checkpoint import tree_from_numpy
    from repro_torch.launch import train as port_train
    from repro_torch.models import Model
    from repro_torch.train import TrainState, make_train_step
    hp = dict(peak_lr=1e-3, warmup=1, total_steps=10)
    cfg = dataclasses.replace(jconfigs.reduced(jconfigs.get_config(arch)),
                              dtype="float32", remat=remat)
    port = _port_cfg(arch, remat)
    jm = JaxModel(cfg)
    js = jinit_state(jm, jax.random.key(0))
    t = tree_from_numpy(jax.tree.map(np.asarray, {"params": js.params,
                                                  "opt": js.opt, "step": js.step}),
                        device="cpu")
    ts = TrainState(t["params"], t["opt"], t["step"], None)
    raw = _raw(cfg.vocab, 4, 16)
    js, jmet = jax.jit(jmake_step(jm, **hp))(js, jax_train.build_batch(cfg, raw, 1))
    ts, tmet = make_train_step(Model(port), **hp)(
        ts, port_train.build_batch(port, raw, 1, "cpu"))
    for k in ("loss", "xent", "lb_loss", "z_loss"):
        np.testing.assert_allclose(float(tmet[k]), float(jmet[k]), rtol=F32_RTOL,
                                   err_msg=k)
    want = dict(_leaves(jax.tree.map(lambda x: np.asarray(x, np.float64), js.params)))
    got = dict(_leaves(ts.params))
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        g = got[k].double().numpy()
        err = np.linalg.norm(g - w) / max(np.linalg.norm(w), 1e-300)
        assert err < F32_RTOL, (k, err)


def _saved(cfg, params, raw):
    """(bytes, shapes) of the tensors autograd saves in the forward of
    ``loss`` outside any recomputed region (each storage once)."""
    import torch
    from repro_torch.launch import train as port_train
    from repro_torch.models import Model
    seen, shapes = {}, []

    def pack(t):
        st = t.untyped_storage()
        seen[st.data_ptr()] = st.nbytes()
        shapes.append(tuple(t.shape))
        return t

    batch = port_train.build_batch(cfg, raw, 1, "cpu")
    leaves = [p.detach().requires_grad_() for _, p in _leaves(params)]
    names = [n for n, _ in _leaves(params)]
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        loss, _ = Model(cfg).loss(_unflat(names, leaves), batch)
    loss.backward()
    return sum(seen.values()), shapes


@pytest.mark.parametrize("arch", ["qwen3-8b", "jamba-v0.1-52b"])
def test_full_remat_saves_fewer_bytes(arch):
    torch = pytest.importorskip("torch")
    from repro_torch.models import Model
    base = _port_cfg(arch, "none", 8)
    params = Model(base).init(torch.Generator().manual_seed(0))
    raw = _raw(base.vocab, 2, 128)
    none, _ = _saved(base, params, raw)
    full, _ = _saved(dataclasses.replace(base, remat="full"), params, raw)
    assert full < none / 2, (full, none)


def test_chunk_steps_keep_no_chunk_tensors():
    """With ``remat="none"`` the query chunks and mamba's chunk steps are
    still recomputed: autograd keeps no (B, KV, G, c, T) scores and no
    (L, B, d_inner, d_state) scan tensor."""
    torch = pytest.importorskip("torch")
    from repro_torch.models import Model
    cfg = _port_cfg("jamba-v0.1-52b", "none", 8)
    params = Model(cfg).init(torch.Generator().manual_seed(0))
    _, shapes = _saved(cfg, params, _raw(cfg.vocab, 2, 128))
    assert shapes
    scan = (cfg.d_inner, cfg.ssm_state)
    assert not [s for s in shapes if len(s) == 4 and s[-2:] == scan]
    assert not [s for s in shapes if len(s) == 5 and s[-2:] == (8, 128)]


def test_dots_saves_what_the_reference_saves(monkeypatch):
    """One reduced dense group under ``"dots"``: the products whose outputs
    the port's policy keeps, against the residuals of the reference's
    ``checkpoint_dots_with_no_batch_dims`` (``saved_residuals``, what
    ``print_saved_residuals`` prints).  Every one the reference keeps is
    kept, by element count; the port keeps one more, the FFN's down
    projection (B, S, d): the group's last product, whose output only
    the residual add reads, so JAX's partial evaluation drops it."""
    torch = pytest.importorskip("torch")
    import jax
    import jax.numpy as jnp
    from jax._src.ad_checkpoint import saved_residuals

    from repro import configs as jconfigs
    from repro.models import Model as JaxModel
    from repro_torch.models import Model
    from repro_torch.models import model as model_mod
    B, S = 2, 32
    cfg = dataclasses.replace(jconfigs.reduced(jconfigs.get_config("qwen3-8b")),
                              dtype="float32", remat="dots")
    jm = JaxModel(cfg)
    gp = jax.tree.map(lambda a: a[0], jm.init(jax.random.key(0))["layers"])
    pos = jnp.broadcast_to(jnp.arange(S, dtype=jnp.int32)[None], (B, S))
    group = jm._maybe_remat(lambda gp, x: jm._apply_group(
        gp, x, positions=pos, prefix_len=0, enc_out=None)[0])
    res = saved_residuals(lambda gp, x: group(gp, x).sum(), gp,
                          jnp.ones((B, S, cfg.d_model), jnp.float32))
    want = collections.Counter(int(np.prod(a.shape)) for a, why in res
                               if "argument" not in why and "constant" not in why)

    port = _port_cfg("qwen3-8b", "dots")
    model = Model(port)
    got = collections.Counter()
    policy = model_mod._dots_policy

    def recording(ctx, op, *args, **kwargs):
        out = policy(ctx, op, *args, **kwargs)
        if not ctx.is_recompute and out == model_mod.CheckpointPolicy.MUST_SAVE:
            a, b = args[-2], args[-1]
            got[a.shape[0] * b.shape[1]] += 1
        return out

    monkeypatch.setattr(model_mod, "_dots_policy", recording)
    params = model.init(torch.Generator().manual_seed(0))
    gpt = _unflat(*zip(*[(n, v[0].requires_grad_()) for n, v in
                         _leaves(params["layers"])]))
    x = torch.ones((B, S, port.d_model), requires_grad=True)
    positions = torch.arange(S, dtype=torch.int32)[None].expand(B, S)
    fn = model._maybe_remat(lambda gp, x: model._apply_group(
        gp, x, positions=positions, prefix_len=0)[0])
    fn(gpt, x).sum().backward()
    assert sum(want.values()) == 6
    assert not (want - got), (want, got)
    assert got - want == collections.Counter({B * S * port.d_model: 1}), (got, want)


# ---------------------------------------------------------------------------
# the dry run (a process of its own: the fake world is its default group)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def dry():
    script = """
        import dataclasses, json
        from repro_torch.configs import ShapeSpec, get_config, reduced
        from repro_torch.launch import dryrun
        from repro_torch.launch.mesh import _mesh
        from repro_torch.launch.specs import build_cell
        cfg = dataclasses.replace(reduced(get_config("qwen3-8b")), n_layers=4)
        shape = ShapeSpec("train_64", 64, 8, "train")
        dryrun.init_fake_world(8)
        mesh = _mesh("cpu", (2, 4), ("data", "model"))
        out = {}
        keys = ("dot_flops", "arg_bytes", "out_bytes", "peak_bytes")
        for remat in ("none", "full", "dots"):
            c = dataclasses.replace(cfg, remat=remat)
            whole = dryrun.trace_cell(build_cell(c, shape, mesh), mesh)
            out[remat] = {
                "whole": [whole[k] for k in keys] + [whole["cost"].flops, whole["cost"].bytes,
                                                   whole["cost"].coll_wire],
                "by_op": whole["dot_flops_by_op"]}
            if remat == "dots":   # "full", the default: tests/test_torch_dryrun.py
                cut = dryrun.trace(c, shape, mesh)
                out[remat]["cut"] = [cut[k] for k in keys] + [
                    cut["cost"].flops, cut["cost"].bytes, cut["cost"].coll_wire]
        print("DRY " + json.dumps(out))
    """
    env = dict(os.environ, PYTHONPATH=SRC)
    p = subprocess.Popen([sys.executable, "-c", textwrap.dedent(script)], env=env,
                         cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                         text=True, start_new_session=True)
    try:
        out, err = p.communicate(timeout=TIMEOUT_S)
    except BaseException:
        os.killpg(p.pid, signal.SIGKILL)
        p.communicate()
        raise
    assert p.returncode == 0, err[-3000:]
    line = next(x for x in out.splitlines() if x.startswith("DRY "))
    return json.loads(line[len("DRY "):])


def test_dry_run_peak_falls_under_remat(dry):
    peak = {r: dry[r]["whole"][3] for r in MODES}
    assert peak["full"] < peak["none"] and peak["dots"] < peak["none"], peak
    # the recompute is counted: more FLOPs, the argument bytes unchanged
    assert dry["full"]["whole"][4] > dry["none"]["whole"][4]
    assert dry["full"]["whole"][1] == dry["none"]["whole"][1]


def test_dry_run_depth_extension_holds_under_dots(dry):
    """The quadratic from 1, 2 and 3 groups against a trace of 4 under
    ``"dots"`` (the default ``"full"``: ``tests/test_torch_dryrun.py``)."""
    whole, cut = dry["dots"]["whole"], dry["dots"]["cut"]
    for i, name in enumerate(("dot_flops", "arg_bytes", "out_bytes")):
        assert cut[i] == pytest.approx(whole[i], rel=1e-9), name
    assert abs(cut[3] - whole[3]) <= 0.05 * whole[3], (cut[3], whole[3])
    assert cut[4:] == pytest.approx(whole[4:], rel=1e-9)


def test_dry_run_counts_saved_products_once(dry):
    """Under ``"dots"`` the groups' projections (``mm``) are saved, not run
    again in the backward: the only ``mm`` FLOPs beyond ``"none"``'s are
    the loss chunk's unembedding, which every remat but ``"none"``
    recomputes (rank 0's (4 x 64, d) by (d, vocab / 4) on the (2, 4) mesh).
    The attention's batched products (``bmm``) are recomputed, as under
    ``"full"``, which recomputes the projections too."""
    from repro_torch.configs import get_config, reduced
    cfg = reduced(get_config("qwen3-8b"))
    unembed = 2.0 * (8 // 2) * 64 * cfg.d_model * (cfg.vocab // 4)
    by = {r: dry[r]["by_op"] for r in MODES}
    assert by["dots"]["mm"] == by["none"]["mm"] + unembed < by["full"]["mm"]
    assert by["none"]["bmm"] < by["dots"]["bmm"] == by["full"]["bmm"]


# ---------------------------------------------------------------------------
# a (1, 2) gloo mesh: the mesh form under remat, against itself without
# ---------------------------------------------------------------------------

def test_remat_on_a_gloo_mesh_gives_the_same_bits(tmp_path):
    pytest.importorskip("torch")
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, __file__, "mesh", str(r), "2",
                               str(tmp_path)], env=env, cwd=ROOT,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True, start_new_session=True) for r in range(2)]
    try:
        errs = []
        for p in procs:
            _, err = p.communicate(timeout=TIMEOUT_S)
            if p.returncode:
                errs.append(err[-4000:])
    finally:
        for p in procs:
            if p.poll() is None:
                os.killpg(p.pid, signal.SIGKILL)
                p.communicate()
    assert not errs, errs[0]


def _mesh_rank(rank: int, world: int, workdir: str) -> None:
    import torch
    import torch.distributed as dist
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.launch.dryrun import _map
    from repro_torch.launch.mesh import _mesh
    from repro_torch.launch.specs import parallelism_for
    from repro_torch.launch import train as port_train
    from repro_torch.models import Model
    from repro_torch.parallel import activation_context
    from repro_torch.parallel.sharding import (batch_shardings, param_shardings,
                                               shard_tensor)
    dist.init_process_group("gloo", store=dist.FileStore(
        os.path.join(workdir, "store"), world), rank=rank, world_size=world)
    try:
        base = dataclasses.replace(_port_cfg("qwen3-8b", "none", 8),
                                   n_layers=2 * len(_port_cfg("qwen3-8b", "none").pattern))
        mesh = _mesh("cpu", (1, 2), ("data", "model"))
        model = Model(base)
        params = model.init(torch.Generator().manual_seed(0))
        raw = _raw(base.vocab, 4, 32)
        batch = port_train.build_batch(base, raw, 1, "cpu")
        dparams = _map(lambda t, s: shard_tensor(t, s) if s is not None else t,
                       params, param_shardings(model, mesh, parallelism_for(base)))
        dbatch = _map(lambda t, s: shard_tensor(t, s) if s is not None else t,
                      batch, batch_shardings(mesh, batch))
        names = [n for n, _ in _leaves(dparams)]
        out = {}
        for remat in MODES:
            cfg = dataclasses.replace(base, remat=remat)
            leaves = [p.detach().requires_grad_() for _, p in _leaves(dparams)]
            with implicit_replication(), activation_context(mesh):
                loss, _ = Model(cfg).loss(_unflat(names, leaves), dbatch)
                grads = torch.autograd.grad(loss, leaves)
            out[remat] = (loss.to_local() if hasattr(loss, "to_local") else loss,
                          [g.to_local() if hasattr(g, "to_local") else g for g in grads])
        for remat in ("full", "dots"):
            assert torch.equal(out[remat][0], out["none"][0]), remat
            for n, g, w in zip(names, out[remat][1], out["none"][1]):
                assert torch.equal(g, w), (remat, n)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__" and len(sys.argv) == 5 and sys.argv[1] == "mesh":
    _mesh_rank(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])

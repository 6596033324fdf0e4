"""The port's multi-rank paths on gloo CPU processes, held against the
reference: ``rowparallel_einsum_compressed`` on (1, 2) and (2, 2) meshes
of DTensors against the reference's shard_map on as many forced host
devices, and the elastic restore: a checkpoint saved from a (2, 1) mesh
restores onto a (2, 2) mesh bitwise (``test_distributed.py::
test_elastic_restore_across_meshes``'s case), and checkpoints cross between
the packages in both directions.

The ranks are this file run as a script (``python test_torch_distributed.py
<case> <rank> <world> <dir>``), one process each, meeting through a
``FileStore`` in the test's directory; each launch leads a session of its
own, has a timeout, and is killed as a group on timeout or failure."""

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
TIMEOUT_S = 120

# the compressed projection's inputs (float32: the sums' rounding is the
# only difference left between the packages)
B, S, E, D = 4, 8, 64, 24


def _inputs():
    rng = np.random.default_rng(7)
    y = rng.standard_normal((B, S, E)).astype(np.float32)
    w = (rng.standard_normal((E, D)) * 0.2).astype(np.float32)
    y[1, 3] = 0.0                              # a zero row: scale 1.0
    return y, w


def _weights():
    rng = np.random.default_rng(11)
    return {"w": rng.standard_normal((16, 8)).astype(np.float32),
            "b": rng.standard_normal((8, 12)).astype(np.float32)}


# ---------------------------------------------------------------------------
# the launcher (pytest side)
# ---------------------------------------------------------------------------

def _launch(case: str, world: int, workdir: str) -> None:
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, __file__, case, str(r), str(world), workdir],
                              env=env, cwd=ROOT, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True,
                              start_new_session=True)
             for r in range(world)]
    errs = []
    try:
        for p in procs:
            _, err = p.communicate(timeout=TIMEOUT_S)
            if p.returncode:
                errs.append(err[-3000:])
    finally:
        for p in procs:
            if p.poll() is None:
                os.killpg(p.pid, signal.SIGKILL)
                p.communicate()
    assert not errs, errs[0]


def _jax(script: str, devices: int) -> str:
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu",
               XLA_FLAGS=f"--xla_force_host_platform_device_count={devices}")
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
    return out


# ---------------------------------------------------------------------------
# compressed TP
# ---------------------------------------------------------------------------

MESHES = [(1, 2), (2, 2)]


@pytest.fixture(scope="module")
def reference_outputs(tmp_path_factory):
    """The reference's compressed projection on each mesh, its one-device
    rule for the mesh (Auto axes), and the scales each TP shard's partial
    takes: {mesh: (out, sum over k of the scales)}."""
    d = tmp_path_factory.mktemp("ctp_ref")
    y, w = _inputs()
    np.save(d / "y.npy", y)
    np.save(d / "w.npy", w)
    _jax(f"""
        import jax, jax.numpy as jnp, numpy as np
        from jax.sharding import Mesh
        from repro.parallel.actctx import activation_context
        from repro.parallel.compressed import rowparallel_einsum_compressed, _quantize_rows
        y, w = np.load("{d}/y.npy"), np.load("{d}/w.npy")
        for dp, tp in {MESHES}:
            mesh = Mesh(np.array(jax.devices()[:dp * tp]).reshape(dp, tp), ("data", "model"))
            with mesh, activation_context(mesh):
                out = jax.jit(rowparallel_einsum_compressed)(y, w)
            E = y.shape[-1]
            scales = sum(np.asarray(jax.jit(_quantize_rows)(jnp.einsum(
                "bse,ed->bsd", y[..., k * E // tp:(k + 1) * E // tp],
                w[k * E // tp:(k + 1) * E // tp]))[1]) for k in range(tp))
            np.save(f"{d}/ref_{{dp}}x{{tp}}.npy", np.asarray(out))
            np.save(f"{d}/scales_{{dp}}x{{tp}}.npy", scales)
        print("OK")
    """, devices=4)
    return {m: (np.load(d / f"ref_{m[0]}x{m[1]}.npy"), np.load(d / f"scales_{m[0]}x{m[1]}.npy"))
            for m in MESHES}


@pytest.mark.parametrize("mesh_shape", MESHES, ids=["1x2", "2x2"])
def test_compressed_tp_matches_reference(mesh_shape, reference_outputs, tmp_path):
    y, w = _inputs()
    np.save(tmp_path / "y.npy", y)
    np.save(tmp_path / "w.npy", w)
    (tmp_path / "mesh.json").write_text(json.dumps(mesh_shape))
    _launch("ctp", mesh_shape[0] * mesh_shape[1], str(tmp_path))
    got = np.load(tmp_path / "out.npy")
    want, scales = reference_outputs[mesh_shape]
    exact = np.einsum("bse,ed->bsd", y.astype(np.float64), w.astype(np.float64))
    # the float32 partials may round across one int8 step: at most one
    # quantum of each of the k partials
    assert np.all(np.abs(got - want) <= scales * (1 + 1e-6) + 1e-7), \
        np.max(np.abs(got - want) / scales)
    for out in (got, want):
        rel = np.linalg.norm(out - exact) / np.linalg.norm(exact)
        assert rel < 0.02, rel


# ---------------------------------------------------------------------------
# elastic restore, and checkpoints across the packages
# ---------------------------------------------------------------------------

def _save_reference(path: str) -> dict:
    """The reference's save of the weights (and a bf16 leaf)."""
    import jax.numpy as jnp

    from repro.checkpoint import save_pytree
    tree = {k: jnp.asarray(v) for k, v in _weights().items()}
    tree["h"] = jnp.asarray(_weights()["b"]).astype(jnp.bfloat16)
    save_pytree(path, tree)
    return tree


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    """A directory holding the reference's checkpoint of the weights
    (``ref.bskt``) and the port's, saved by 2 ranks from DTensors on a
    (2, 1) mesh (``port.bskt``)."""
    d = tmp_path_factory.mktemp("elastic")
    _save_reference(str(d / "ref.bskt"))
    _launch("save21", 2, str(d))
    return d


def test_elastic_restore_across_meshes(saved):
    """Restored by 4 ranks onto (2, 2): each rank's shard bitwise, from the
    port's checkpoint and from the reference's."""
    _launch("restore22", 4, str(saved))
    for r in range(4):
        assert (saved / f"restored.{r}").read_text() == "bitwise"


def test_reference_loads_the_ports_dtensor_checkpoint(saved, tmp_path):
    """The port's checkpoint of DTensors has the bytes of a save of the
    whole tensors, and loads into the reference bitwise."""
    import torch

    from repro.checkpoint import load_pytree
    from repro_torch.checkpoint import save_pytree
    save_pytree(str(tmp_path / "whole.bskt"),
                {k: torch.from_numpy(v) for k, v in _weights().items()})
    assert (tmp_path / "whole.bskt").read_bytes() == (saved / "port.bskt").read_bytes()
    got, _ = load_pytree(str(saved / "port.bskt"))
    for k, v in _weights().items():
        np.testing.assert_array_equal(np.asarray(got[k]), v)


# ---------------------------------------------------------------------------
# the ranks (this file as a script)
# ---------------------------------------------------------------------------

def _rank_main(case: str, rank: int, world: int, workdir: str) -> None:
    import torch
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=f"file://{workdir}/store.{case}",
                            rank=rank, world_size=world)
    from repro_torch.checkpoint import load_pytree, save_pytree
    from repro_torch.launch.mesh import _mesh
    from repro_torch.parallel import activation_context, rowparallel_einsum_compressed
    from repro_torch.parallel.sharding import NamedSharding, P, shard_tensor
    try:
        if case == "ctp":
            dp, tp = json.loads(open(f"{workdir}/mesh.json").read())
            mesh = _mesh("cpu", (dp, tp), ("data", "model"))
            y = torch.from_numpy(np.load(f"{workdir}/y.npy"))
            w = torch.from_numpy(np.load(f"{workdir}/w.npy"))
            yd = shard_tensor(y, NamedSharding(mesh, P("data", None, "model")))
            wd = shard_tensor(w, NamedSharding(mesh, P("model", None)))
            with activation_context(mesh):
                out = rowparallel_einsum_compressed(yd, wd)
            assert list(out.placements) == NamedSharding(mesh, P("data", None, None)).placements
            assert out.to_local().shape == (B // dp, S, D)
            full = out.full_tensor()
            if rank == 0:
                np.save(f"{workdir}/out.npy", full.numpy())
        elif case == "save21":
            mesh = _mesh("cpu", (2, 1), ("data", "model"))
            tree = {k: shard_tensor(torch.from_numpy(v), NamedSharding(mesh, P("data", None)))
                    for k, v in _weights().items()}
            # every rank gathers; rank 0's file is the checkpoint
            save_pytree(f"{workdir}/port.bskt" if rank == 0 else f"{workdir}/port.r{rank}",
                        tree)
        elif case == "restore22":
            mesh = _mesh("cpu", (2, 2), ("data", "model"))
            want = {k: torch.from_numpy(v) for k, v in _weights().items()}
            sh = {"w": NamedSharding(mesh, P("data", "model")),
                  "b": NamedSharding(mesh, P("model", "data"))}
            for name in ("port.bskt", "ref.bskt"):
                extra = {"h": NamedSharding(mesh, P(None, "model"))} if name == "ref.bskt" else {}
                got, _ = load_pytree(f"{workdir}/{name}", template={**want, **{k: 0 for k in extra}},
                                     shardings={**sh, **extra}, device="cpu")
                for k, s in {**sh, **extra}.items():
                    full = want["b"].to(torch.bfloat16) if k == "h" else want[k]
                    assert list(got[k].placements) == s.placements, (name, k)
                    local = full
                    coord = mesh.get_coordinate()
                    for md, p in enumerate(s.placements):
                        if p.is_shard():
                            n = mesh.size(md)
                            size = local.shape[p.dim] // n
                            local = local.narrow(p.dim, coord[md] * size, size)
                    assert got[k].to_local().dtype == full.dtype, (name, k)
                    assert torch.equal(got[k].to_local(), local), (name, k)
                    assert torch.equal(got[k].full_tensor(), full), (name, k)
            with open(f"{workdir}/restored.{rank}", "w") as fh:
                fh.write("bitwise")
        dist.barrier()
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    _rank_main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])

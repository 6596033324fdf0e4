"""The port's dry run (``repro_torch.launch.{specs,hlo_cost,dryrun}``):
the cell builders' counts against the reference's ``repro.launch.specs``
for every arch x assigned shape on both production meshes, and the dry
run itself on the reduced qwen3-8b, one cell per shape kind, on a fake
(2, 4) world and a fake world of one, in a process of its own (a fake
process group is the process's default group): the schema
``benchmarks/roofline.py`` reads, the argument bytes against the local
shards the rules give, the per-rank FLOPs against one rank's, the
depth extrapolation against a trace of the whole depth, and an op DTensor
cannot lay out failing the walk."""

import dataclasses
import json
import os
import signal
import subprocess
import sys
import textwrap

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_config  # noqa: E402
from repro.configs import list_archs  # noqa: E402
from repro.configs import shapes_for as jax_shapes  # noqa: E402
from repro.launch import specs as ref  # noqa: E402
from repro.parallel.sharding import abstract_mesh as jax_mesh  # noqa: E402
from repro_torch.configs import SHAPES, ShapeSpec, get_config, reduced, shapes_for  # noqa: E402
from repro_torch.launch import specs as port  # noqa: E402
from repro_torch.launch.dryrun import H100  # noqa: E402
from repro_torch.parallel.sharding import abstract_mesh, local_shape  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "src")
MESHES = [((16, 16), ("data", "model")), ((2, 16, 16), ("pod", "data", "model"))]
DTYPES = {jnp.int32: torch.int32, jnp.float32: torch.float32}


@pytest.mark.parametrize("arch", list_archs())
def test_cell_counts_match_the_reference(arch):
    jcfg, cfg = jax_config(arch), get_config(arch)
    assert port.total_params(cfg) == ref.total_params(jcfg)
    assert port.active_params(cfg) == ref.active_params(jcfg)
    assert dataclass_fields(port.parallelism_for(cfg)) == \
        dataclass_fields(ref.parallelism_for(jcfg))
    assert [s.name for s in jax_shapes(jcfg)] == [s.name for s in shapes_for(cfg)]
    for shape in jax_shapes(jcfg):
        pshape = SHAPES[shape.name]
        for sizes, names in MESHES:
            assert port.default_accum(cfg, pshape, abstract_mesh(sizes, names)) == \
                ref.default_accum(jcfg, shape, jax_mesh(sizes, names)), (shape.name, sizes)
        want = ref.input_specs(jcfg, shape)
        got = port.input_specs(cfg, pshape)
        assert sorted(got) == sorted(want)
        for k, v in want.items():
            assert tuple(got[k].shape) == tuple(v.shape), (shape.name, k)
            assert got[k].dtype == DTYPES[v.dtype.type], (shape.name, k)
            assert got[k].device.type == "meta"
    assert port.SEAMLESS_DEC_PROMPT == ref.SEAMLESS_DEC_PROMPT
    assert port.SEAMLESS_CROSS_LEN == ref.SEAMLESS_CROSS_LEN


def dataclass_fields(x) -> dict:
    return dataclasses.asdict(x)


# ---------------------------------------------------------------------------
# the dry run on the reduced qwen3-8b (a process of its own)
# ---------------------------------------------------------------------------

CELLS = [ShapeSpec("train_64", 64, 8, "train"), ShapeSpec("prefill_64", 64, 8, "prefill"),
         ShapeSpec("decode_64", 64, 8, "decode")]


@pytest.fixture(scope="module")
def records():
    """{(shape, mesh): record} of the port's dry run, and the depth check:
    the reduced qwen3-8b at 4 groups traced whole against its extension
    from 1, 2 and 3."""
    script = f"""
        import dataclasses, json
        from repro_torch.configs import ShapeSpec, get_config, reduced
        from repro_torch.launch import dryrun
        from repro_torch.launch.mesh import _mesh
        from repro_torch.launch.specs import build_cell
        cfg = reduced(get_config("qwen3-8b"))
        out = {{}}
        for shape in {[(s.name, s.seq_len, s.global_batch, s.kind) for s in CELLS]}:
            shape = ShapeSpec(*shape)
            for ms in ((2, 4), (1, 1)):
                out[f"{{shape.name}} {{ms[0]}}x{{ms[1]}}"] = dryrun.run_shape(cfg, shape, ms)
        deep = dataclasses.replace(cfg, n_layers=4)
        dryrun.init_fake_world(8)
        mesh = _mesh("cpu", (2, 4), ("data", "model"))
        shape = ShapeSpec("train_64", 64, 8, "train")
        whole = dryrun.trace_cell(build_cell(deep, shape, mesh), mesh)
        cut = dryrun.trace(deep, shape, mesh)
        keys = ("dot_flops", "arg_bytes", "out_bytes", "peak_bytes")
        out["depth"] = {{"whole": [whole[k] for k in keys] + [whole["cost"].flops, whole["cost"].bytes,
                                                        whole["cost"].coll_wire],
                        "cut": [cut[k] for k in keys] + [cut["cost"].flops, cut["cost"].bytes,
                                                    cut["cost"].coll_wire]}}
        # an op DTensor cannot lay out (a view that splits a sharded dim
        # unevenly) raises under the cost walk: no fallback replicates it
        import torch
        from torch._subclasses.fake_tensor import FakeTensorMode
        from torch.distributed.tensor import DTensor, Replicate, Shard
        from repro_torch.launch.hlo_cost import CostMode
        with FakeTensorMode():
            x = DTensor.from_local(torch.empty(8, 2), mesh, [Replicate(), Shard(1)],
                                   run_check=False, shape=torch.Size((8, 8)), stride=(8, 1))
            try:
                with CostMode():
                    x.view(8, 2, 4)
                out["uneven_view"] = "ran"
            except RuntimeError as e:
                out["uneven_view"] = "raised"
        print("RECORDS " + json.dumps(out))
    """
    env = dict(os.environ, PYTHONPATH=SRC)
    p = subprocess.Popen([sys.executable, "-c", textwrap.dedent(script)], env=env, cwd=ROOT,
                         stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                         start_new_session=True)
    try:
        out, err = p.communicate(timeout=240)
    except BaseException:
        os.killpg(p.pid, signal.SIGKILL)
        p.communicate()
        raise
    assert p.returncode == 0, err[-3000:]
    line = next(x for x in out.splitlines() if x.startswith("RECORDS "))
    return json.loads(line[len("RECORDS "):])


@pytest.mark.parametrize("shape", CELLS, ids=[s.kind for s in CELLS])
def test_reduced_cell_schema(shape, records):
    """Every key of the reference's record, and ``benchmarks/roofline.py``
    reads it."""
    sys.path.insert(0, ROOT)
    from benchmarks.roofline import rows_from
    rec = records[f"{shape.name} 2x4"]
    for k in ("arch", "shape", "mesh", "devices", "kind", "seq_len", "global_batch",
              "params_total", "params_active", "lower_s", "compile_s", "per_device",
              "collectives", "xla_flops_once", "model_flops_global", "roofline_s",
              "bottleneck", "mfu_vs_roofline"):
        assert k in rec, k
    for k in ("hlo_flops", "hlo_bytes", "collective_wire_bytes", "arg_bytes", "out_bytes",
              "temp_bytes", "peak_bytes"):
        assert k in rec["per_device"], k
    assert set(rec["roofline_s"]) == {"compute", "memory", "collective"}
    assert rec["devices"] == 8 and rec["kind"] == shape.kind
    t = rec["roofline_s"]
    assert t["compute"] == rec["per_device"]["hlo_flops"] / H100["flops_bf16"]
    assert t["memory"] == rec["per_device"]["hlo_bytes"] / H100["hbm_bytes_per_s"]
    assert rec["bottleneck"] == max(t, key=t.get)
    assert rec["collectives"]["total"]["count"] > 0         # the mesh communicates
    assert rec["per_device"]["peak_bytes"] >= rec["per_device"]["arg_bytes"] > 0
    (row,) = rows_from([rec])
    assert row["arch"] == rec["arch"] and row["peak_GiB"] >= 0


@pytest.mark.parametrize("shape", CELLS, ids=[s.kind for s in CELLS])
def test_arg_bytes_are_the_local_shards(shape, records):
    """The record's argument bytes are the sum of the rank's shards of the
    cell's arguments under the rules (counted here from the shardings)."""
    cfg = reduced(get_config("qwen3-8b"))
    mesh = abstract_mesh((2, 4), ("data", "model"))
    kw = {"accum": port.default_accum(cfg, shape, mesh),
          "bf16_moments": False} if shape.kind == "train" else None
    cell = port.build_cell(cfg, shape, mesh, train_kwargs=kw)

    def total(arg, sh):
        if isinstance(arg, torch.Tensor):
            n = 1
            for d in local_shape(arg.shape, mesh, sh.spec):
                n *= d
            return n * arg.element_size()
        if isinstance(arg, dict):
            return sum(total(v, sh if not isinstance(sh, dict) else sh[k])
                       for k, v in arg.items())
        if hasattr(arg, "params"):                  # TrainState
            return sum(total(getattr(arg, f), getattr(sh, f))
                       for f in ("params", "opt", "step", "err") if getattr(arg, f) is not None)
        return 0                                    # decode's position, an int

    want = sum(total(a, s) for a, s in zip(cell.args, cell.in_shardings))
    assert records[f"{shape.name} 2x4"]["per_device"]["arg_bytes"] == want


@pytest.mark.parametrize("shape", CELLS, ids=[s.kind for s in CELLS])
def test_per_rank_flops_against_one_rank(shape, records):
    """Eight ranks each do at least an eighth of one rank's work, and at
    most 1.5 times it (what the rules leave replicated: the kv heads, the
    norms)."""
    eight = records[f"{shape.name} 2x4"]["per_device"]["hlo_flops"]
    one = records[f"{shape.name} 1x1"]["per_device"]["hlo_flops"]
    assert 1.0 * one <= eight * 8 <= 1.5 * one, eight * 8 / one


def test_unlayable_op_fails(records):
    """The cost walk lets DTensor's error through: a cell whose layout
    DTensor cannot follow fails, as it would on a real mesh."""
    assert records["uneven_view"] == "raised"


def test_depth_extrapolation(records):
    """Counts traced at one, two and three groups and extended equal the
    trace of all four: FLOPs, bytes and wire exactly, the peak within 5 %."""
    whole, cut = records["depth"]["whole"], records["depth"]["cut"]
    for i, name in enumerate(("dot_flops", "arg_bytes", "out_bytes")):
        assert cut[i] == whole[i], name
    assert abs(cut[3] - whole[3]) <= 0.05 * whole[3], (cut[3], whole[3])
    for i in (4, 5, 6):
        assert cut[i] == pytest.approx(whole[i], rel=1e-12), i

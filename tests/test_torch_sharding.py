"""The port's sharding rules (``repro_torch.parallel.sharding``) against the
reference's (``repro.parallel.sharding``): every leaf's PartitionSpec for
every arch on the (16, 16), (2, 16, 16) and (2, 4) abstract meshes, the
rule cases of ``tests/test_sharding_rules.py``, and the DTensor
placements the specs map to, on abstract meshes and on a real one-rank
gloo mesh."""

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import torch.distributed as dist  # noqa: E402
from jax.sharding import PartitionSpec as JP  # noqa: E402

from repro.configs import get_config as jax_config  # noqa: E402
from repro.configs import list_archs  # noqa: E402
from repro.launch.specs import SEAMLESS_CROSS_LEN  # noqa: E402
from repro.launch.specs import input_specs as jax_inputs  # noqa: E402
from repro.models import Model as JaxModel  # noqa: E402
from repro.models.specs import ParamSpec as JaxParamSpec  # noqa: E402
from repro.parallel import sharding as ref  # noqa: E402
from repro_torch.configs import SHAPES, get_config  # noqa: E402
from repro_torch.launch.specs import input_specs  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.models.specs import ParamSpec  # noqa: E402
from repro_torch.parallel import sharding as port  # noqa: E402

MESHES = [((16, 16), ("data", "model")), ((2, 16, 16), ("pod", "data", "model")),
          ((2, 4), ("data", "model"))]
PCFGS = {"default": {}, "zero3": {"zero3": True}}


def _flat(tree, prefix=""):
    """{dotted path: leaf} of a nested dict."""
    if not isinstance(tree, dict):
        return {prefix.rstrip("."): tree}
    out = {}
    for k, v in tree.items():
        out.update(_flat(v, f"{prefix}{k}."))
    return out


def _specs(tree) -> dict:
    """{path: spec as a tuple of entries} of a tree of NamedShardings."""
    return {k: tuple(v.spec) for k, v in _flat(tree).items()}


@pytest.mark.parametrize("sizes,names", MESHES, ids=["16x16", "2x16x16", "2x4"])
@pytest.mark.parametrize("arch", list_archs())
def test_every_leaf_matches_the_reference(arch, sizes, names):
    jm, pm = ref.abstract_mesh(sizes, names), port.abstract_mesh(sizes, names)
    jmodel, pmodel = JaxModel(jax_config(arch)), Model(get_config(arch))
    for kw in PCFGS.values():
        jp, pp = ref.ParallelismConfig(**kw), port.ParallelismConfig(**kw)
        assert _specs(port.param_shardings(pmodel, pm, pp)) == \
            _specs(ref.param_shardings(jmodel, jm, jp)), (arch, kw)
        assert _specs(port.opt_shardings(pmodel, pm, pp)) == \
            _specs(ref.opt_shardings(jmodel, jm, jp)), (arch, kw)
    # decode caches at the decode_32k and long_500k shapes
    cfg = get_config(arch)
    enc = SEAMLESS_CROSS_LEN if cfg.is_encdec else 0
    for B, T in ((128, 32768), (1, 524288)):
        jc = jmodel.init_cache(B, T, enc_len=enc, abstract=True)
        pc = pmodel.init_cache(B, T, enc_len=enc, device="meta")
        want = _specs(ref.cache_shardings(jmodel, jm, ref.ParallelismConfig(), jc))
        got = _specs(port.cache_shardings(pmodel, pm, port.ParallelismConfig(), pc))
        assert got == want, (arch, B, T)
    # every input of every shape kind
    for shape in SHAPES.values():
        want = _specs(ref.batch_shardings(jm, jax_inputs(jax_config(arch), shape)))
        got = _specs(port.batch_shardings(pm, input_specs(cfg, shape)))
        assert got == want, (arch, shape.name)


# the rule cases of tests/test_sharding_rules.py: (shape, axes, pcfg, spec)
RULE_CASES = [
    ((4096, 32, 128), ("embed", "heads", "head_dim"), {"zero3": False}, (None, "model", None)),
    ((4096, 12288), ("embed", "ff"), {"zero3": False}, (None, "model")),
    ((151936, 4096), ("vocab", "embed"), {"zero3": False}, ("model", None)),
    ((5120, 40, 128), ("embed", "heads", "head_dim"), {"zero3": False}, (None, None, None)),
    ((5120, 8, 128), ("embed", "kv_heads", "head_dim"), {"zero3": False}, (None, None, None)),
    ((5120, 40, 128), ("embed", "heads", "head_dim"), {"zero3": True}, ("data", None, None)),
    ((128, 5120, 8192), ("experts", "embed", "ff"), {}, ("data", None, "model")),
]


@pytest.mark.parametrize("shape,axes,kw,want", RULE_CASES,
                         ids=[f"case{i}" for i in range(len(RULE_CASES))])
def test_rule_cases(shape, axes, kw, want):
    jm, pm = ref.abstract_mesh((16, 16), ("data", "model")), \
        port.abstract_mesh((16, 16), ("data", "model"))
    got = port.logical_to_pspec(ParamSpec(shape, axes), pm, port.ParallelismConfig(**kw))
    assert tuple(got) == want
    assert ref.logical_to_pspec(JaxParamSpec(shape, axes, dtype=jnp.float32), jm,
                                ref.ParallelismConfig(**kw)) == JP(*want)


@pytest.mark.parametrize("arch", ["qwen3-8b", "llama4-maverick-400b-a17b",
                                  "jamba-v0.1-52b"])
def test_each_mesh_axis_used_once(arch):
    from repro_torch.models.specs import tree_paths
    mesh = port.abstract_mesh((16, 16), ("data", "model"))
    for path, spec in tree_paths(Model(get_config(arch)).param_specs()).items():
        ps = port.logical_to_pspec(spec, mesh, port.ParallelismConfig(zero3=True))
        used = [e for e in ps if e is not None]
        assert len(used) == len(set(used)), (arch, path, ps)
        for dim, ax in zip(spec.shape, ps):
            if ax:
                assert dim % mesh.shape[ax] == 0, (arch, path, ps)


@pytest.mark.parametrize("sizes,names,dim,want", [
    ((2, 16, 16), ("pod", "data", "model"), 256, ("pod", "data")),
    ((2, 16, 16), ("pod", "data", "model"), 1, None),
    ((2, 16, 16), ("pod", "data", "model"), 13, None),
    ((16, 16), ("data", "model"), 128, "data"),
])
def test_dp_spec(sizes, names, dim, want):
    assert port.dp_spec(port.abstract_mesh(sizes, names), dim) == want
    assert ref.dp_spec(ref.abstract_mesh(sizes, names), dim) == want


def _shard(i):
    from torch.distributed.tensor import Shard
    return Shard(i)


def _rep():
    from torch.distributed.tensor import Replicate
    return Replicate()


@pytest.mark.parametrize("sizes,names,spec,want", [
    ((16, 16), ("data", "model"), ("model", "data"), [1, 0]),
    ((16, 16), ("data", "model"), (None, "model", None), [None, 1]),
    ((2, 16, 16), ("pod", "data", "model"), (("pod", "data"), None, "model"), [0, 0, 2]),
    ((2, 4), ("data", "model"), (None, None), [None, None]),
    ((2, 4), ("data", "model"), (), [None, None]),
])
def test_placements(sizes, names, spec, want):
    """Shard(i) on every mesh dim that tensor dim i names, a tuple naming
    several; Replicate elsewhere."""
    got = port.placements(port.abstract_mesh(sizes, names), port.P(*spec))
    assert got == [_rep() if w is None else _shard(w) for w in want]


@pytest.fixture(scope="module")
def gloo_mesh():
    """A real (1, 1) DeviceMesh over a one-rank gloo world (made here and
    destroyed after, unless this process already had a world)."""
    from repro_torch.launch.mesh import make_host_mesh
    made = not dist.is_initialized()
    mesh = make_host_mesh(device="cpu")
    yield mesh
    if made:
        dist.destroy_process_group()


def test_placements_on_a_gloo_mesh(gloo_mesh):
    from torch.distributed.tensor import DTensor
    mesh = gloo_mesh
    assert tuple(mesh.mesh_dim_names) == ("data", "model") and tuple(mesh.shape) == (1, 1)
    full = torch.arange(64.0).reshape(8, 8)
    for spec, want in [(("data", "model"), [0, 1]), (("model", None), [None, 0]),
                       ((None, None), [None, None])]:
        sh = port.NamedSharding(mesh, port.P(*spec))
        assert sh.placements == [_rep() if w is None else _shard(w) for w in want]
        dt = port.shard_tensor(full, sh)
        assert isinstance(dt, DTensor) and list(dt.placements) == sh.placements
        assert torch.equal(dt.to_local(), full) and torch.equal(dt.full_tensor(), full)


def test_restore_refuses_a_mesh_on_another_device(gloo_mesh, tmp_path):
    """``load_pytree(shardings=)`` decodes on ``device``: a sharding whose
    mesh lies on another device type raises before the file is read."""
    from repro_torch.checkpoint import load_pytree, save_pytree
    save_pytree(str(tmp_path / "w.bskt"), {"w": torch.arange(8.0)})
    sh = {"w": port.NamedSharding(gloo_mesh, port.P(None))}
    got, _ = load_pytree(str(tmp_path / "w.bskt"), shardings=sh, device="cpu")
    assert torch.equal(got["w"].full_tensor(), torch.arange(8.0))
    with pytest.raises(ValueError, match="cpu mesh"):
        load_pytree(str(tmp_path / "w.bskt"), shardings=sh, device="meta")


def test_local_shape_refuses_uneven():
    mesh = port.abstract_mesh((2, 4), ("data", "model"))
    assert port.local_shape((8, 12), mesh, port.P("data", "model")) == (4, 3)
    assert port.local_shape((8, 12), mesh, port.P(("data", "model"), None)) == (1, 12)
    with pytest.raises(ValueError):
        port.local_shape((6, 12), mesh, port.P(None, ("data", "model")))


def test_meshes_over_the_world(gloo_mesh):
    """``make_host_mesh`` cuts its shape to the world, as the reference
    cuts it to the devices there are; ``make_production_mesh`` refuses a
    world of another size rather than shrink."""
    from repro_torch.launch.mesh import dp_axes, make_host_mesh, make_production_mesh
    m = make_host_mesh(2, 4, device="cpu")
    assert tuple(m.shape) == (1, 1) and dp_axes(m) == ("data",)
    for multi in (False, True):
        with pytest.raises(RuntimeError, match="needs a world of"):
            make_production_mesh(multi_pod=multi, device_type="cpu")

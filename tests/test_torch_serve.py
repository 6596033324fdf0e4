"""The port's serving slice on the CPU against the JAX package: configs
field for field (the port's own fields at their defaults, its own
architectures aside), the reduced rwkv6 model's weights carried across (numpy
and the checkpoint), its prefill and decode logits with the compressed TP
reduction off and on, and the serve engine's greedy tokens.

The JAX side runs once per module.  Tolerance: both packages compute the
same ops in the same types, and single bf16 elementwise ops and matmuls
agree bit for bit; what differs is float32 rounding inside
transcendentals and sums (exp, tanh, rsqrt, cumsum), which flips a bf16
rounding of the residual stream now and then, and XLA's fusions, which
skip some bf16 roundings.  The reference disagrees with itself on that
account: its jitted and its eager prefill of these weights differ by 1.2 %
(relative Frobenius error of the logits).  The bound is 2.5 times that,
3 %: the port measures 1.0 % from the jitted reference without compressed
TP and up to 1.8 % with it (a partial that differs in its last bit can
round to the neighbouring int8 step), and its greedy tokens are equal."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch.distributed as dist  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.checkpoint import save_pytree as jax_save  # noqa: E402
from repro.core.basket import ChecksumError as JaxChecksumError  # noqa: E402
from repro.configs import paper_io as jpaper_io  # noqa: E402
from repro.launch import serve as jax_launch_serve  # noqa: E402
from repro.models import Model as JaxModel  # noqa: E402
from repro.models import rwkv as jrwkv  # noqa: E402
from repro.models.specs import _unflatten  # noqa: E402
from repro.models.specs import tree_paths as jax_tree_paths  # noqa: E402
from repro.parallel.actctx import activation_context as jax_context  # noqa: E402
from repro.serve import ServeEngine as JaxEngine  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.checkpoint import (CheckpointManager, load_pytree,  # noqa: E402
                                    tree_from_numpy)
from repro_torch.core.basket import ChecksumError  # noqa: E402
from repro_torch.core.bfile import BasketFile  # noqa: E402
from repro_torch.configs import paper_io  # noqa: E402
from repro_torch.launch import serve as launch_serve  # noqa: E402
from repro_torch.models import Model, rwkv  # noqa: E402
from repro_torch.models.specs import tree_paths  # noqa: E402
from repro_torch.parallel import activation_context, one_rank_group  # noqa: E402
from repro_torch.serve import ServeEngine, sample_logits  # noqa: E402

ARCH = "rwkv6-1.6b"
# the port's own: an architecture the reference package does not have
PORT_ARCHS = ("deepseek-v2-lite",)
LOGITS_RTOL = 3e-2          # relative Frobenius error of the logits
PROMPTS = [40, 64, 64]      # 40 left-padded to 64, then one more admission
MAX_LEN, MAX_NEW, SLOTS = 128, 6, 2


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------

def _as_reference(got, want) -> dict:
    """``got``'s fields that the reference's config has; the port's own
    fields (latent attention, YaRN, the DeepSeekMoE gates) must hold their
    defaults, which leave the reference's architectures as they are."""
    d = dataclasses.asdict(got)
    own = d.keys() - dataclasses.asdict(want).keys()
    defaults = {f.name: f.default for f in dataclasses.fields(got) if f.name in own}
    assert {k: d.pop(k) for k in own} == defaults
    return d


@pytest.mark.parametrize("arch", jconfigs.list_archs())
def test_config_matches_reference(arch):
    want, got = jconfigs.get_config(arch), configs.get_config(arch)
    assert _as_reference(got, want) == dataclasses.asdict(want)
    assert _as_reference(configs.reduced(got), want) == \
        dataclasses.asdict(jconfigs.reduced(want))
    assert [s.name for s in configs.shapes_for(got)] == \
        [s.name for s in jconfigs.shapes_for(want)]


def test_registry_and_shapes_match_reference():
    assert [a for a in configs.list_archs() if a not in PORT_ARCHS] == \
        jconfigs.list_archs()
    assert {k: dataclasses.asdict(v) for k, v in configs.SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in jconfigs.SHAPES.items()}
    assert dataclasses.asdict(paper_io.PAPER_IO) == \
        dataclasses.asdict(jpaper_io.PAPER_IO)


# ---------------------------------------------------------------------------
# the reduced model, both packages
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tp_group():
    group = one_rank_group("gloo")
    yield group
    dist.destroy_process_group()


def _auto_mesh():
    # Auto axes: jax.make_mesh makes Explicit ones, which constrain() refuses
    return jax.sharding.Mesh(np.array(jax.devices()[:1]).reshape(1, 1),
                             ("data", "model"))


def _jax_params(cfg):
    """Reduced rwkv6 weights in bf16, drawn with numpy by the reference's
    init rules, except that the zero-initialised shifts and bonus are drawn
    too, so the token shift and the bonus term are exercised."""
    rng = np.random.default_rng(7)
    flat = {}
    for path, spec in sorted(jax_tree_paths(JaxModel(cfg).param_specs()).items()):
        if path.endswith((".mu", ".bonus_u")):
            arr = rng.random(spec.shape) * (0.5 if path.endswith("u") else 1.0)
        elif spec.init == "ones":
            arr = np.full(spec.shape, spec.scale)
        else:
            arr = rng.standard_normal(spec.shape) * spec.scale / np.sqrt(spec.shape[0])
        flat[path] = jnp.asarray(arr.astype(np.float32).astype(jnp.bfloat16))
    return _unflatten(flat)


def _prompts():
    rng = np.random.default_rng(3)
    return [rng.integers(2, 512, n).astype(np.int32) for n in PROMPTS]


def _jax_run(model, params, tokens, prompts=None):
    """prefill + two decode steps, and an engine run of ``prompts`` if
    given, as numpy.  The direct calls go through the engine's own jitted
    steps at the shapes its run uses, so each compiles once."""
    eng = JaxEngine(model, params, batch_slots=SLOTS, max_len=MAX_LEN, eos_id=-1)
    logits, cache = eng._prefill(params, {"tokens": jnp.asarray(tokens)})
    prefill_cache = {k: np.asarray(v, np.float32)
                     for k, v in jax_tree_paths(cache).items()}
    steps, tok = [], jnp.argmax(logits, -1)[:, None].astype(jnp.int32)
    for i in range(2):
        lg, cache = eng._decode(params, cache, tok,
                                jnp.asarray(tokens.shape[1] + i, jnp.int32))
        steps.append(np.asarray(lg))
        tok = jnp.argmax(lg, -1)[:, None].astype(jnp.int32)
    for p in prompts or ():
        eng.submit(p, MAX_NEW)
    return {"prefill": np.asarray(logits), "decode": steps,
            "cache": prefill_cache, "tokens": eng.run() if prompts else None}


@pytest.fixture(scope="module")
def jax_side():
    cfg = jconfigs.reduced(jconfigs.get_config(ARCH))
    model = JaxModel(cfg)
    params = _jax_params(cfg)
    tokens = np.random.default_rng(5).integers(
        2, cfg.vocab, (SLOTS, max(PROMPTS))).astype(np.int32)
    out = {"params": params, "tokens": tokens}
    try:
        jrwkv.PERF_FLAGS["compressed_tp"] = False
        out[False] = _jax_run(model, params, tokens)
        jrwkv.PERF_FLAGS["compressed_tp"] = True
        with _auto_mesh() as mesh, jax_context(mesh):
            out[True] = _jax_run(model, params, tokens, _prompts())
    finally:
        jrwkv.PERF_FLAGS["compressed_tp"] = False
    return out


@pytest.fixture(scope="module")
def port_model():
    return Model(configs.reduced(configs.get_config(ARCH)))


@pytest.fixture
def compressed(request, tp_group):
    """Compressed TP on (with a one-rank context) or off, as parametrized."""
    on = request.param
    rwkv.PERF_FLAGS["compressed_tp"] = on
    try:
        if on:
            with activation_context(tp_group):
                yield on
        else:
            yield on
    finally:
        rwkv.PERF_FLAGS["compressed_tp"] = False


def _port_params(jax_side):
    return tree_from_numpy(jax.tree.map(np.asarray, jax_side["params"]),
                           device="cpu")


def test_param_specs_match_reference(port_model):
    want = jax_tree_paths(JaxModel(port_model.cfg).param_specs())
    got = tree_paths(port_model.param_specs())
    assert sorted(got) == sorted(want)
    for path, spec in got.items():
        ref = want[path]
        assert (spec.shape, spec.axes, spec.init, spec.scale) == \
            (ref.shape, ref.axes, ref.init, ref.scale), path


def test_init_follows_reference_rules(port_model):
    params = port_model.init(torch.Generator().manual_seed(0), dtype=torch.bfloat16)
    flat, specs = tree_paths(params), tree_paths(port_model.param_specs())
    for path, spec in specs.items():
        t = flat[path]
        assert t.shape == spec.shape and t.dtype == torch.bfloat16, path
        if spec.init == "zeros":
            assert not t.any(), path
        elif spec.init == "ones":
            assert (t == spec.scale).all(), path
    # std = scale / sqrt(fan_in) with fan_in = shape[0], as the reference
    # takes it: for a group-stacked leaf that is the number of groups
    w = flat["layers.l0.tm.w_k"].float()
    assert w.shape[0] == 2 and abs(w.std().item() * 2 ** 0.5 - 1.0) < 0.1


def test_weights_carry_across_from_numpy(jax_side):
    params = _port_params(jax_side)
    want = jax_tree_paths(jax_side["params"])
    got = tree_paths(params)
    assert sorted(got) == sorted(want)
    for path, t in got.items():
        assert t.dtype == torch.bfloat16, path
        assert t.view(torch.int16).numpy().tobytes() == \
            np.asarray(want[path]).view(np.int16).tobytes(), path


def test_weights_carry_across_checkpoint(jax_side, tmp_path):
    path = str(tmp_path / "rwkv.bskt")
    jax_save(path, jax_side["params"])
    flat, _ = load_pytree(path, device="cpu")
    want = jax_tree_paths(jax_side["params"])
    assert sorted(flat) == sorted(want)
    for name, t in flat.items():
        assert t.dtype == torch.bfloat16, name
        assert t.view(torch.int16).numpy().tobytes() == \
            np.asarray(want[name]).view(np.int16).tobytes(), name


@pytest.mark.parametrize("compressed", [False, True], indirect=True,
                         ids=["plain", "compressed"])
def test_prefill_and_decode_match_jax(compressed, jax_side, port_model):
    ref = jax_side[compressed]
    params = _port_params(jax_side)
    with torch.no_grad():
        logits, cache = port_model.prefill(
            params, {"tokens": torch.from_numpy(jax_side["tokens"])}, MAX_LEN)
        assert logits.dtype == torch.float32
        assert _rel(logits, ref["prefill"]) < LOGITS_RTOL
        np.testing.assert_array_equal(logits.argmax(-1).numpy(),
                                      ref["prefill"].argmax(-1))
        got_cache = tree_paths(cache)
        for name, want in ref["cache"].items():
            assert got_cache[name].shape == want.shape, name
            assert _rel(got_cache[name].float(), want) < LOGITS_RTOL, name
        tok = logits.argmax(-1)[:, None]
        for i, want in enumerate(ref["decode"]):
            logits, cache = port_model.decode_step(
                params, cache, tok, jax_side["tokens"].shape[1] + i)
            assert _rel(logits, want) < LOGITS_RTOL, i
            np.testing.assert_array_equal(logits.argmax(-1).numpy(),
                                          want.argmax(-1))
            tok = logits.argmax(-1)[:, None]


@pytest.mark.parametrize("compressed", [True], indirect=True, ids=["compressed"])
def test_engine_greedy_tokens_match_jax(compressed, jax_side, port_model):
    """The serve path as it runs, compressed TP on (the engine itself does
    not depend on the flag; the logits test covers both settings)."""
    eng = ServeEngine(port_model, _port_params(jax_side), batch_slots=SLOTS,
                      max_len=MAX_LEN, eos_id=-1)
    rids = [eng.submit(p, MAX_NEW) for p in _prompts()]
    out = eng.run()
    want = jax_side[compressed]["tokens"]
    assert sorted(out) == sorted(want) == rids
    for rid in rids:
        np.testing.assert_array_equal(out[rid], want[rid])


def test_compressed_path_changes_the_logits(jax_side):
    """The quantization really runs, in both packages."""
    assert not np.array_equal(jax_side[True]["prefill"], jax_side[False]["prefill"])


def test_sample_logits():
    logits = torch.tensor([[0.0, 10.0, 0.0], [3.0, 1.0, 2.0]])
    assert sample_logits(logits).tolist() == [1, 0]
    draws = [sample_logits(logits, torch.Generator().manual_seed(s), 5.0)[0].item()
             for s in range(50)]
    assert len(set(draws)) > 1                     # high temperature samples
    again = [sample_logits(logits, torch.Generator().manual_seed(s), 5.0)[0].item()
             for s in range(50)]
    assert draws == again                          # the generator decides


def test_launch_serve_on_the_cpu(capsys):
    assert launch_serve.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                              "--requests", "3", "--prompt-len", "9",
                              "--max-new", "4", "--slots", "2"]) == 0
    assert capsys.readouterr().out.startswith("3 requests, 12 tokens in ")


@pytest.mark.parametrize("arch", ["qwen3-8b", "gemma2-9b"])
def test_launch_serve_dense_on_the_cpu(arch, capsys):
    """The default arch, and the one with local layers and softcaps."""
    argv = ["--reduced", "--device", "cpu", "--requests", "3", "--prompt-len", "9",
            "--max-new", "4", "--slots", "2"]
    assert launch_serve.main((["--arch", arch] if arch != "qwen3-8b" else []) + argv) == 0
    assert capsys.readouterr().out.startswith("3 requests, 12 tokens in ")


def _corrupt_first_basket(path: str) -> None:
    with BasketFile(path) as f:
        b = f.branches["w"]["baskets"][0]
    with open(path, "r+b") as fh:             # bytes inside the payload
        fh.seek(b["offset"] + 16)
        fh.write(b"\xff" * 16)


def test_launch_serve_refuses(monkeypatch, capsys, tmp_path):
    """``--ckpt-dir`` restores first in both drivers: a directory without a
    checkpoint raises FileNotFoundError, a corrupt one the same checksum
    error, and a valid one restores, then exits."""
    monkeypatch.chdir(tmp_path)
    drivers = (lambda a: jax_launch_serve.main(["--arch", ARCH, "--reduced"] + a),
               lambda a: launch_serve.main(["--arch", ARCH, "--reduced",
                                            "--device", "cpu"] + a))
    for main in drivers:
        with pytest.raises(FileNotFoundError, match="no checkpoints in ckpt"):
            main(["--ckpt-dir", "ckpt"])
    tree = {"w": torch.arange(40_000, dtype=torch.float32)}
    # stored without a codec: the flipped bytes decode and fail the checksum
    CheckpointManager("bad", profile="off").save(1, tree, wait=True)
    _corrupt_first_basket(str(tmp_path / "bad" / "ckpt-00000001.bskt"))
    messages = []
    for main, error in zip(drivers, (JaxChecksumError, ChecksumError)):
        with pytest.raises(error, match="corrupt beyond healing") as e:
            main(["--ckpt-dir", "bad"])
        messages.append(str(e.value))
    assert messages[0] == messages[1]
    CheckpointManager("good").save(1, tree, wait=True)
    for main in drivers:
        with pytest.raises(SystemExit, match="checkpoint serving wired via"):
            main(["--ckpt-dir", "good"])
    # the encoder-decoder arch: both drivers print their note, then the
    # engine's prefill finds no frames, in the reference as in the port
    argv = ["--arch", "seamless-m4t-medium", "--reduced", "--requests", "2"]
    for main in (jax_launch_serve.main,
                 lambda a: launch_serve.main(a + ["--device", "cpu"])):
        with pytest.raises(KeyError, match="frames"):
            main(argv)
        assert capsys.readouterr().out.startswith(
            "note: seamless-m4t-medium-smoke serving uses the LM decoder path")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launch_serve.build(launch_serve.parse_args(["--arch", ARCH, "--reduced"]))

"""The port's dense attention models on the CPU against the JAX package.

For each dense architecture at its ``reduced()`` config (qwen3-8b,
qwen2.5-14b, stablelm-12b, gemma2-9b, and paligemma-3b with and without its
image prefix): the parameter specs path by path (also those of the MoE,
Mamba and encoder-decoder archs), ``forward``'s hidden
states, ``loss`` with its metrics, the prefill's logits and KV cache, three
decode steps, and for qwen3-8b the greedy tokens of both serve engines.
The weights are drawn with numpy and carried across with
``tree_from_numpy``, and once through the reference's ``save_pytree`` and
the port's ``load_pytree``.  The JAX side runs jitted, once per case.

Tolerance.  In float32 (params and compute) the two packages agree to
about 1e-6 (relative Frobenius error): what is left is float32 rounding
inside transcendentals and sums.  ``F32_RTOL`` = 1e-5 holds them there, so a
wrong mask, head grouping or cast cannot hide.  The decode steps of that
case start from one shared cache (the reference's prefill, carried
across): the KV cache is bf16 in both packages, and a float32 k that
differs in its last bit can round to the neighbouring bf16 value, which
the next step's scores then carry.  In bf16 the port differs from the
reference by 0.7-1.3 %; the reference's own bf16 run differs from its
float32 run of the same weights by 0.7-1.2 % (the rounding of the
residual stream, which XLA's fusions skip in places and eager PyTorch does
not).  The bound is 2.5 times that, 3 %, the bound the rwkv6 serve slice
uses too (``tests/test_torch_serve.py``)."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.checkpoint import save_pytree as jax_save  # noqa: E402
from repro.models import Model as JaxModel  # noqa: E402
from repro.models.specs import _unflatten  # noqa: E402
from repro.models.specs import tree_paths as jax_tree_paths  # noqa: E402
from repro.serve import ServeEngine as JaxEngine  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.checkpoint import load_pytree, tree_from_numpy  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.models import layers  # noqa: E402
from repro_torch.models.specs import tree_paths  # noqa: E402
from repro_torch.serve import ServeEngine  # noqa: E402

BF16_RTOL = 3e-2
F32_RTOL = 1e-5
CASES = [("qwen3-8b", False), ("qwen2.5-14b", False), ("stablelm-12b", False),
         ("gemma2-9b", False), ("paligemma-3b", False), ("paligemma-3b", True)]
IDS = [a + ("-patches" if p else "") for a, p in CASES]
# the MoE, Mamba and encoder-decoder archs: specs here, the rest in
# tests/test_torch_families.py
FAMILIES = ["llama4-scout-17b-a16e", "llama4-maverick-400b-a17b", "jamba-v0.1-52b",
            "seamless-m4t-medium"]
B, S, MAX_LEN, S_CHUNK, STEPS = 2, 16, 32, 8, 3
PROMPTS = [10, 16, 16]          # 10 left-padded to 16, then one more admission
SLOTS, MAX_NEW = 2, 5


def _rel(got, want) -> float:
    got = np.asarray(got.float() if isinstance(got, torch.Tensor) else got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _cfg(arch: str, f32: bool):
    cfg = jconfigs.reduced(jconfigs.get_config(arch))
    port = configs.reduced(configs.get_config(arch))
    if f32:
        cfg = dataclasses.replace(cfg, dtype="float32")
        port = dataclasses.replace(port, dtype="float32")
    return cfg, port


def _weights(cfg, f32: bool, seed: int = 0):
    """The reference's tree drawn with numpy: normal leaves at 1/sqrt(d_model),
    norm scales 1 + noise and biases noise, so every term is exercised."""
    rng = np.random.default_rng(seed)
    flat = {}
    for path, spec in sorted(jax_tree_paths(JaxModel(cfg).param_specs()).items()):
        if spec.init == "ones":
            arr = spec.scale + 0.1 * rng.standard_normal(spec.shape)
        elif spec.init == "zeros":
            arr = 0.1 * rng.standard_normal(spec.shape)
        else:
            arr = rng.standard_normal(spec.shape) * spec.scale / np.sqrt(cfg.d_model)
        arr = arr.astype(np.float32)
        flat[path] = jnp.asarray(arr if f32 else arr.astype(jnp.bfloat16))
    return _unflatten(flat)


def _batch(cfg, patches: bool, seed: int = 1) -> dict:
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(2, cfg.vocab, (B, S)).astype(np.int32),
           "targets": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32),
           "loss_mask": (rng.random((B, S)) < 0.8).astype(np.float32)}
    if patches:
        out["patches"] = rng.standard_normal(
            (B, cfg.n_img_tokens, cfg.d_model)).astype(np.float32)
    return out


def _jax_side(arch: str, patches: bool, f32: bool) -> dict:
    """Everything the reference computes for one case, jitted once: forward,
    loss, prefill, and decode steps fed with its own greedy tokens."""
    cfg, _ = _cfg(arch, f32)
    model = JaxModel(cfg)
    params = _weights(cfg, f32)
    batch = _batch(cfg, patches)
    prefix = cfg.n_img_tokens if patches else 0

    @jax.jit
    def run(params, batch):
        h, aux = model.forward(params, batch)
        loss, metrics = model.loss(params, batch, s_chunk=S_CHUNK)
        pb = {k: v for k, v in batch.items() if k in ("tokens", "patches")}
        logits, cache = model.prefill(params, pb, MAX_LEN)
        prefill_cache = cache
        steps, toks = [], []
        for i in range(STEPS):
            tok = jnp.argmax(logits, -1)[:, None].astype(jnp.int32)
            logits, cache = model.decode_step(params, cache, tok,
                                              jnp.asarray(prefix + S + i, jnp.int32))
            steps.append(logits)
            toks.append(tok)
        return h, loss, metrics, prefill_cache, steps, toks

    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    h, loss, metrics, cache, steps, toks = run(params, jb)
    prefill_logits, _ = jax.jit(lambda p, b: model.prefill(p, b, MAX_LEN))(
        params, {k: v for k, v in jb.items() if k in ("tokens", "patches")})
    return {"params": params, "batch": batch, "prefix": prefix,
            "hidden": np.asarray(h, np.float32), "loss": float(loss),
            "metrics": {k: float(v) for k, v in metrics.items()},
            "prefill": np.asarray(prefill_logits),
            "cache": jax.tree.map(np.asarray, cache),
            "decode": [np.asarray(s) for s in steps],
            "tokens": [np.asarray(t) for t in toks]}


@pytest.fixture(scope="module", params=CASES, ids=IDS)
def case(request):
    arch, patches = request.param
    return {"arch": arch, "patches": patches,
            "jax": _jax_side(arch, patches, f32=False),
            "model": Model(_cfg(arch, False)[1])}


@pytest.fixture(scope="module", params=CASES, ids=IDS)
def case_f32(request):
    arch, patches = request.param
    return {"arch": arch, "patches": patches,
            "jax": _jax_side(arch, patches, f32=True),
            "model": Model(_cfg(arch, True)[1])}


def _port_params(ref: dict):
    return tree_from_numpy(jax.tree.map(np.asarray, ref["params"]), device="cpu")


def _port_batch(ref: dict, keys=("tokens", "targets", "loss_mask", "patches")) -> dict:
    return {k: torch.tensor(v) for k, v in ref["batch"].items() if k in keys}


# ---------------------------------------------------------------------------
# specs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", sorted({a for a, _ in CASES} | set(FAMILIES)))
def test_param_specs_match_reference(arch):
    cfg, port = _cfg(arch, False)
    want = jax_tree_paths(JaxModel(cfg).param_specs())
    got = tree_paths(Model(port).param_specs())
    assert sorted(got) == sorted(want)
    for path, spec in got.items():
        ref = want[path]
        assert (spec.shape, spec.axes, spec.init, spec.scale) == \
            (ref.shape, ref.axes, ref.init, ref.scale), path
    meta = tree_paths(Model(port).abstract(torch.bfloat16))
    for path, ref in jax_tree_paths(JaxModel(cfg).abstract(jnp.bfloat16)).items():
        assert meta[path].is_meta and tuple(meta[path].shape) == ref.shape, path
        assert meta[path].dtype == torch.bfloat16, path


@pytest.mark.parametrize("flag", ["rms_einsum", "softmax_bf16_probs"])
def test_perf_variants_name_their_item(flag, monkeypatch):
    model = Model(_cfg("qwen3-8b", False)[1])
    params = model.init(torch.Generator().manual_seed(0))
    monkeypatch.setitem(layers.PERF_FLAGS, flag, True)
    with pytest.raises(NotImplementedError, match="ROADMAP A12"):
        model.forward(params, {"tokens": torch.zeros((1, 4), dtype=torch.long)})


# ---------------------------------------------------------------------------
# forward, loss, prefill, decode: bf16 and float32
# ---------------------------------------------------------------------------

def _check_forward_and_loss(c, rtol):
    ref, model = c["jax"], c["model"]
    params = _port_params(ref)
    with torch.no_grad():
        h, aux = model.forward(params, _port_batch(ref, ("tokens", "patches")))
        loss, metrics = model.loss(params, _port_batch(ref), s_chunk=S_CHUNK)
    assert h.shape == ref["hidden"].shape
    assert _rel(h, ref["hidden"]) < rtol
    assert not aux["lb_loss"] and not aux["z_loss"]
    assert sorted(metrics) == sorted(ref["metrics"])
    assert abs(loss.item() - ref["loss"]) < rtol * abs(ref["loss"])
    for k in ("xent", "loss"):
        assert abs(metrics[k].item() - ref["metrics"][k]) < rtol * abs(ref["metrics"][k]), k
    assert metrics["tokens"].item() == ref["metrics"]["tokens"] == \
        ref["batch"]["loss_mask"].sum()
    # accuracy counts argmax hits: the same tokens in both packages
    assert abs(metrics["accuracy"].item() - ref["metrics"]["accuracy"]) <= \
        1.0 / ref["metrics"]["tokens"]


def _check_prefill_and_decode(c, rtol, shared_cache):
    ref, model = c["jax"], c["model"]
    params = _port_params(ref)
    with torch.no_grad():
        logits, cache = model.prefill(params, _port_batch(ref, ("tokens", "patches")),
                                      MAX_LEN)
        assert logits.dtype == torch.float32
        assert _rel(logits, ref["prefill"]) < rtol
        want_cache = jax_tree_paths(ref["cache"])
        got_cache = tree_paths(cache)
        assert sorted(got_cache) == sorted(want_cache)
        for name, want in want_cache.items():
            got = got_cache[name]
            assert got.dtype == torch.bfloat16 and got.shape == want.shape, name
            want = want.astype(np.float32)
            if shared_cache:
                # float32 k and v within F32_RTOL of the tensor's scale,
                # then rounded to the bf16 cache: at most one bf16 step apart
                assert np.all(np.abs(got.float().numpy() - want)
                              <= 2.0 ** -7 * np.abs(want)
                              + rtol * np.abs(want).max()), name
            else:
                assert _rel(got, want) < rtol, name
        if shared_cache:
            cache = tree_from_numpy(ref["cache"], device="cpu")
        for i, want in enumerate(ref["decode"]):
            tok = torch.tensor(ref["tokens"][i])
            logits, cache = model.decode_step(params, cache, tok,
                                              ref["prefix"] + S + i)
            assert _rel(logits, want) < rtol, i


@pytest.mark.parametrize("kind", ["forward_loss", "prefill_decode"])
def test_bf16_matches_jax(case, kind):
    if kind == "forward_loss":
        _check_forward_and_loss(case, BF16_RTOL)
    else:
        _check_prefill_and_decode(case, BF16_RTOL, shared_cache=False)


@pytest.mark.parametrize("kind", ["forward_loss", "prefill_decode"])
def test_float32_matches_jax_tightly(case_f32, kind):
    if kind == "forward_loss":
        _check_forward_and_loss(case_f32, F32_RTOL)
    else:
        _check_prefill_and_decode(case_f32, F32_RTOL, shared_cache=True)


def test_weights_carry_across_checkpoint(case, tmp_path):
    """The reference's save, the port's load: the same bits, the same logits."""
    ref, model = case["jax"], case["model"]
    path = str(tmp_path / "dense.bskt")
    jax_save(path, ref["params"])
    flat, _ = load_pytree(path, device="cpu")
    want = tree_paths(_port_params(ref))
    assert sorted(flat) == sorted(want)
    for name, t in flat.items():
        assert t.dtype == torch.bfloat16, name
        assert torch.equal(t.view(torch.int16), want[name].view(torch.int16)), name
    params = _unflatten(flat)
    with torch.no_grad():
        logits, _ = model.prefill(params, _port_batch(ref, ("tokens", "patches")),
                                  MAX_LEN)
    assert _rel(logits, ref["prefill"]) < BF16_RTOL


@pytest.mark.parametrize("arch", ["qwen3-8b", "gemma2-9b", "rwkv6-1.6b"])
def test_decode_step_writes_kv_in_place_and_stacks_states(arch):
    """A decode step writes its keys and values into the given KV cache
    (the leaves returned are the ones given, slot ``pos`` changed) and
    returns each recurrent state as one new stacked tensor, the given one
    untouched."""
    model = Model(configs.reduced(configs.get_config(arch)))
    params = model.init(torch.Generator().manual_seed(0))
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        2, model.cfg.vocab, (B, S)).astype(np.int32))
    with torch.no_grad():
        _, cache = model.prefill(params, {"tokens": tokens}, MAX_LEN)
        before = {k: v.clone() for k, v in tree_paths(cache).items()}
        _, new = model.decode_step(params, cache, tokens[:, :1], S)
    given, got = tree_paths(cache), tree_paths(new)
    assert sorted(got) == sorted(given)
    for path, leaf in got.items():
        if path.rsplit(".", 1)[-1] in ("k", "v"):
            assert leaf is given[path]
            assert torch.equal(leaf[:, :, :S], before[path][:, :, :S])
            assert not torch.equal(leaf[:, :, S], before[path][:, :, S])
        else:
            assert leaf is not given[path]
            assert torch.equal(given[path], before[path])
            assert leaf.shape == before[path].shape
            assert not torch.equal(leaf, before[path])


# ---------------------------------------------------------------------------
# the serve engines: left padding, two admissions, greedy
# ---------------------------------------------------------------------------

def test_engine_greedy_tokens_match_jax():
    cfg, port = _cfg("qwen3-8b", False)
    params = _weights(cfg, f32=False, seed=4)
    rng = np.random.default_rng(3)
    prompts = [rng.integers(2, cfg.vocab, n).astype(np.int32) for n in PROMPTS]
    jeng = JaxEngine(JaxModel(cfg), params, batch_slots=SLOTS, max_len=MAX_LEN,
                     eos_id=-1)
    for p in prompts:
        jeng.submit(p, MAX_NEW)
    want = jeng.run()
    eng = ServeEngine(Model(port), tree_from_numpy(jax.tree.map(np.asarray, params),
                                                   device="cpu"),
                      batch_slots=SLOTS, max_len=MAX_LEN, eos_id=-1)
    rids = [eng.submit(p, MAX_NEW) for p in prompts]
    out = eng.run()
    assert sorted(out) == sorted(want) == rids
    for rid in rids:
        assert len(out[rid]) == MAX_NEW
        np.testing.assert_array_equal(out[rid], want[rid])


def test_init_cache_defaults_to_the_card(monkeypatch):
    """With no device named, the cache goes where every entry point goes:
    the card, or an error that names ``device="cpu"`` when there is none."""
    model = Model(configs.reduced(configs.get_config("qwen3-8b")))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        model.init_cache(2, 16)
    cache = model.init_cache(2, 16, device="cpu")
    k = cache["l0"]["self"]["k"]
    assert k.device.type == "cpu" and k.shape[:3] == (model.cfg.n_groups, 2, 16)

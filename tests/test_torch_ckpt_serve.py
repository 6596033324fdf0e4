"""Checkpoint serving in the port against the JAX package: the reduced
qwen3-8b's ``init_train_state`` (no training), saved by either package's
``CheckpointManager``, restored as the two examples restore it (the
template of the train state, float32 params cast to bf16) and served
greedily by both engines gives the same tokens.  Temperature sampling
draws from ``torch.Generator``, whose stream is not ``jax.random``'s, so
``sample_logits`` at T = 0.7 is held to ``softmax(logits / T)`` by the
frequencies of its draws.  The examples themselves run on the CPU.

The reference's engine steps are compiled with ``xla_allow_excess_precision``
off (``_strict_jit``, as in ``tests/test_torch_families.py``): with XLA's
default its fusions skip bf16 roundings that eager PyTorch makes, and on
these weights that flips one of the 36 greedy tokens."""

import importlib.util
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint import CheckpointManager as JaxManager  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import reduced as jax_reduced  # noqa: E402
from repro.models import Model as JaxModel  # noqa: E402
from repro.serve import ServeEngine as JaxEngine  # noqa: E402
from repro.train import init_train_state as jax_init_train_state  # noqa: E402
from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.serve import ServeEngine, sample_logits  # noqa: E402
from repro_torch.train import init_train_state  # noqa: E402

EXAMPLES = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "examples")
PROMPTS = [8, 12, 12]
SLOTS, MAX_LEN, MAX_NEW = 2, 40, 6


class _strict_jit:
    """``jax.jit`` of ``fn`` compiled with ``xla_allow_excess_precision``
    off, once per input signature: the reference rounds to bf16 wherever
    its source casts, as eager PyTorch does."""

    def __init__(self, fn):
        self.fn, self.compiled = jax.jit(fn), {}

    def __call__(self, *args):
        key = str(jax.tree.map(lambda a: (jnp.shape(a), jnp.result_type(a)), args))
        if key not in self.compiled:
            self.compiled[key] = self.fn.lower(*args).compile(
                compiler_options={"xla_allow_excess_precision": False})
        return self.compiled[key](*args)


def _example(name: str):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(EXAMPLES, name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def models():
    return (JaxModel(jax_reduced(jax_get_config("qwen3-8b"))),
            Model(reduced(get_config("qwen3-8b"))))


def _save_reference(model, directory):
    s = jax_init_train_state(model, jax.random.key(0))
    JaxManager(directory).save(0, {"params": s.params, "opt": s.opt,
                                   "step": s.step, "err": s.err}, wait=True)


def _save_port(model, directory):
    s = init_train_state(model, torch.Generator().manual_seed(0))
    CheckpointManager(directory).save(0, {"params": s.params, "opt": s.opt,
                                          "step": s.step, "err": s.err}, wait=True)


def _serve_reference(model, directory, prompts):
    """``examples/serve_lm.py``'s restore and cast, served greedily."""
    s = jax_init_train_state(model, jax.random.key(0))
    tree, _ = JaxManager(directory).restore(
        template={"params": s.params, "opt": s.opt, "step": s.step, "err": s.err})
    params = jax.tree.map(lambda p: p.astype(jnp.bfloat16)
                          if p.dtype == jnp.float32 else p, tree["params"])
    eng = JaxEngine(model, params, batch_slots=SLOTS, max_len=MAX_LEN, eos_id=-1)
    eng._prefill = _strict_jit(lambda p, b: model.prefill(p, b, max_len=MAX_LEN))
    eng._decode = _strict_jit(model.decode_step)
    for p in prompts:
        eng.submit(p, MAX_NEW)
    return eng.run()


def _serve_port(model, directory, prompts):
    """``examples/serve_lm_torch.py``'s restore and cast, served greedily."""
    tree, _, params = _example("serve_lm_torch").restore_params(
        CheckpointManager(directory), model, torch.device("cpu"))
    assert int(tree["step"]) == 0 and tree["err"] is None
    assert all(t.dtype == torch.bfloat16 for t in _leaves(params))
    eng = ServeEngine(model, params, batch_slots=SLOTS, max_len=MAX_LEN, eos_id=-1)
    rids = [eng.submit(p, MAX_NEW) for p in prompts]
    out = eng.run()
    assert sorted(out) == rids
    return out


def _leaves(tree):
    for v in tree.values():
        yield from (_leaves(v) if isinstance(v, dict) else [v])


@pytest.mark.parametrize("saved_by", ["reference", "port"])
def test_checkpoint_serves_equal_greedy_tokens(models, tmp_path, saved_by):
    jmodel, model = models
    directory = str(tmp_path / "ckpt")
    if saved_by == "reference":
        _save_reference(jmodel, directory)
    else:
        _save_port(model, directory)
    rng = np.random.default_rng(3)
    prompts = [rng.integers(2, model.cfg.vocab, n).astype(np.int32)
               for n in PROMPTS]
    want = _serve_reference(jmodel, directory, prompts)
    got = _serve_port(model, directory, prompts)
    assert sorted(got) == sorted(want)
    for rid in got:
        assert len(got[rid]) == MAX_NEW
        np.testing.assert_array_equal(got[rid], want[rid])


def test_sample_logits_draws_follow_softmax():
    """20 000 draws of one row at T = 0.7 against softmax(logits / T): each
    frequency within 5 standard errors of its probability, and zero
    probability never drawn."""
    n, t = 20_000, 0.7
    row = torch.tensor([2.0, 1.5, 0.3, -1.0, 0.0, 1.0, -30.0, 0.7])
    p = torch.softmax(row.double() / t, -1).numpy()
    draws = sample_logits(row.expand(n, -1), torch.Generator().manual_seed(11), t)
    assert draws.dtype == torch.int32 and draws.shape == (n,)
    freq = np.bincount(draws.numpy(), minlength=row.numel()) / n
    se = np.sqrt(p * (1 - p) / n)
    assert np.all(np.abs(freq - p) <= 5 * se + 1e-12), (freq, p)
    assert freq[6] == 0.0


def test_serve_example_on_the_cpu(tmp_path, capsys):
    wd = str(tmp_path / "wd")
    mod = _example("serve_lm_torch")
    assert mod.main(["--device", "cpu", "--steps", "2", "--workdir", wd]) == 0
    out = capsys.readouterr().out
    assert "training 2 quick steps first" in out
    assert "restored step 2" in out and "served 12 requests / 144 tokens" in out
    # a second run finds the checkpoint and serves without training
    assert mod.main(["--device", "cpu", "--workdir", wd]) == 0
    out = capsys.readouterr().out
    assert "training" not in out and "restored step 2" in out


def test_train_example_on_the_cpu(tmp_path, capsys):
    wd = str(tmp_path / "wd")
    assert _example("train_lm_torch").main(
        ["--device", "cpu", "--steps", "2", "--workdir", wd]) == 0
    assert "final ckpt:" in capsys.readouterr().out
    assert os.path.exists(os.path.join(wd, "ckpt", "ckpt-00000002.bskt"))

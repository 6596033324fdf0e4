"""The port's MoE FFN on the CPU against the JAX package's.

``moe_ffn`` at the reduced llama4-scout config (top-1 of 4 experts and a
shared expert) and the reduced jamba config (top-2 of 4), each with the
configs' capacity factor 1.25, where assignments drop, and dropless
(``capacity_factor = E / K``): outputs and the aux losses, in float32 and
in bf16; the gradients of x and of every weight against ``jax.grad`` of
the reference's ``custom_vjp`` gathers; the tie rule of the router's and
the slots' selections.  Inputs are drawn with numpy; the JAX side runs
jitted.

Tolerance.  In float32 the two agree to about 1e-7 (relative Frobenius
error), the sums of the float32 router and the expert matmuls taken in
another order; ``F32_RTOL`` = 1e-5 holds them there, gradients included
(PyTorch's scatter-add of the forward gathers sums at most K terms a
token, the reference's backward gathers the same terms).  Measured: the
gradients of x and of the experts' weights 4e-8 to 2.3e-7; the router's
2e-7 for top-2 and 9.4-9.95e-6 for top-1, where the renormalised gate is
g / g: its derivative is zero in exact arithmetic, so the router's
gradient is the aux losses' (norm about 2) plus the rounding residue of
1/g - g/g^2, which the two frameworks round differently.  In bf16 the
port equals the reference run eagerly and is 0.26 % from the jitted one,
whose fusions skip some bf16 roundings; ``BF16_RTOL`` is 3 %, the dense
path's bound."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models.specs import _unflatten  # noqa: E402
from repro.models.specs import tree_paths as jax_tree_paths  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.models.specs import tree_paths  # noqa: E402

F32_RTOL = 1e-5
BF16_RTOL = 3e-2
B, S = 2, 16
ARCHS = {"top1-shared": "llama4-scout-17b-a16e", "top2": "jamba-v0.1-52b"}
CASES = [(k, drops) for k in ARCHS for drops in (True, False)]
IDS = [f"{k}-{'drops' if d else 'dropless'}" for k, d in CASES]


def _rel(got, want) -> float:
    got = np.asarray(got.float() if isinstance(got, torch.Tensor) else got, np.float64)
    want = np.asarray(np.asarray(want, np.float32), np.float64)
    den = np.linalg.norm(want)
    return float(np.linalg.norm(got - want) / (den if den else 1.0))


def _cfgs(kind: str, drops: bool, dtype: str = "float32"):
    arch = ARCHS[kind]
    cfg = jconfigs.reduced(jconfigs.get_config(arch))
    port = configs.reduced(configs.get_config(arch))
    cf = cfg.capacity_factor if drops else cfg.n_experts / cfg.experts_per_token
    return (dataclasses.replace(cfg, capacity_factor=cf, dtype=dtype),
            dataclasses.replace(port, capacity_factor=cf, dtype=dtype))


def _draw(cfg, seed: int = 0):
    """(weights as float32 numpy by path, x (B, S, d))."""
    rng = np.random.default_rng(seed)
    flat = {path: (rng.standard_normal(spec.shape) * spec.scale
                   / np.sqrt(cfg.d_model)).astype(np.float32)
            for path, spec in sorted(jax_tree_paths(jmoe.moe_specs(cfg)).items())}
    x = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    return flat, x


def _jax(flat, dt):
    return _unflatten({k: jnp.asarray(v).astype(dt) for k, v in flat.items()})


def _torch(flat, dt, requires_grad=False):
    return _unflatten({k: torch.tensor(v).to(dt).requires_grad_(requires_grad)
                       for k, v in flat.items()})


def _run_both(cfg, port, flat, x, bf16: bool):
    jdt, tdt = (jnp.bfloat16, torch.bfloat16) if bf16 else (jnp.float32, torch.float32)
    jout, jaux = jax.jit(lambda p, x: jmoe.moe_ffn(p, x, cfg))(
        _jax(flat, jdt), jnp.asarray(x).astype(jdt))
    with torch.no_grad():
        tout, taux = moe.moe_ffn(_torch(flat, tdt), torch.tensor(x).to(tdt), port)
    return (tout, taux), (np.asarray(jout.astype(jnp.float32)), jaux)


def test_specs_match_reference():
    for kind in ARCHS:
        cfg, port = _cfgs(kind, True)
        want = jax_tree_paths(jmoe.moe_specs(cfg))
        got = tree_paths(moe.moe_specs(port))
        assert sorted(got) == sorted(want)
        for path, spec in got.items():
            ref = want[path]
            assert (spec.shape, spec.axes, spec.init, spec.scale) == \
                (ref.shape, ref.axes, ref.init, ref.scale), path


@pytest.mark.parametrize("kind,drops", CASES, ids=IDS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_ffn_matches_reference(kind, drops, dtype):
    cfg, port = _cfgs(kind, drops)
    flat, x = _draw(cfg)
    bf16 = dtype == "bfloat16"
    (tout, taux), (jout, jaux) = _run_both(cfg, port, flat, x, bf16)
    assert tout.dtype == (torch.bfloat16 if bf16 else torch.float32)
    assert tuple(tout.shape) == jout.shape == (B, S, cfg.d_model)
    rtol = BF16_RTOL if bf16 else F32_RTOL
    assert _rel(tout, jout) < rtol
    for k in ("lb_loss", "z_loss"):
        assert taux[k].dtype == torch.float32 and taux[k].shape == ()
        assert abs(taux[k].item() - float(jaux[k])) <= rtol * abs(float(jaux[k])), k


@pytest.mark.parametrize("kind", list(ARCHS))
def test_capacity_drops_assignments(kind):
    """At the configs' capacity factor some assignments find their
    expert full (the outputs of both packages differ from the dropless
    run's); dropless, every token gets sum_k gate_k FFN_{e_k}(x) (+ the
    shared expert), the loop over the experts of ``tests/test_moe.py``."""
    cfg, port = _cfgs(kind, True)
    flat, x = _draw(cfg)
    with torch.no_grad():
        capped, _ = moe.moe_ffn(_torch(flat, torch.float32), torch.tensor(x), port)
        _, free = _cfgs(kind, False)
        dropless, _ = moe.moe_ffn(_torch(flat, torch.float32), torch.tensor(x), free)
    assert not torch.allclose(capped, dropless)
    p = _torch(flat, torch.float32)
    xt = torch.tensor(x)
    probs = torch.softmax(xt @ p["router"], -1)
    K = cfg.experts_per_token
    idx = torch.from_numpy(np.argsort(-probs.numpy(), -1, kind="stable")[..., :K])
    gate = torch.gather(probs, -1, idx)
    gate = gate / gate.sum(-1, keepdim=True)
    want = torch.zeros_like(xt)
    for k in range(K):
        for e in range(cfg.n_experts):
            sel = (idx[..., k] == e)[..., None]
            w = {n: p[n][e] for n in ("w_gate", "w_up", "w_down")}
            want = want + torch.where(sel, gate[..., k:k + 1] * moe._dense_ffn(
                w, xt, cfg.ffn_act), 0.0)
    if cfg.shared_expert:
        want = want + moe._dense_ffn(p["shared"], xt, cfg.ffn_act)
    assert _rel(dropless, want.numpy()) < F32_RTOL


@pytest.mark.parametrize("kind,drops", CASES, ids=IDS)
def test_gradients_match_jax_grad(kind, drops):
    """d/d(x, every weight) of sum(out * r) + the aux losses, float32."""
    cfg, port = _cfgs(kind, drops)
    flat, x = _draw(cfg)
    r = np.random.default_rng(9).standard_normal(x.shape).astype(np.float32)

    def jloss(p, x):
        out, aux = jmoe.moe_ffn(p, x, cfg)
        return jnp.sum(out * r) + aux["lb_loss"] + aux["z_loss"]

    jgp, jgx = jax.jit(jax.grad(jloss, argnums=(0, 1)))(_jax(flat, jnp.float32),
                                                        jnp.asarray(x))
    p = _torch(flat, torch.float32, requires_grad=True)
    xt = torch.tensor(x, requires_grad=True)
    out, aux = moe.moe_ffn(p, xt, port)
    (torch.sum(out * torch.tensor(r)) + aux["lb_loss"] + aux["z_loss"]).backward()
    assert _rel(xt.grad, jgx) < F32_RTOL
    want = jax_tree_paths(jgp)
    got = tree_paths(p)
    assert sorted(got) == sorted(want)
    for path, leaf in got.items():
        assert leaf.grad is not None, path
        assert _rel(leaf.grad, want[path]) < F32_RTOL, (path, _rel(leaf.grad, want[path]))


def test_selection_breaks_ties_toward_the_lower_index():
    """``_top_k`` picks what ``jax.lax.top_k`` picks on rows of equal
    values, largest and smallest first."""
    rng = np.random.default_rng(3)
    x = rng.integers(0, 3, (64, 16)).astype(np.float32)
    for k in (1, 2, 5, 16):
        jv, ji = jax.lax.top_k(jnp.asarray(x), k)
        tv, ti = moe._top_k(torch.tensor(x), k, largest=True)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
        jv, ji = jax.lax.top_k(-jnp.asarray(x), k)
        tv, ti = moe._top_k(torch.tensor(x), k, largest=False)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(-tv.numpy(), np.asarray(jv))


@pytest.mark.parametrize("kind", list(ARCHS))
def test_tied_router_picks_the_reference_expert(kind):
    """Experts 1 and 2 share one router column, so every token's
    probabilities for them tie, and one token is all zeros (uniform
    probabilities): the reference takes the lower index each time, and so
    must the port, whose outputs then agree (the experts' weights differ)."""
    cfg, port = _cfgs(kind, True)
    flat, x = _draw(cfg)
    flat["router"][:, 2] = flat["router"][:, 1]
    x[0, 3] = 0.0
    (tout, taux), (jout, jaux) = _run_both(cfg, port, flat, x, bf16=False)
    assert _rel(tout, jout) < F32_RTOL
    assert abs(taux["lb_loss"].item() - float(jaux["lb_loss"])) <= \
        F32_RTOL * float(jaux["lb_loss"])
    # the other choice gives another output: the test can tell them apart
    swapped = dict(flat)
    for n in ("w_gate", "w_up", "w_down"):
        swapped[n] = flat[n][[0, 2, 1, 3]]
    (sout, _), _ = _run_both(cfg, port, swapped, x, bf16=False)
    assert _rel(sout, jout) > 1e-2

"""The Mamba layer's selective-scan kernel (``kernels/selective_scan.py``).

On the CPU: the rule that picks the kernel (a real CUDA tensor with
autograd off), the wrapper's refusals, and the kernel's order of the
float32 operations.  The kernel runs t in sequence, where the reference
runs ``lax.associative_scan``'s odd-even recursion; ``_sequential`` below
repeats the kernel's order in a few lines of PyTorch, and
:func:`test_sequential_order_meets_the_reference_bound` holds it to the
JAX scan and the JAX ``mamba`` within ``F32_RTOL``, the bound
``tests/test_torch_ssm.py`` holds the eager scan to.  The same stand-in,
put in the kernel's place, runs the kernel path's Python on the CPU.

On the CPU too, under a one-rank gloo mesh: the kernel path's Python on
the DTensors' local shards, with the stand-in.

On the card (``cuda`` marker, skipped without a GPU; ``python -m pytest
-q -m cuda tests/test_torch_selective_scan.py``): the kernel against the
eager scan, which ``models/ssm.py`` runs on the card under autograd, at the
reduced jamba config (float32) and at the benchmark cell's widths (B 8,
d_inner 8192, d_state 16, bf16 x), for S in ``LENGTHS`` from a zero and a
non-zero state; ``mamba`` in float32 and bf16, the decode steps after a
prefill, the ``mamba_bf16_y`` variant, the launch counter (and the eager
scan for what the kernel is not built for), and the layer under a
one-card nccl mesh.  Tolerances
are ``tests/test_torch_ssm.py``'s: relative Frobenius 1e-5 in float32, 3 %
on bf16 outputs.  This file imports JAX only inside the CPU tests that
compare with it: the card's machine has none."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import configs  # noqa: E402
from repro_torch.kernels import selective_scan as sscan  # noqa: E402
from repro_torch.models import ssm  # noqa: E402
from repro_torch.models.specs import tree_paths  # noqa: E402

F32_RTOL = 1e-5
BF16_RTOL = 3e-2
ARCH = "jamba-v0.1-52b"
LENGTHS = [1, 63, 64, 258, 510, 512]


def _rel(got, want) -> float:
    got, want = (np.asarray(t.detach().float().cpu() if isinstance(t, torch.Tensor) else t,
                            np.float64) for t in (got, want))
    den = np.linalg.norm(want)
    return float(np.linalg.norm(got - want) / (den if den else 1.0))


def _sequential(dt, x, bc, a, h0):
    """The kernel's order: t in sequence, h = exp(dt A) h + (dt x) B, y = C h."""
    n = a.shape[1]
    bm, cm = bc.float()[..., :n], bc.float()[..., n:]
    h, ys = h0, []
    for t in range(x.shape[1]):
        dx = dt[:, t] * x[:, t].float()
        h = torch.exp(dt[:, t, :, None] * a) * h + dx[..., None] * bm[:, t, None, :]
        ys.append(torch.einsum("bcn,bn->bc", h, cm[:, t]))
    return torch.stack(ys, 1), h


def _scan_inputs(B, S, di, n, dtype, h0, seed=0, device="cpu"):
    """dt (softplus of a normal around the dt bias's init), x and bc at unit
    scale, A = -exp(a_log) around a_log's init, h0 zero or normal."""
    g = torch.Generator().manual_seed(seed)
    dt = ssm._softplus(0.5 * torch.randn(B, S, di, generator=g) + 0.01)
    x = torch.randn(B, S, di, generator=g).to(dtype)
    bc = torch.randn(B, S, 2 * n + 3, generator=g).to(dtype)[..., 3:]  # a view, as xp's
    a = -torch.exp(1.0 + 0.1 * torch.randn(di, n, generator=g))
    h = torch.randn(B, di, n, generator=g) if h0 else torch.zeros(B, di, n)
    return tuple(t.to(device) for t in (dt, x, bc, a, h))


def _weights(cfg, seed=0, dtype=torch.float32, device="cpu"):
    """The mixer's weights as ``tests/test_torch_ssm.py`` draws them."""
    g = torch.Generator().manual_seed(seed)
    out = {}
    for path, spec in sorted(tree_paths(ssm.mamba_specs(cfg)).items()):
        r = torch.randn(spec.shape, generator=g)
        if spec.init == "ones":
            arr = spec.scale + 0.1 * r
        elif spec.init == "zeros":
            arr = 0.1 * r
        else:
            arr = r * spec.scale / np.sqrt(cfg.d_model)
        out[path] = arr.to(dtype).to(device)
    return out


def _cfg(full: bool):
    cfg = configs.get_config(ARCH)
    return cfg if full else configs.reduced(cfg)


def _eager_scan(dt, x, bc, a, h0):
    """models/ssm.py's eager scan over the whole sequence as one chunk."""
    n = a.shape[1]
    av = torch.exp(dt[..., None] * a)
    bx = (dt * x.float())[..., None] * bc[..., :n].float()[:, :, None, :]
    h_all, h = ssm._chunk_scan(av.transpose(0, 1), bx.transpose(0, 1), h0)
    return torch.einsum("lbcn,bln->blc", h_all, bc[..., n:].float()), h


@pytest.fixture
def stand_in(monkeypatch):
    """The kernel path on the CPU: the rule's device test dropped and the
    kernel replaced by ``_sequential``, which first holds its arguments to
    the wrapper's checks but the device's, and counts its calls."""
    calls = []

    def scan(*args):
        why = sscan.refusal(*args, cuda=False)
        assert why is None, why
        calls.append(args[1].shape)
        return _sequential(*args)

    monkeypatch.setattr(ssm, "_on_kernel", lambda x, cfg: (
        not torch.is_grad_enabled() and x.dtype in sscan.DTYPES
        and cfg.ssm_state in sscan.STATES))
    monkeypatch.setattr(ssm, "selective_scan", scan)
    return calls


def _mesh_layer(cfg, dtype, device, backend, S=40, steps=3):
    """``mamba`` over S tokens then ``steps`` decode steps with autograd
    off, under a one-rank mesh ((1, 1) over ("data", "model"), the weights
    and x DTensors laid out by the sharding rules) and without: (meshed,
    plain) results, each (outputs, last ssm state) as plain tensors."""
    import torch.distributed as dist
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.launch.mesh import _mesh
    from repro_torch.parallel import activation_context, one_rank_group
    from repro_torch.parallel.sharding import (NamedSharding, ParallelismConfig,
                                               PartitionSpec, logical_to_pspec,
                                               shard_tensor)
    p = _weights(cfg, dtype=dtype, device=device)
    specs = tree_paths(ssm.mamba_specs(cfg))
    xt = torch.randn(2, S + steps, cfg.d_model,
                     generator=torch.Generator().manual_seed(4)).to(dtype).to(device)

    def run(p, x):
        out, st = ssm.mamba(p, x[:, :S], cfg, return_state=True)
        outs = [out]
        for t in range(S, S + steps):
            o, st = ssm.mamba_step(p, x[:, t:t + 1], st, cfg)
            outs.append(o)
        full = lambda t: t.full_tensor() if hasattr(t, "full_tensor") else t  # noqa: E731
        return torch.cat([full(o) for o in outs], 1), full(st["ssm"])

    made = not dist.is_initialized()
    one_rank_group(backend)
    try:
        mesh = _mesh(device.type if isinstance(device, torch.device) else device,
                     (1, 1), ("data", "model"))
        dp = {k: shard_tensor(v, NamedSharding(mesh, logical_to_pspec(
            specs[k], mesh, ParallelismConfig()))) for k, v in p.items()}
        dx = shard_tensor(xt, NamedSharding(mesh, PartitionSpec("data", None, None)))
        with torch.no_grad():
            with implicit_replication(), activation_context(mesh):
                meshed = run(dp, dx)
            plain = run(p, xt)
    finally:
        if made:
            dist.destroy_process_group()
    return meshed, plain


# ---------------------------------------------------------------------------
# CPU
# ---------------------------------------------------------------------------

def test_sequential_order_meets_the_reference_bound(stand_in):
    """The kernel's sequential order against the odd-even recursion (S =
    512; the port's ``_chunk_scan``, held to ``lax.associative_scan`` by
    ``tests/test_torch_ssm.py``) and, through the kernel path with the
    stand-in, against the JAX ``mamba`` (S = 510: one chunk there, so
    ``lax.associative_scan`` over the whole sequence; one launch here),
    within ``F32_RTOL``.  One jitted JAX call keeps the test near a
    second."""
    jax = pytest.importorskip("jax")
    from repro import configs as jconfigs
    from repro.models import ssm as jssm
    from repro.models.specs import _unflatten

    dt, x, bc, a, h0 = _scan_inputs(2, 512, 128, 8, torch.float32, h0=True)
    wy, wh = _eager_scan(dt, x, bc, a, h0)
    y, h = _sequential(dt, x, bc, a, h0)
    assert _rel(y, wy) < F32_RTOL and _rel(h, wh) < F32_RTOL

    jcfg = jconfigs.reduced(jconfigs.get_config(ARCH))
    cfg = _cfg(False)
    p = _weights(cfg)
    xt = torch.randn(2, 510, cfg.d_model, generator=torch.Generator().manual_seed(1))
    jout, jst = jax.jit(lambda p, x: jssm.mamba(p, x, jcfg, return_state=True))(
        _unflatten({k: v.numpy() for k, v in p.items()}), xt.numpy())
    with torch.no_grad():
        out, st = ssm.mamba(p, xt, cfg, return_state=True)
    assert stand_in == [(2, 510, cfg.d_inner)]
    assert _rel(out, jout) < F32_RTOL and _rel(st["ssm"], jst["ssm"]) < F32_RTOL
    assert _rel(st["conv"], jst["conv"]) == 0.0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_path_matches_eager_on_the_cpu(stand_in, dtype):
    """The kernel path's Python (one launch over a 96-token prompt, whose
    eager scan is one chunk; the steps' S = 1 launches) against the eager
    path under autograd, with the stand-in in the kernel's place."""
    cfg = _cfg(False)
    p = _weights(cfg, dtype=dtype)
    xt = torch.randn(2, 99, cfg.d_model, generator=torch.Generator().manual_seed(2)).to(dtype)
    rtol = F32_RTOL if dtype == torch.float32 else BF16_RTOL
    with torch.enable_grad():
        want, wst = ssm.mamba(p, xt[:, :96], cfg, return_state=True)
        wsteps = []
        for t in range(96, 99):
            o, wst = ssm.mamba_step(p, xt[:, t:t + 1], wst, cfg)
            wsteps.append(o)
    assert stand_in == []
    with torch.no_grad():
        got, st = ssm.mamba(p, xt[:, :96], cfg, return_state=True)
        steps = []
        for t in range(96, 99):
            o, st = ssm.mamba_step(p, xt[:, t:t + 1], st, cfg)
            steps.append(o)
    assert stand_in == [(2, 96, cfg.d_inner)] + [(2, 1, cfg.d_inner)] * 3
    assert got.dtype == dtype and _rel(got, want) < rtol
    assert _rel(torch.cat(steps, 1), torch.cat(wsteps, 1)) < rtol
    assert st["ssm"].dtype == torch.float32 and _rel(st["ssm"], wst["ssm"]) < F32_RTOL
    assert torch.equal(st["conv"], wst["conv"])


def test_kernel_path_under_a_one_rank_mesh(stand_in):
    """The kernel path's Python under a one-rank gloo mesh, its arguments
    the DTensors' local shards: one call a ``mamba`` and a step, and the
    results of the same path without the mesh."""
    cfg = _cfg(False)
    (got, h), (want, wh) = _mesh_layer(cfg, torch.float32, "cpu", "gloo")
    assert stand_in == [(2, 40, cfg.d_inner)] + [(2, 1, cfg.d_inner)] * 3 \
        + [(2, 40, cfg.d_inner)] + [(2, 1, cfg.d_inner)] * 3
    assert _rel(got, want) < F32_RTOL and _rel(h, wh) < F32_RTOL


def test_kernel_rule():
    """The eager scan on the CPU, on meta tensors and on fake CUDA tensors
    (the card's ``test_launch_counter`` holds the autograd half and the
    kernel's limits)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    cfg = _cfg(False)
    x = torch.zeros(1, 2, 8)
    with torch.no_grad():
        assert not ssm._on_kernel(x, cfg)
        assert not ssm._on_kernel(torch.empty(1, 2, 8, device="meta"), cfg)
        with FakeTensorMode():
            fake = torch.empty(1, 2, 8, device="cuda")
            assert fake.is_cuda and not ssm._on_kernel(fake, cfg)
    assert not ssm._on_kernel(x, cfg)
    assert (ssm.KERNEL_DTYPES, ssm.KERNEL_STATES) == (sscan.DTYPES, sscan.STATES)


@pytest.mark.parametrize("case", ["cpu", "dtype", "shape", "state", "stride"])
def test_wrapper_refuses(case):
    dt, x, bc, a, h0 = _scan_inputs(2, 4, 8, 8, torch.float32, h0=False)
    want = "CUDA device"
    if case == "dtype":
        x, want = x.to(torch.float16), "float32 or bfloat16"
    elif case == "shape":
        dt, want = dt[:, :3], "dt must be"
    elif case == "state":
        dt, x, bc, a, h0 = _scan_inputs(2, 4, 8, 4, torch.float32, h0=False)
        want = "d_state 4"
    elif case == "stride":
        bc, want = bc.transpose(1, 2).contiguous().transpose(1, 2), "unit stride"
    before = sscan.selective_scan.launches
    with pytest.raises(ValueError, match=want):
        sscan.selective_scan(dt, x, bc, a, h0)
    assert sscan.selective_scan.launches == before


# ---------------------------------------------------------------------------
# the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


# (B, d_inner, d_state, x's type): the reduced jamba config, the cell's
# widths, and both d_states with d_inner not a multiple of the kernel's
# 128-channel blocks
WIDTHS = {"reduced": (2, 128, 8, torch.float32), "cell": (8, 8192, 16, torch.bfloat16),
          "ragged-n8": (3, 200, 8, torch.bfloat16), "ragged-n16": (2, 328, 16, torch.float32)}


@pytest.mark.cuda
@pytest.mark.parametrize("h0", [False, True], ids=["h0-zero", "h0-set"])
@pytest.mark.parametrize("S", LENGTHS)
@pytest.mark.parametrize("widths", list(WIDTHS))
def test_kernel_matches_eager_scan(cuda, widths, S, h0):
    """y and the last state within ``F32_RTOL`` of the eager scan on the
    same inputs, at each of ``WIDTHS``."""
    B, di, n, dtype = WIDTHS[widths]
    args = _scan_inputs(B, S, di, n, dtype, h0=h0, seed=S, device=cuda)
    y, h = sscan.selective_scan(*args)
    wy, wh = _eager_scan(*args)
    torch.cuda.synchronize()
    assert y.shape == (B, S, di) and h.shape == (B, di, n)
    assert _rel(y, wy) < F32_RTOL and _rel(h, wh) < F32_RTOL
    assert torch.isfinite(y).all()


def _mamba_pair(cfg, dtype, S, device, seed=0, steps=0):
    """(kernel, eager) results of ``mamba(return_state=True)`` over S tokens
    then ``steps`` decode steps: the same call with autograd off and on."""
    p = _weights(cfg, seed, dtype, device)
    xt = torch.randn(2 if S < 400 else 8, S + steps, cfg.d_model,
                     generator=torch.Generator().manual_seed(seed + 1)).to(dtype).to(device)
    res = []
    for grad in (False, True):
        with torch.set_grad_enabled(grad):
            out, st = ssm.mamba(p, xt[:, :S], cfg, return_state=True)
            outs = [out]
            for t in range(S, S + steps):
                o, st = ssm.mamba_step(p, xt[:, t:t + 1], st, cfg)
                outs.append(o)
        res.append((torch.cat(outs, 1), st))
    return res


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("widths", ["reduced", "cell"])
def test_mamba_on_the_kernel(cuda, widths, dtype):
    """``mamba`` with its state and 8 decode steps after it (S = 258 reduced,
    510 at the cell's widths, B 8, d_model 4096): the kernel path against
    the eager one, one launch a call."""
    cfg = _cfg(widths == "cell")
    S = 510 if widths == "cell" else 258
    before = sscan.selective_scan.launches
    (got, st), (want, wst) = _mamba_pair(cfg, dtype, S, cuda, steps=8)
    assert sscan.selective_scan.launches - before == 1 + 8
    rtol = F32_RTOL if dtype == torch.float32 else BF16_RTOL
    assert got.dtype == dtype and _rel(got, want) < rtol
    assert _rel(st["ssm"], wst["ssm"]) < F32_RTOL
    assert torch.equal(st["conv"], wst["conv"])


@pytest.mark.cuda
def test_steps_continue_the_prefill_on_the_kernel(cuda):
    """float32, reduced: a prefill of 16 then 8 steps equals the full pass
    over 24, on the kernel path alone."""
    cfg = _cfg(False)
    p = _weights(cfg, device=cuda)
    xt = torch.randn(2, 24, cfg.d_model, generator=torch.Generator().manual_seed(3)).to(cuda)
    with torch.no_grad():
        full, fst = ssm.mamba(p, xt, cfg, return_state=True)
        _, st = ssm.mamba(p, xt[:, :16], cfg, return_state=True)
        outs = []
        for t in range(16, 24):
            o, st = ssm.mamba_step(p, xt[:, t:t + 1], st, cfg)
            outs.append(o)
    assert _rel(torch.cat(outs, 1), full[:, 16:]) < F32_RTOL
    assert _rel(st["ssm"], fst["ssm"]) < F32_RTOL


@pytest.mark.cuda
def test_bf16_y_variant_on_the_kernel(cuda, monkeypatch):
    cfg = _cfg(False)
    base = _mamba_pair(cfg, torch.bfloat16, 128, cuda)[0][0]
    monkeypatch.setitem(ssm.PERF_FLAGS, "mamba_bf16_y", True)
    (got, _), (want, _) = _mamba_pair(cfg, torch.bfloat16, 128, cuda)
    assert _rel(got, want) < BF16_RTOL
    assert not torch.equal(got, base)


@pytest.mark.cuda
def test_launch_counter(cuda):
    """One launch a ``mamba`` or ``mamba_step`` call with autograd off, none
    with it on, and none for a type or a d_state the kernel is not built
    for (float16, d_state 4), which run the eager scan."""
    import dataclasses
    base = _cfg(False)
    count = lambda: sscan.selective_scan.launches  # noqa: E731
    for grad, dtype, n, per_call in ((False, torch.float32, base.ssm_state, 1),
                                     (True, torch.float32, base.ssm_state, 0),
                                     (False, torch.float16, base.ssm_state, 0),
                                     (False, torch.float32, 4, 0)):
        cfg = dataclasses.replace(base, ssm_state=n)
        p = _weights(cfg, dtype=dtype, device=cuda)
        xt = torch.randn(2, 70, cfg.d_model, device=cuda).to(dtype)
        before = count()
        with torch.set_grad_enabled(grad):
            out, st = ssm.mamba(p, xt[:, :64], cfg, return_state=True)
            assert count() - before == per_call
            out1, _ = ssm.mamba_step(p, xt[:, 64:65], st, cfg)
            assert count() - before == 2 * per_call
        assert torch.isfinite(out).all() and torch.isfinite(out1).all()


@pytest.mark.cuda
def test_kernel_under_a_one_card_mesh(cuda):
    """``mamba`` and 3 steps with autograd off under a one-card nccl mesh:
    one launch a call on the DTensors' local shards, and the results of
    the same calls without the mesh."""
    cfg = _cfg(False)
    before = sscan.selective_scan.launches
    (got, h), (want, wh) = _mesh_layer(cfg, torch.float32, cuda, "nccl")
    assert sscan.selective_scan.launches - before == 2 * (1 + 3)
    assert _rel(got, want) < F32_RTOL and _rel(h, wh) < F32_RTOL

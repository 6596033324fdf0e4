"""The prefill's causal attention kernel (``kernels/flash_attention.py``).

On the CPU: the kernel's order of the float32 operations (``fa.plain``:
bf16 products with float32 sums, then the scale; an online softmax over
key tiles; each probability as three bf16 terms) against the eager core
``layers._scores_softmax_values`` within ``F32_RTOL``, the bound the dense
tests hold the port to the reference with; the three-term split, exact bit
for bit; the rule, each of whose conditions sends a call to the eager core;
the wrapper's refusals; and the kernel path's Python through ``attention``,
``mla``'s expanded prefill and a served prefill and decode steps, with
``fa.plain`` put in the kernel's place (a stand-in that first holds its
arguments to ``fa.refusal`` but the device), against the eager path: the
core's float32 output within ``F32_RTOL``, the layers' and the logits'
bf16 within ``BF16_RTOL`` (3 %, the dense tests' bf16 bound).

On the card (``cuda`` marker, skipped without a GPU; ``python -m pytest
-q -m cuda tests/test_torch_flash_attention.py``): the kernel against the
eager core at the benchmark cells' shapes (B 8; GQA 32 over 8 heads at
128; MLA's 16 heads at 192 and 128) for S in ``CARD_LENGTHS``, with
positions that pad, repeat and skip; the launch counter (one launch an
attention layer in a prefill: 36 for qwen3-8b, 27 for deepseek-v2-lite,
1 for jamba's period; none in a decode step or under autograd); and the
greedy tokens of a prefill and 8 decode steps at full width, two layers
deep, on the kernel against the eager core.  This file imports no JAX:
the card's machine has none."""

import dataclasses
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from portbench.weights import seeded_params  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.models import Model, layers  # noqa: E402
from repro_torch.models import mla as MLA  # noqa: E402
from repro_torch.models.model import _index  # noqa: E402

F32_RTOL = 1e-5
BF16_RTOL = 3e-2
LENGTHS = [1, 63, 64, 65, 130, 510]
CARD_LENGTHS = [1, 63, 64, 65, 510, 2016, 4032]


def _rel(got, want) -> float:
    got, want = (np.asarray(t.detach().double().cpu(), np.float64) for t in (got, want))
    den = np.linalg.norm(want)
    return float(np.linalg.norm(got - want) / (den if den else 1.0))


def _qkv(B, S, H, KV, dqk, dv=128, seed=0, device="cpu"):
    g = torch.Generator(device=device).manual_seed(seed)
    q, k, v = (torch.randn(shape, generator=g, device=device).to(torch.bfloat16)
               for shape in ((B, S, H, dqk), (B, S, KV, dqk), (B, S, KV, dv)))
    return q, k, v


def _arange(B, S, device="cpu"):
    return torch.arange(S, dtype=torch.int32, device=device)[None].expand(B, S)


def _eager(q, k, v, q_pos, k_pos, scale):
    """The eager core on the kernel's arguments, (B, S, H, Dv) float32, a
    batch row at a time (the scores of a whole (8, 32, 4032, 4032) call
    would not fit the card)."""
    B, S, H, dqk = q.shape
    KV = k.shape[2]
    outs = []
    for b in range(B):
        bias = layers._mask_bias("causal", q_pos[b:b + 1], k_pos[b:b + 1])
        outs.append(layers._scores_softmax_values(
            q[b:b + 1].reshape(1, S, KV, H // KV, dqk), k[b:b + 1], v[b:b + 1], bias,
            0.0, scale).flatten(2, 3))
    return torch.cat(outs)


def _irregular_positions(B, S, device="cpu"):
    """Positions as a served wave and worse: row 0 left-padded (its pads
    all at 0), row 1 counting from 5, row 2 shuffled, row 3 a run of equal
    positions; (B, S) int32 with a batch stride of its own."""
    g = torch.Generator().manual_seed(S)
    rows = [torch.cat([torch.zeros(S // 3, dtype=torch.int32),
                       torch.arange(S - S // 3, dtype=torch.int32)]),
            torch.arange(5, 5 + S, dtype=torch.int32),
            torch.randperm(S, generator=g).to(torch.int32),
            torch.full((S,), 7, dtype=torch.int32)]
    return torch.stack([rows[b % 4] for b in range(B)]).to(device)


# ---------------------------------------------------------------------------
# CPU: the kernel's arithmetic
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("S", LENGTHS)
@pytest.mark.parametrize("G", [4, 1])
@pytest.mark.parametrize("dqk", [128, 192])
def test_plain_order_matches_the_eager_core(dqk, G, S):
    KV = 2
    q, k, v = _qkv(2, S, KV * G, KV, dqk, seed=S)
    pos = _arange(2, S)
    got = fa.plain(q, k, v, pos, pos, dqk ** -0.5)
    assert got.shape == (2, S, KV * G, 128) and got.dtype == torch.float32
    assert _rel(got, _eager(q, k, v, pos, pos, dqk ** -0.5)) < F32_RTOL


@pytest.mark.parametrize("T", [70, 130])
def test_plain_order_with_irregular_positions(T):
    """Pads, an offset, a shuffle, equal positions, and keys a query never
    sees (k_pos beyond every q_pos of a row: zeros, as the eager clamps
    give)."""
    q, k, v = _qkv(4, T, 4, 2, 128, seed=T)
    q_pos = _irregular_positions(4, T)
    k_pos = q_pos.clone()
    k_pos[3] += 1                        # row 3: every key after every query
    got = fa.plain(q, k, v, q_pos, k_pos, 0.1)
    assert _rel(got, _eager(q, k, v, q_pos, k_pos, 0.1)) < F32_RTOL
    assert not got[3].any()


def _split_sums(p: torch.Tensor):
    t = fa.split3(p)
    return sum(x.double() for x in t), t


def test_split_into_three_bf16_terms_is_exact():
    g = torch.Generator().manual_seed(0)
    tiny = torch.finfo(torch.float32).tiny
    one = torch.tensor(1.0)
    ulp8 = 2.0 ** -8                     # half of bf16's ulp at 1: the tie
    edges = torch.tensor([1.0, 0.0, tiny, 2 * tiny, 2.0 ** -110, 1 + ulp8, 1 - ulp8 / 2,
                          1 + ulp8 + 2 ** -23, 1 + ulp8 - 2 ** -23, 1 + 3 * ulp8,
                          0.5 + ulp8 / 2, 1 - 2 ** -24, 1 + 2 ** -23, 2 - 2 ** -23],
                         dtype=torch.float32)
    ties = (one + torch.arange(1, 200) * 2.0 ** -16).float()   # second-term ties
    uniform = torch.rand(100_000, generator=g)
    logu = torch.exp2(-110 * torch.rand(100_000, generator=g))
    for p in (edges, ties, uniform, logu, torch.exp(-40 * torch.rand(100_000, generator=g))):
        total, t = _split_sums(p)
        assert torch.equal(total, p.double()), p[total != p.double()][:5]
        assert all(x.dtype == torch.bfloat16 for x in t)
        # each term the round-to-nearest-even of what is left
        assert torch.equal(t[0], p.to(torch.bfloat16))
        assert torch.equal(t[1], (p - t[0].float()).to(torch.bfloat16))


# ---------------------------------------------------------------------------
# CPU: the rule and the wrapper
# ---------------------------------------------------------------------------

@pytest.fixture
def stand_in(monkeypatch):
    """The kernel path on the CPU: ``layers._real_cuda`` true and the
    kernel replaced by ``fa.plain``, which first holds its arguments to the
    wrapper's checks but the device's; the calls' shapes are recorded."""
    calls = []

    def kernel(q, k, v, q_pos, k_pos, scale):
        why = fa.refusal(q, k, v, q_pos, k_pos, cuda=False)
        assert why is None, why
        calls.append(tuple(q.shape))
        return fa.plain(q, k, v, q_pos, k_pos, scale)

    monkeypatch.setattr(layers, "_real_cuda", lambda t: True)
    monkeypatch.setattr(fa, "flash_attention", kernel)
    return calls


def _attend(q, k, v, pos, **kw):
    args = dict(mode="causal", window=0, prefix_len=0, q_chunk=0, softcap=0.0,
                scale=q.shape[-1] ** -0.5)
    args.update(kw)
    return layers.attend(q, k, v, pos, pos, **args)


REFUSED = ["autograd", "float32", "sliding", "window", "prefix", "bidir", "softcap",
           "bf16_probs", "cross", "width_qk", "width_v", "float16_v"]


@pytest.mark.parametrize("case", REFUSED)
def test_the_rule_sends_each_refused_call_to_the_eager_core(stand_in, monkeypatch, case):
    q, k, v = _qkv(1, 9, 4, 2, 128, seed=1)
    pos = _arange(1, 9)
    kw = {}
    if case == "float32":
        q, k, v = q.float(), k.float(), v.float()
    elif case == "float16_v":
        v = v.to(torch.float16)
    elif case in ("sliding", "prefix", "bidir"):
        kw = {"mode": case, "window": 4 if case == "sliding" else 0,
              "prefix_len": 3 if case == "prefix" else 0}
    elif case == "window":
        kw = {"window": 4}
    elif case == "softcap":
        kw = {"softcap": 30.0}
    elif case == "bf16_probs":
        monkeypatch.setitem(layers.PERF_FLAGS, "softmax_bf16_probs", True)
    elif case == "cross":
        k, v = k[:, :7], v[:, :7]
    elif case == "width_qk":
        q, k = q[..., :64], k[..., :64]
    elif case == "width_v":
        v = v[..., :64]
    with torch.set_grad_enabled(case == "autograd"):
        if case == "cross":
            got = layers.attend(q, k, v, pos, _arange(1, 7), mode="bidir", window=0,
                                prefix_len=0, q_chunk=0, softcap=0.0, scale=0.1)
        else:
            got = _attend(q, k, v, pos, **kw)
    assert stand_in == []
    assert got.dtype == torch.float32 and got.shape == (1, 9, 4, v.shape[-1])
    monkeypatch.setitem(layers.PERF_FLAGS, "softmax_bf16_probs", False)
    with torch.no_grad():
        assert _attend(*_qkv(1, 9, 4, 2, 128, seed=1), pos).shape == (1, 9, 4, 128)
    assert stand_in == [(1, 9, 4, 128)]


def test_the_rule_takes_real_cuda_tensors_alone():
    """The device half of the rule: the CPU, meta tensors and fake CUDA
    tensors are refused; the card's ``test_launch_counter`` holds the rest."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    assert not layers._real_cuda(torch.zeros(2))
    assert not layers._real_cuda(torch.empty(2, device="meta"))
    with FakeTensorMode():
        fake = torch.empty(2, device="cuda")
        assert fake.is_cuda and not layers._real_cuda(fake)
    q, k, v = _qkv(1, 9, 4, 2, 128)
    with torch.no_grad():
        assert not layers._on_flash_kernel(q.unflatten(2, (2, 2)), k, v, "causal", 0, 0.0)


@pytest.mark.parametrize("case", ["cpu", "dtype", "widths", "groups", "shape", "positions",
                                  "stride"])
def test_wrapper_refuses(case):
    q, k, v = _qkv(1, 8, 4, 2, 128)
    pos = _arange(1, 8)
    q_pos, want = pos, "CUDA device"
    if case == "dtype":
        q, want = q.float(), "bfloat16"
    elif case == "widths":
        v, want = v[..., :64], "head widths"
    elif case == "groups":
        q, want = q[:, :, :3], "no multiple"
    elif case == "shape":
        k, want = k[:, :5], "k and v must be"
    elif case == "positions":
        q_pos, want = pos.long(), "q_pos must be int32"
    elif case == "stride":
        q, want = torch.cat([q, q], -1)[..., 1:129], "unit stride within a head"
    before = fa.flash_attention.launches
    with pytest.raises(ValueError, match=want):
        fa.flash_attention(q, k, v, q_pos, pos, 0.1)
    assert fa.flash_attention.launches == before


# ---------------------------------------------------------------------------
# CPU: the kernel path's Python
# ---------------------------------------------------------------------------

def _small(arch):
    cfg = reduced(get_config(arch))
    model = Model(cfg)
    return cfg, model, seeded_params(model, 2 ** 31 + 3, torch.bfloat16, torch.device("cpu"))


def _with_widths(monkeypatch, cfg):
    """The reduced config's head widths added to those the kernel is built
    for (its plain version takes any)."""
    dqk = cfg.qk_nope_dim + cfg.qk_rope_dim if cfg.kv_lora_rank else cfg.d_head
    monkeypatch.setattr(fa, "WIDTHS", fa.WIDTHS + ((dqk, cfg.d_head),))


@pytest.mark.parametrize("arch", ["qwen3-8b", "deepseek-v2-lite"])
def test_kernel_path_through_the_attention_layer(stand_in, monkeypatch, arch):
    """One attention layer (qwen3's ``attention``, deepseek's expanded
    ``mla``) over 70 tokens on the kernel path against the eager one, and
    ``attend`` itself, float32 out, on the layer's q, k and v."""
    cfg, model, params = _small(arch)
    _with_widths(monkeypatch, cfg)
    p = _index(params["layers"], 0)["l0"]
    x = torch.randn(2, 70, cfg.d_model, generator=torch.Generator().manual_seed(5))
    x = x.to(torch.bfloat16)
    pos = _arange(2, 70)

    def layer():
        if cfg.kv_lora_rank:
            return MLA.mla(p["mla"], x, cfg, positions=pos)[0]
        return layers.attention(p["attn"], x, cfg, positions=pos)[0]

    with torch.enable_grad():
        want = layer()
    assert stand_in == []
    with torch.no_grad():
        got = layer()
    assert len(stand_in) == 1 and got.dtype == torch.bfloat16
    assert _rel(got, want) < BF16_RTOL
    dqk = fa.WIDTHS[-1][0]
    q, k, v = _qkv(2, 70, cfg.n_heads, cfg.n_kv_heads, dqk, cfg.d_head, seed=6)
    with torch.no_grad():
        got = _attend(q, k, v, pos)
    with torch.enable_grad():
        want = _attend(q, k, v, pos)
    assert _rel(got, want) < F32_RTOL


@pytest.mark.parametrize("arch", ["qwen3-8b", "deepseek-v2-lite"])
def test_kernel_path_through_a_prefill_and_decode_steps(stand_in, monkeypatch, arch):
    """A prefill of 2 x 40 tokens and 3 greedy decode steps: one call an
    attention layer in the prefill, none in a step; the logits within
    ``BF16_RTOL`` of the eager path's and the same greedy tokens."""
    cfg, model, params = _small(arch)
    _with_widths(monkeypatch, cfg)
    tok = torch.randint(2, cfg.vocab, (2, 40), generator=torch.Generator().manual_seed(7))

    def run():
        logits, cache = model.prefill(params, {"tokens": tok}, 48)
        out = [logits]
        for i in range(3):
            nxt = out[-1].argmax(-1)[:, None].to(torch.int32)
            logits, cache = model.decode_step(params, cache, nxt, 40 + i)
            out.append(logits)
        return out

    with torch.enable_grad():
        want = run()
    assert stand_in == []
    with torch.no_grad():
        got = run()
    assert len(stand_in) == cfg.n_layers
    for g, w in zip(got, want):
        assert _rel(g, w) < BF16_RTOL
        assert torch.equal(g.argmax(-1), w.argmax(-1))


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


# (B, H, KV, Dqk): qwen3's and jamba's GQA, deepseek's expanded MLA
CARD_SHAPES = {"gqa": (8, 32, 8, 128), "mla": (8, 16, 16, 192)}


@pytest.mark.cuda
@pytest.mark.parametrize("S", CARD_LENGTHS)
@pytest.mark.parametrize("shape", list(CARD_SHAPES))
def test_kernel_matches_the_eager_core(cuda, shape, S):
    B, H, KV, dqk = CARD_SHAPES[shape]
    q, k, v = _qkv(B, S, H, KV, dqk, seed=S, device=cuda)
    pos = _arange(B, S, cuda)
    before = fa.flash_attention.launches
    got = fa.flash_attention(q, k, v, pos, pos, dqk ** -0.5)
    torch.cuda.synchronize()
    assert fa.flash_attention.launches == before + 1
    assert got.shape == (B, S, H, 128) and torch.isfinite(got).all()
    assert _rel(got, _eager(q, k, v, pos, pos, dqk ** -0.5)) < F32_RTOL


@pytest.mark.cuda
@pytest.mark.parametrize("T", [70, 130, 1000])
@pytest.mark.parametrize("shape", list(CARD_SHAPES))
def test_kernel_with_irregular_positions(cuda, shape, T):
    _, H, KV, dqk = CARD_SHAPES[shape]
    q, k, v = _qkv(4, T, H, KV, dqk, seed=T, device=cuda)
    q_pos = _irregular_positions(4, T, cuda)
    k_pos = q_pos.clone()
    k_pos[3] += 1
    got = fa.flash_attention(q, k, v, q_pos, k_pos, 0.1)
    assert _rel(got, _eager(q, k, v, q_pos, k_pos, 0.1)) < F32_RTOL
    assert not got[3].any()
    # q, k and v as strided views of wider tensors, as a fused projection gives
    wide = torch.cat([q, q], -1)
    got = fa.flash_attention(wide[..., :dqk], k, v, q_pos, k_pos, 0.1)
    assert _rel(got, _eager(q, k, v, q_pos, k_pos, 0.1)) < F32_RTOL


def _full(arch, layers_kept, device):
    cfg = get_config(arch)
    if layers_kept:
        cfg = dataclasses.replace(cfg, n_layers=layers_kept,
                                  pattern=cfg.pattern[:layers_kept] if len(cfg.pattern)
                                  > layers_kept else cfg.pattern)
    model = Model(cfg)
    return cfg, model, seeded_params(model, 2 ** 31 + 11, torch.bfloat16, device)


@pytest.mark.cuda
def test_launch_counter(cuda):
    """One launch an attention layer in a prefill: 36 for qwen3-8b, 27 for
    deepseek-v2-lite, 1 for jamba's period of 8 layers; none in a decode
    step, and none with autograd on."""
    count = lambda: fa.flash_attention.launches  # noqa: E731
    for arch, kept, want in (("qwen3-8b", 0, 36), ("deepseek-v2-lite", 0, 27),
                             ("jamba-v0.1-52b", 8, 1)):
        cfg, model, params = _full(arch, kept, cuda)
        tok = torch.randint(2, cfg.vocab, (2, 70), device=cuda)
        before = count()
        with torch.no_grad():
            logits, cache = model.prefill(params, {"tokens": tok}, 80)
            assert count() - before == want, arch
            model.decode_step(params, cache, logits.argmax(-1)[:, None].to(torch.int32), 70)
        assert count() - before == want, arch
        if arch == "qwen3-8b":
            with torch.enable_grad():
                model.forward(params, {"tokens": tok})
            assert count() - before == want
        del params, cache, model, logits
        torch.cuda.empty_cache()


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["qwen3-8b", "deepseek-v2-lite"])
def test_greedy_tokens_on_the_kernel(cuda, monkeypatch, arch):
    """Full width, two layers: a prefill of 2 x 300 tokens and 8 greedy
    decode steps on the kernel against the same on the eager core, logits
    within ``BF16_RTOL`` and the same tokens."""
    cfg, model, params = _full(arch, 2, cuda)
    tok = torch.randint(2, cfg.vocab, (2, 300), generator=torch.Generator().manual_seed(8))
    tok = tok.to(cuda)

    def run():
        with torch.no_grad():
            logits, cache = model.prefill(params, {"tokens": tok}, 320)
            out = [logits]
            for i in range(8):
                nxt = out[-1].argmax(-1)[:, None].to(torch.int32)
                logits, cache = model.decode_step(params, cache, nxt, 300 + i)
                out.append(logits)
        return out

    before = fa.flash_attention.launches
    got = run()
    assert fa.flash_attention.launches - before == 2
    monkeypatch.setattr(layers, "_on_flash_kernel", lambda *a: False)
    want = run()
    assert fa.flash_attention.launches - before == 2
    for g, w in zip(got, want):
        assert _rel(g, w) < BF16_RTOL
        assert torch.equal(g.argmax(-1), w.argmax(-1))

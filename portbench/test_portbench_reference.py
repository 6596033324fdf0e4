"""The yardstick against the program at a reduced size on the CPU: the
FLOP arithmetic against ``FlopCounterMode`` and against the counts the
benchmark's configurations have always had, and both plain references
(forward, prefill and decode through the cache, a train step) against
the port in float32."""

import dataclasses

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench import flops
from portbench.drivers.train import readings
from portbench.reference.model import Reference, flatten
from portbench.reference.train import train_steps
from portbench.weights import seeded_params

SEED = 2 ** 31 + 3
B, S = 2, 24            # 64 does not divide S: mamba's single-chunk path


def _published(cfg, model_type: str) -> dict:
    """A reduced ModelConfig as a configuration file's published keys."""
    c = {"name": cfg.name, "model_type": model_type, "hidden_size": cfg.d_model,
         "num_attention_heads": cfg.n_heads, "num_key_value_heads": cfg.n_kv_heads,
         "head_dim": cfg.d_head, "intermediate_size": cfg.d_ff, "vocab_size": cfg.vocab,
         "num_hidden_layers": cfg.n_layers, "rms_norm_eps": cfg.norm_eps}
    if model_type == "qwen3":
        c["rope_theta"] = cfg.rope_theta
    else:
        c.update(attn_layer_period=8, attn_layer_offset=4, expert_layer_period=2,
                 expert_layer_offset=1, num_experts=cfg.n_experts,
                 num_experts_per_tok=cfg.experts_per_token, mamba_d_state=cfg.ssm_state,
                 mamba_d_conv=cfg.ssm_conv, mamba_expand=cfg.ssm_expand,
                 mamba_dt_rank=cfg.d_model // 16, capacity_factor=cfg.capacity_factor)
    return c


def _setup(arch: str, model_type: str):
    from repro_torch.configs import get_config, reduced
    from repro_torch.models import Model
    cfg = reduced(get_config(arch))
    cfg = dataclasses.replace(cfg, dtype="float32", remat="none",
                              d_ff_expert=cfg.d_ff if cfg.n_experts else None)
    model = Model(cfg)
    params = seeded_params(model, SEED, torch.float32, torch.device("cpu"))
    tok = torch.randint(2, cfg.vocab, (B, S + 1), generator=torch.Generator().manual_seed(7))
    return cfg, _published(cfg, model_type), model, params, tok


ARCHS = [("qwen3-8b", "qwen3"), ("jamba-v0.1-52b", "jamba")]


def _program_extra(cfg, train: bool) -> int:
    """FLOPs the program computes beyond the model FLOPs: each MoE layer's
    experts at capacity (E * C rows a batch row, not S * K), mamba's output
    einsum over the states, and, in training, the recomputed ``x_proj`` and
    ``dt_proj`` of each mamba chunk step."""
    if not cfg.n_experts:
        return 0
    d, f, E, K = cfg.d_model, cfg.d_ff, cfg.n_experts, cfg.experts_per_token
    C = int(min(max(1, round(S * K / E * cfg.capacity_factor)), S * K))
    di, n, R = cfg.d_inner, cfg.ssm_state, cfg.d_model // 16
    n_moe = sum(p.ffn == "moe" for p in cfg.pattern) * cfg.n_groups
    n_mamba = sum(p.mixer == "mamba" for p in cfg.pattern) * cfg.n_groups
    capacity = 2 * 3 * d * f * B * (E * C - S * K) * n_moe
    einsum = 2 * B * S * di * n * n_mamba
    if not train:
        return capacity + einsum
    return 3 * (capacity + einsum) + 2 * B * S * (di * (R + 2 * n) + R * di) * n_mamba


@pytest.mark.parametrize("arch,model_type", ARCHS)
def test_flops_match_flop_counter_mode_under_no_remat(arch, model_type):
    from repro_torch.train.optim import tree_leaves, tree_map
    cfg, conf, model, params, tok = _setup(arch, model_type)
    batch = {"tokens": tok[:, :-1], "targets": tok[:, 1:]}
    leaves = tree_map(lambda p: p.detach().requires_grad_(), params)
    with FlopCounterMode(display=False) as fc:
        loss, _ = model.loss(leaves, batch)
        torch.autograd.grad(loss, tree_leaves(leaves), allow_unused=True)
    assert fc.get_total_flops() == \
        flops.train_flops_per_token(conf, S) * B * S + _program_extra(cfg, True)
    with FlopCounterMode(display=False) as fc, torch.no_grad():
        model.prefill(params, {"tokens": batch["tokens"]}, S + 4)
    assert fc.get_total_flops() == flops.prefill_flops(conf, S) * B + _program_extra(cfg, False)


# each configuration's layer kinds, period, prefill FLOPs at prompts of
# 258, 510, 1056 and 2016 tokens and trained-token FLOPs at 512, as the
# harness counted them before the architecture modules took the count over
J = [("mamba", "dense"), ("mamba", "moe"), ("mamba", "dense"), ("mamba", "moe"),
     ("attn", "dense"), ("mamba", "moe"), ("mamba", "dense"), ("mamba", "moe")]
GOLDEN = {
    "qwen3-8b-depth1": ([("attn", "dense")], 1,
                        [101891244032, 202302881792, 427000070144, 845759381504],
                        4916772864),
    "qwen3-8b": ([("attn", "dense")] * 36, 1,
                 [3624521695232, 7239340654592, 15328439435264, 30403774644224],
                 46314553344),
    "jamba-v0.1-52b": (J, 8,
                       [1493885321216, 2954610409472, 6126653407232, 11727559196672],
                       18987614208),
}


@pytest.mark.parametrize("name", sorted(GOLDEN))
def test_each_configuration_keeps_its_layers_and_flop_counts(name):
    from portbench import harness
    kinds, period, prefill, train = GOLDEN[name]
    conf = harness.config(name)
    harness.model_config(conf)
    arch = harness.architecture(conf)
    assert arch.layer_kinds(conf) == kinds and arch.period(conf) == period
    assert [flops.prefill_flops(conf, L) for L in (258, 510, 1056, 2016)] == prefill
    assert flops.train_flops_per_token(conf, 512) == train


@pytest.mark.parametrize("arch,model_type", ARCHS)
def test_the_reference_forward_agrees_with_the_port_in_float32(arch, model_type):
    cfg, conf, model, params, tok = _setup(arch, model_type)
    with torch.no_grad():
        h, _ = model.forward(params, {"tokens": tok})
        want = model.unembed(params, h)
        ref = Reference(conf, params)
        hr, _, _ = ref.hidden(tok)
        got = ref.logits(hr)
    scale = float(want.abs().max())
    assert float((got - want).abs().max()) <= 1e-4 * scale


def test_prefill_and_decode_through_the_cache_agree_with_the_reference_row():
    """jamba: the prompt's capacity as the prefill has it, then three
    decode steps fed the port's own tokens; the port's KV cache is bf16,
    so decode positions hold to 1 %."""
    cfg, conf, model, params, tok = _setup("jamba-v0.1-52b", "jamba")
    prompt = tok[:, :S]
    with torch.no_grad():
        logits, cache = model.prefill(params, {"tokens": prompt}, S + 4)
        outs, fed = [logits], []
        for i in range(3):
            nxt = outs[-1].argmax(-1)
            fed.append(nxt)
            logits, cache = model.decode_step(params, cache, nxt[:, None], S + i)
            outs.append(logits)
        row = torch.cat([prompt, torch.stack(fed, 1)], dim=1)
        ref = Reference(conf, params)
        hr, _, _ = ref.hidden(row, cap_len=S)
        got = ref.logits(hr[:, S - 1:])
    scale = float(got.abs().max())
    assert float((got[:, 0] - outs[0]).abs().max()) <= 1e-4 * scale
    for i in range(1, 4):
        assert float((got[:, i] - outs[i]).abs().max()) <= 1e-2 * scale


def test_the_reference_train_steps_agree_with_the_ports():
    from repro_torch import train as T
    from repro_torch.train.optim import adamw_init, tree_map
    from portbench.reference.train import B1
    cfg, conf, model, params, _ = _setup("qwen3-8b", "qwen3")
    g = torch.Generator().manual_seed(11)
    batches = [torch.randint(2, cfg.vocab, (B, S + 1), generator=g) for _ in range(3)]
    sched = {"peak_lr": 3e-4, "warmup": 1, "total_steps": 100}
    err = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.bfloat16), params)
    state = T.TrainState(params=params, opt=adamw_init(params),
                         step=torch.zeros((), dtype=torch.int32), err=err)
    step = T.make_train_step(model, compress_grads=True, **sched)
    prog = {"loss": []}
    for i, b in enumerate(batches):
        state, m = step(state, {"tokens": b[:, :-1], "targets": b[:, 1:]})
        prog["loss"].append(float(m["loss"]))
        if i == 0:
            prog["grad_norms"] = {k: float(v.norm()) / (1 - B1)
                                  for k, v in flatten(state.opt["m"]).items()}
    p0 = flatten(seeded_params(model, SEED, torch.float32, torch.device("cpu")))
    prog["update_norms"] = {k: float((v - p0[k]).norm())
                            for k, v in flatten(state.params).items()}
    ref = train_steps(conf, seeded_params(model, SEED, torch.float32, torch.device("cpu")),
                      [(b[:, :-1], b[:, 1:]) for b in batches], compress_grads=True, **sched)
    r = readings(prog, ref)
    assert r["loss_gap"] < 1e-5 and r["grad_norm_gap"] < 1e-3 and r["update_norm_gap"] < 1e-3, r


def test_the_step_bound_is_the_one_chip_smoke_reported():
    """``flops.train_step_bound`` is ``chip_smoke.py``'s arithmetic: for the
    depth-1 qwen3-8b trainer at 8 x 128 tokens it gave a 72.0 ms bound, the
    f32 unembedding 57.1, the layer 1.2 and the optimizer's bytes 13.7."""
    import math
    from portbench import harness
    from repro_torch.models import Model
    conf = harness.config("qwen3-8b-depth1")
    model = Model(harness.model_config(conf))
    n = sum(math.prod(p.shape) for p in flatten(model.abstract()).values())
    b = flops.train_step_bound(conf, n, 8 * 128)
    assert [round(b["bound_ms"][k], 1) for k in ("unembed_f32", "layer_bf16",
                                                  "optimizer_bytes")] == [57.1, 1.2, 13.7]
    assert round(b["bound_ms_total"], 1) == 72.0

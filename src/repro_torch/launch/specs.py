"""Per-(arch x shape) step builders for the dry run.

The port of ``repro/launch/specs.py``.  ``input_specs(cfg, shape)`` gives
every model input as a tensor on the meta device (shape and type, no
storage); ``build_cell`` wires the step for one (arch, shape, mesh) cell:
the port's ``make_train_step``, ``Model.prefill`` or ``Model.decode_step``,
its arguments on the meta device, and the in/out NamedShardings of
:mod:`repro_torch.parallel.sharding`, ready for
:mod:`repro_torch.launch.dryrun` to lay them out as DTensors.

Shape semantics (as the reference's):
  train_4k     train_step  (tokens+targets, global_batch x seq)
  prefill_32k  prefill     (prompt batch -> logits + built cache)
  decode_32k   decode_step (1 new token against a seq_len KV cache)
  long_500k    decode_step (ssm/hybrid archs only: sub-quadratic state)

Modality stubs: the encoder-decoder takes precomputed frame embeddings
(B, S, d); the VLM precomputed patch embeddings (B, n_img_tokens, d), its
``seq_len`` counting patches and text.  ``decode_step`` takes ``pos`` as a
Python int (the port's signature): the cell's is the cache's last slot.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from ..configs import ShapeSpec
from ..models import Model, ModelConfig
from ..models.specs import tree_paths
from ..parallel.sharding import (NamedSharding, P, ParallelismConfig,
                                 batch_shardings, cache_shardings, dp_spec,
                                 mesh_shape, opt_shardings, param_shardings)
from ..train.step import TrainState, abstract_train_state, make_train_step

__all__ = ["input_specs", "build_cell", "parallelism_for", "total_params",
           "active_params", "default_accum", "Cell", "SEAMLESS_DEC_PROMPT",
           "SEAMLESS_CROSS_LEN"]

SEAMLESS_DEC_PROMPT = 256     # decoder prompt length for enc-dec prefill
SEAMLESS_CROSS_LEN = 4096     # encoder context length for enc-dec decode


def _meta(shape, dtype):
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def _numel(shape) -> int:
    n = 1
    for d in shape:
        n *= d
    return n


def total_params(cfg: ModelConfig) -> int:
    return sum(_numel(s.shape) for s in tree_paths(Model(cfg).param_specs()).values())


def active_params(cfg: ModelConfig) -> int:
    """Per-token active params: expert tensors count K/E of their size."""
    n = 0
    for spec in tree_paths(Model(cfg).param_specs()).values():
        k = _numel(spec.shape)
        if "experts" in spec.axes:
            k = k * cfg.experts_per_token // max(cfg.n_experts, 1)
        n += k
    return n


def parallelism_for(cfg: ModelConfig, compressed_dp: bool = False) -> ParallelismConfig:
    # FSDP always on at 256+ ranks: replicated float32 masters never fit
    return ParallelismConfig(zero3=True, zero1_moments=True,
                             shard_kv_cache_time=True, experts_fsdp=True,
                             compressed_dp=compressed_dp)


def input_specs(cfg: ModelConfig, shape: ShapeSpec) -> dict:
    """The batch of a train or prefill cell (decode: one new token)."""
    B, S = shape.global_batch, shape.seq_len
    it = torch.int32
    if shape.kind == "train":
        if cfg.is_encdec:
            return {"frames": _meta((B, S, cfg.d_model), torch.float32),
                    "tokens": _meta((B, S), it), "targets": _meta((B, S), it)}
        if cfg.n_img_tokens:
            st = S - cfg.n_img_tokens
            return {"patches": _meta((B, cfg.n_img_tokens, cfg.d_model), torch.float32),
                    "tokens": _meta((B, st), it), "targets": _meta((B, st), it)}
        return {"tokens": _meta((B, S), it), "targets": _meta((B, S), it)}
    if shape.kind == "prefill":
        if cfg.is_encdec:
            return {"frames": _meta((B, S, cfg.d_model), torch.float32),
                    "tokens": _meta((B, SEAMLESS_DEC_PROMPT), it)}
        if cfg.n_img_tokens:
            return {"patches": _meta((B, cfg.n_img_tokens, cfg.d_model), torch.float32),
                    "tokens": _meta((B, S - cfg.n_img_tokens), it)}
        return {"tokens": _meta((B, S), it)}
    return {"tokens": _meta((B, 1), it)}


@dataclasses.dataclass
class Cell:
    fn: Any
    args: tuple
    in_shardings: Any
    out_shardings: Any
    donate_argnums: tuple = ()
    static_argnums: tuple = ()


def default_accum(cfg: ModelConfig, shape: ShapeSpec, mesh) -> int:
    """Microbatch count so the per-device residual carry (the group-stack
    activation saves, B_loc*S*d*2B*n_groups) stays under ~6 GiB."""
    dp = 1
    for a, size in mesh_shape(mesh).items():
        if a != "model":
            dp *= size
    b_loc = max(shape.global_batch // dp, 1)
    resid = b_loc * shape.seq_len * cfg.d_model * 2 * cfg.n_groups
    for accum in (1, 2, 4, 8):
        if resid / accum <= 6 * 2**30 and (shape.global_batch // dp) % accum == 0:
            return accum
    return 8


def build_cell(cfg: ModelConfig, shape: ShapeSpec, mesh,
               pcfg: ParallelismConfig | None = None,
               train_kwargs: dict | None = None) -> Cell:
    # flash-style query chunking for any long-context full pass
    if shape.kind in ("train", "prefill") and shape.seq_len >= 2048 and not cfg.q_chunk:
        cfg = dataclasses.replace(cfg, q_chunk=256 if shape.kind == "train" else 512)
    model = Model(cfg)
    pcfg = pcfg or parallelism_for(cfg)
    batch = input_specs(cfg, shape)
    rep = NamedSharding(mesh, P())

    if shape.kind == "train":
        big = total_params(cfg) >= 200e9
        kwargs = dict(bf16_moments=big, accum=default_accum(cfg, shape, mesh))
        kwargs.update(train_kwargs or {})
        accum = kwargs["accum"]
        if accum > 1:   # batch leaves become (accum, micro, ...)
            batch = {k: _meta((accum, v.shape[0] // accum) + tuple(v.shape[1:]), v.dtype)
                     for k, v in batch.items()}
        step = make_train_step(model, **kwargs)
        state = abstract_train_state(model, bf16_moments=kwargs["bf16_moments"],
                                     compress_grads=kwargs.get("compress_grads", False))
        psh = param_shardings(model, mesh, pcfg)
        osh = opt_shardings(model, mesh, pcfg)
        state_sh = TrainState(params=psh, opt={"m": osh, "v": osh, "count": rep},
                              step=rep, err=psh if state.err is not None else None)
        if accum > 1:
            bsh = {k: NamedSharding(mesh, P(None, dp_spec(mesh, v.shape[1]),
                                             *([None] * (v.dim() - 2))))
                   for k, v in batch.items()}
        else:
            bsh = batch_shardings(mesh, batch)
        return Cell(fn=step, args=(state, batch), in_shardings=(state_sh, bsh),
                    out_shardings=(state_sh, rep), donate_argnums=(0,))

    params = model.abstract(dtype=torch.bfloat16)
    psh = param_shardings(model, mesh, pcfg)
    dp = dp_spec(mesh, shape.global_batch)
    logits_sh = NamedSharding(mesh, P(dp, None))

    if shape.kind == "prefill":
        S_ctx = shape.seq_len if not cfg.is_encdec else SEAMLESS_DEC_PROMPT
        cache = model.init_cache(shape.global_batch, S_ctx,
                                 enc_len=shape.seq_len if cfg.is_encdec else 0,
                                 device="meta")
        return Cell(fn=lambda p, b: model.prefill(p, b, max_len=S_ctx),
                    args=(params, batch),
                    in_shardings=(psh, batch_shardings(mesh, batch)),
                    out_shardings=(logits_sh, cache_shardings(model, mesh, pcfg, cache)))

    cache = model.init_cache(shape.global_batch, shape.seq_len,
                             enc_len=SEAMLESS_CROSS_LEN if cfg.is_encdec else 0,
                             device="meta")
    csh = cache_shardings(model, mesh, pcfg, cache)
    return Cell(fn=model.decode_step,
                args=(params, cache, batch["tokens"], shape.seq_len - 1),
                in_shardings=(psh, csh, NamedSharding(mesh, P(dp, None)), None),
                out_shardings=(logits_sh, csh), donate_argnums=(1,))

"""The unified Model, ported: every architecture of the registry.

The port of ``repro/models/model.py``.  The config's ``pattern`` of
``(mixer, ffn)`` pairs is unrolled inside one group; the groups run in a
loop over the leading ``layers`` dim of the group-stacked parameters (the
reference scans them).  Parameters are the reference's nested dict, with
its dotted paths and layouts, passed to every entry point as in the
reference, so a checkpoint of either package loads into either model by
name.  The mixers are ``attn``, ``local``, ``mamba`` and ``rwkv``; the
FFNs ``dense``, ``moe`` and RWKV's channel mix; cross attention and the
encoder (a loop over its groups, the reference scans them) serve the
encoder-decoder stack, whose ``frames`` (B, T, d) stand in for the
modality frontend.  ``forward`` sums the MoE layers' aux losses over the
groups.

Entry points:
  forward(params, batch)                -> (hidden (B,S,d), aux)
  loss(params, batch)                   -> (scalar, metrics)     [train]
  prefill(params, batch, max_len)       -> (last logits, cache)  [serve]
  decode_step(params, cache, token, pos)-> (logits, cache)       [serve]

``decode_step`` takes ``pos`` as a Python int (the mask is built without
a host sync).  It writes the step's keys and values into the KV cache in
place, at slot ``pos``; the recurrent states it returns (RWKV's, Mamba's)
are new tensors, one stack a leaf, and the static cross cache is the one
given.

``cfg.remat`` is honoured where the reference honours it: ``forward``'s
groups, ``encode``'s layers and (whenever it is not ``"none"``) each loss
chunk are recomputed in the backward (:meth:`Model._maybe_remat`); the
attention's query chunks and mamba's chunk steps always are
(``layers.recompute``).  ``prefill`` and ``decode_step`` record no
gradient, so nothing is recomputed there.

Each attention, Mamba and MoE layer runs inside a ``model.attention``,
``model.mamba`` or ``model.moe`` span (:mod:`repro_torch.obs.trace`),
projections included; a recomputed group opens its spans again, on the
thread that runs the backward.
"""

from __future__ import annotations

import functools

import torch
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy,
                                    create_selective_checkpoint_contexts)

from . import layers as L
from . import moe as M
from . import rwkv as R
from . import ssm as SSM
from .config import ModelConfig
from .specs import ParamSpec, abstract_params, init_params
from .. import obs
from ..checkpoint.manager import _resolve_device
from ..parallel.actctx import constrain, gather_weights
from ..parallel.meshed import embed_lookup, xent_parts

__all__ = ["Model"]

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
           "float16": torch.float16}


def _stack_specs(tree, n: int):
    """Prefix every ParamSpec leaf with a (n,) 'layers' group dim."""
    if isinstance(tree, ParamSpec):
        return ParamSpec((n,) + tuple(tree.shape), ("layers",) + tuple(tree.axes),
                         init=tree.init, scale=tree.scale, dtype=tree.dtype)
    return {k: _stack_specs(v, n) for k, v in tree.items()}


def _index(tree, g: int):
    """Group ``g`` of a group-stacked tree (views)."""
    if isinstance(tree, dict):
        return {k: _index(v, g) for k, v in tree.items()}
    return tree[g]


def _stack(trees: list):
    """Group trees -> one tree with a leading group dim."""
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


def _restack(old, views: list, news: list):
    """The groups' new caches -> one stacked cache.  A leaf every group
    wrote in place (the KV cache: its new leaf is its view of ``old``)
    keeps ``old``; the others (the recurrent states) are stacked."""
    if isinstance(old, dict):
        return {k: _restack(old[k], [v[k] for v in views], [n[k] for n in news])
                for k in old}
    if all(n is v for n, v in zip(news, views)):
        return old
    return torch.stack(news)


# products with no batch dimension: the projections' ``torch.matmul`` of a
# (B, S, d) activation by a (d, f) weight folds to one ``mm``; every
# einsum the model runs inside a group has batch dims (its ``bmm``)
_NO_BATCH_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    """JAX's ``checkpoint_dots_with_no_batch_dims``: keep the outputs of
    products with no batch dimensions, recompute everything else."""
    if op in _NO_BATCH_DOTS:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _zero_aux(device):
    return {"lb_loss": torch.zeros((), dtype=torch.float32, device=device),
            "z_loss": torch.zeros((), dtype=torch.float32, device=device)}


class Model(nn.Module):
    """One architecture of ``ModelConfig``.  Holds no tensors: the
    parameters are a nested dict passed in, as in the reference."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.cfg = cfg

    # ------------------------------------------------------------------
    # specs / init
    # ------------------------------------------------------------------

    def _layer_specs(self, pe) -> dict:
        cfg = self.cfg
        sp: dict = {"ln1": L.norm_specs(cfg.d_model)}
        if pe.mixer in ("attn", "local"):
            sp["attn"] = L.attn_specs(cfg)
            if cfg.post_norm:
                sp["post_ln1"] = L.norm_specs(cfg.d_model)
        elif pe.mixer == "mamba":
            sp["mamba"] = SSM.mamba_specs(cfg)
        elif pe.mixer == "rwkv":
            sp["tm"] = R.rwkv_time_specs(cfg)
        else:
            raise ValueError(pe.mixer)
        if cfg.cross_attn:
            sp["ln_x"] = L.norm_specs(cfg.d_model)
            sp["xattn"] = L.attn_specs(cfg, cross=True)
        if pe.ffn != "none":
            sp["ln2"] = L.norm_specs(cfg.d_model)
            if pe.ffn == "dense":
                sp["ffn"] = L.ffn_specs(cfg.d_model, cfg.d_ff)
            elif pe.ffn == "moe":
                sp["moe"] = M.moe_specs(cfg)
            elif pe.ffn == "rwkv_cm":
                sp["cm"] = R.rwkv_channel_specs(cfg)
            else:
                raise ValueError(pe.ffn)
            if cfg.post_norm and pe.ffn in ("dense", "moe"):
                sp["post_ln2"] = L.norm_specs(cfg.d_model)
        return sp

    def param_specs(self) -> dict:
        cfg = self.cfg
        group = {f"l{j}": self._layer_specs(pe) for j, pe in enumerate(cfg.pattern)}
        sp = {
            "embed": ParamSpec((cfg.vocab, cfg.d_model), ("vocab", "embed"), scale=1.0),
            "layers": _stack_specs(group, cfg.n_groups),
            "final_norm": L.norm_specs(cfg.d_model),
        }
        if not cfg.tie_embeddings:
            sp["lm_head"] = ParamSpec((cfg.d_model, cfg.vocab), ("embed", "vocab"))
        if cfg.is_encdec:
            sp["encoder"] = {
                "layers": _stack_specs({"l0": self._enc_layer_specs()},
                                       cfg.n_enc_layers),
                "final_norm": L.norm_specs(cfg.d_model),
            }
        return sp

    def _enc_layer_specs(self) -> dict:
        cfg = self.cfg
        return {
            "ln1": L.norm_specs(cfg.d_model),
            "attn": L.attn_specs(cfg),
            "ln2": L.norm_specs(cfg.d_model),
            "ffn": L.ffn_specs(cfg.d_model, cfg.d_ff),
        }

    def init(self, generator: torch.Generator, dtype=torch.float32):
        """Parameters drawn from ``generator``, on its device."""
        return init_params(self.param_specs(), generator, param_dtype=dtype)

    def abstract(self, dtype=torch.float32):
        """The parameter tree as tensors on the meta device: shapes and
        types, no storage (the reference's ShapeDtypeStruct tree)."""
        return abstract_params(self.param_specs(), param_dtype=dtype)

    # ------------------------------------------------------------------
    # embedding / head
    # ------------------------------------------------------------------

    def embed(self, params, tokens):
        cfg = self.cfg
        x = embed_lookup(gather_weights(params["embed"]), tokens).to(_DTYPES[cfg.dtype])
        if cfg.embed_scale:
            x = x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype)
        return constrain(x, ("dp", None, None))

    def unembed(self, params, h):
        cfg = self.cfg
        w = gather_weights(params["lm_head"] if not cfg.tie_embeddings
                           else params["embed"].T)
        # h's type for the operands, float32 products and sums (exact
        # products for bf16, as the reference's preferred_element_type=f32)
        logits = torch.matmul(h.float(), w.to(h.dtype).float())
        if cfg.final_softcap:
            logits = cfg.final_softcap * torch.tanh(logits / cfg.final_softcap)
        return logits

    # ------------------------------------------------------------------
    # one group of layers (forward / prefill / decode share this)
    # ------------------------------------------------------------------

    def _apply_group(self, gp, x, *, positions, prefix_len, enc_out=None,
                     cache_g=None, cache_pos=None, build_cache=0):
        """Unrolled pattern application.  Returns (x, aux, new_cache_g); aux
        is the group's summed MoE aux losses, None where it has no MoE."""
        cfg = self.cfg
        gp = gather_weights(gp)           # under a mesh: ZeRO-3's gather
        aux = None
        decoding = cache_g is not None
        new_cache = {}
        x = constrain(x, ("dp", None, None))
        for j, pe in enumerate(cfg.pattern):
            sub = gp[f"l{j}"]
            key = f"l{j}"
            lcache = (cache_g or {}).get(key, {})
            nc: dict = {}
            # ---- mixer
            h = L.rms_norm(sub["ln1"], x, cfg.norm_eps)
            if pe.mixer in ("attn", "local"):
                mode = "sliding" if pe.mixer == "local" else (
                    "prefix" if (cfg.n_img_tokens and not decoding) else "causal")
                with obs.trace.span("model.attention", cat="model"):
                    attn_out, kv = L.attention(
                        sub["attn"], h, cfg, mode=mode, positions=positions,
                        cache=lcache.get("self"), cache_pos=cache_pos,
                        build_cache=build_cache,
                        window=cfg.local_window, prefix_len=prefix_len,
                        q_chunk=cfg.q_chunk)
                if kv is not None:
                    nc["self"] = kv
                if cfg.post_norm:
                    attn_out = L.rms_norm(sub["post_ln1"], attn_out, cfg.norm_eps)
                x = x + attn_out
            elif pe.mixer == "mamba":
                with obs.trace.span("model.mamba", cat="model"):
                    if decoding:
                        mx, nc["ssm_state"] = SSM.mamba_step(
                            sub["mamba"], h, lcache["ssm_state"], cfg)
                    elif build_cache:
                        mx, nc["ssm_state"] = SSM.mamba(sub["mamba"], h, cfg,
                                                        return_state=True)
                    else:
                        mx = SSM.mamba(sub["mamba"], h, cfg)
                x = x + mx
            else:                                       # rwkv
                tmx, (last_x, s_fin) = R.rwkv_time_mix(
                    sub["tm"], h, cfg,
                    shift_carry=lcache.get("tm_shift") if decoding else None,
                    state0=lcache.get("tm_state") if decoding else None)
                if decoding or build_cache:
                    nc["tm_shift"] = last_x
                    nc["tm_state"] = s_fin
                x = x + tmx
            # ---- cross attention (enc-dec decoder)
            if cfg.cross_attn:
                hx = L.rms_norm(sub["ln_x"], x, cfg.norm_eps)
                if decoding:
                    xout, _ = L.attention(sub["xattn"], hx, cfg, mode="bidir",
                                          cache=lcache["cross"], update_cache=False)
                    nc["cross"] = lcache["cross"]
                else:
                    xout, _ = L.attention(sub["xattn"], hx, cfg, mode="bidir",
                                          kv_input=enc_out)
                    if build_cache:
                        # cross kv cache: the encoder's projections, once
                        nc["cross"] = {
                            "k": L._project(enc_out, sub["xattn"]["wk"]).to(torch.bfloat16),
                            "v": L._project(enc_out, sub["xattn"]["wv"]).to(torch.bfloat16)}
                x = x + xout
            # ---- ffn
            if pe.ffn != "none":
                h2 = L.rms_norm(sub["ln2"], x, cfg.norm_eps)
                if pe.ffn == "dense":
                    f = L.ffn(sub["ffn"], h2, cfg.ffn_act)
                elif pe.ffn == "moe":
                    with obs.trace.span("model.moe", cat="model"):
                        f, moe_aux = M.moe_ffn(sub["moe"], h2, cfg)
                    aux = moe_aux if aux is None else \
                        {k: aux[k] + moe_aux[k] for k in aux}
                else:                                   # rwkv channel mix
                    f, cm_last = R.rwkv_channel_mix(
                        sub["cm"], h2, cfg,
                        shift_carry=lcache.get("cm_shift") if decoding else None)
                    if decoding or build_cache:
                        nc["cm_shift"] = cm_last
                if cfg.post_norm and pe.ffn in ("dense", "moe"):
                    f = L.rms_norm(sub["post_ln2"], f, cfg.norm_eps)
                x = x + f
            x = constrain(x, ("dp", None, None))
            new_cache[key] = nc
        return x, aux, new_cache

    # ------------------------------------------------------------------
    # rematerialization (the reference's _maybe_remat)
    # ------------------------------------------------------------------

    def _maybe_remat(self, fn):
        """``fn`` as ``cfg.remat`` wants it: ``"none"`` keeps every
        activation, ``"full"`` recomputes the whole of ``fn`` in the
        backward, ``"dots"`` keeps only the outputs of products with no
        batch dimensions and recomputes the rest."""
        r = self.cfg.remat
        if r == "none":
            return fn
        ctx = functools.partial(create_selective_checkpoint_contexts,
                                _dots_policy) if r == "dots" else None
        return functools.partial(L.recompute, fn, context_fn=ctx)

    # ------------------------------------------------------------------
    # encoder (enc-dec archs)
    # ------------------------------------------------------------------

    def encode(self, params, frames):
        """frames: (B, T, d) precomputed modality embeddings (stub frontend)."""
        cfg = self.cfg
        x = frames.to(_DTYPES[cfg.dtype])
        enc = params["encoder"]

        def layer_fn(gp, x):
            sub = gather_weights(gp["l0"])
            h = L.rms_norm(sub["ln1"], x, cfg.norm_eps)
            a, _ = L.attention(sub["attn"], h, cfg, mode="bidir")
            x = x + a
            h2 = L.rms_norm(sub["ln2"], x, cfg.norm_eps)
            return x + L.ffn(sub["ffn"], h2, cfg.ffn_act)

        layer_fn = self._maybe_remat(layer_fn)
        for g in range(cfg.n_enc_layers):
            x = layer_fn(_index(enc["layers"], g), x)
        return L.rms_norm(enc["final_norm"], x, cfg.norm_eps)

    def _inputs_to_x(self, params, batch):
        """tokens (+ image patches, + frames) -> (x, positions, prefix_len,
        enc_out)."""
        cfg = self.cfg
        x = self.embed(params, batch["tokens"])
        prefix_len = 0
        enc_out = None
        if cfg.n_img_tokens and "patches" in batch:
            patches = batch["patches"].to(x.dtype)          # (B, P, d) stub
            x = torch.cat([patches, x], dim=1)
            prefix_len = patches.shape[1]
        if cfg.is_encdec:
            enc_out = self.encode(params, batch["frames"])
        B, S2 = x.shape[0], x.shape[1]
        positions = torch.arange(S2, dtype=torch.int32,
                                 device=x.device)[None].expand(B, S2)
        return x, positions, prefix_len, enc_out

    def forward(self, params, batch):
        x, positions, prefix_len, enc_out = self._inputs_to_x(params, batch)
        aux = _zero_aux(x.device)

        def group_fn(gp, x):
            x, gaux, _ = self._apply_group(gp, x, positions=positions,
                                           prefix_len=prefix_len, enc_out=enc_out)
            return x, gaux

        group_fn = self._maybe_remat(group_fn)
        for g in range(self.cfg.n_groups):
            x, gaux = group_fn(_index(params["layers"], g), x)
            if gaux is not None:
                aux = {k: aux[k] + gaux[k] for k in aux}
        x = L.rms_norm(params["final_norm"], x, self.cfg.norm_eps)
        return constrain(x, ("dp", None, None)), aux

    # ------------------------------------------------------------------
    # loss (chunked cross-entropy: no (B, S, V) float32 logits at once)
    # ------------------------------------------------------------------

    def loss(self, params, batch, s_chunk: int = 512):
        cfg = self.cfg
        h, aux = self.forward(params, batch)
        targets = batch["targets"]
        mask = batch.get("loss_mask")
        if cfg.n_img_tokens and "patches" in batch:
            h = h[:, batch["patches"].shape[1]:]             # loss on text only
        B, Sl, _ = h.shape
        if mask is None:
            mask = torch.ones((B, Sl), dtype=torch.float32, device=h.device)
        c = min(s_chunk, Sl)
        if Sl % c:
            c = Sl

        def chunk_fn(hc, tc, mc):
            logits = self.unembed(params, hc)                 # (B, c, V) float32
            lse, tgt, hit = xent_parts(logits, tc)
            return ((lse - tgt) * mc).sum(), mc.sum(), (hit * mc).sum()

        if cfg.remat != "none":
            chunk_fn = functools.partial(L.recompute, chunk_fn)
        nll, cnt, corr = [], [], []
        for lo in range(0, Sl, c):
            n, k, r = chunk_fn(h[:, lo:lo + c], targets[:, lo:lo + c],
                               mask[:, lo:lo + c])
            nll.append(n)
            cnt.append(k)
            corr.append(r)
        total = torch.clamp_min(torch.stack(cnt).sum(), 1.0)
        xent = torch.stack(nll).sum() / total
        loss = xent + cfg.router_aux_weight * aux["lb_loss"] \
            + cfg.router_z_weight * aux["z_loss"]
        metrics = {"loss": loss, "xent": xent,
                   "accuracy": torch.stack(corr).sum() / total,
                   "lb_loss": aux["lb_loss"], "z_loss": aux["z_loss"],
                   "tokens": total}
        return loss, metrics

    # ------------------------------------------------------------------
    # serving: cache init / prefill / decode
    # ------------------------------------------------------------------

    def init_cache(self, batch_size: int, max_len: int, enc_len: int = 0,
                   cache_dtype=torch.bfloat16, device=None):
        """The decode state, stacked over the groups: a KV cache of
        ``(n_groups, B, max_len, KV, Dh)`` for each attention layer, the
        recurrent state of each RWKV and Mamba layer, and a cross cache of
        ``enc_len`` slots where the decoder cross-attends, on ``device``
        (default: the GPU; raises when there is none)."""
        cfg = self.cfg
        device = _resolve_device(device)

        def zeros(shape):
            return torch.zeros(shape, dtype=cache_dtype, device=device)

        g = {}
        for j, pe in enumerate(cfg.pattern):
            e: dict = {}
            if pe.mixer in ("attn", "local"):
                shape = (batch_size, max_len, cfg.n_kv_heads, cfg.d_head)
                e["self"] = {"k": zeros(shape), "v": zeros(shape)}
            elif pe.mixer == "mamba":
                e["ssm_state"] = SSM.init_mamba_state(cfg, batch_size, device=device)
            elif pe.mixer == "rwkv":
                st = R.init_rwkv_state(cfg, batch_size, device=device)
                e["tm_shift"], e["tm_state"] = st["tm_shift"], st["tm_state"]
            if cfg.cross_attn:
                xs = (batch_size, enc_len, cfg.n_kv_heads, cfg.d_head)
                e["cross"] = {"k": zeros(xs), "v": zeros(xs)}
            if pe.ffn == "rwkv_cm":
                e["cm_shift"] = zeros((batch_size, cfg.d_model))
            g[f"l{j}"] = e
        return _stack([g] * cfg.n_groups)

    def prefill(self, params, batch, max_len: int):
        """Run the prompt, build the cache (a bf16 KV cache, as in the
        reference).  Returns (last-pos logits, cache)."""
        x, positions, prefix_len, enc_out = self._inputs_to_x(params, batch)
        caches = []
        for g in range(self.cfg.n_groups):
            x, _, nc = self._apply_group(_index(params["layers"], g), x,
                                         positions=positions, prefix_len=prefix_len,
                                         enc_out=enc_out, build_cache=max_len)
            caches.append(nc)
        x = L.rms_norm(params["final_norm"], x, self.cfg.norm_eps)
        return self.unembed(params, x[:, -1]), _stack(caches)

    def decode_step(self, params, cache, token, pos: int):
        """token: (B, 1) int; pos: the next position index, a Python int.
        Returns (logits (B, V), new cache); the KV and cross leaves are
        ``cache``'s."""
        cfg = self.cfg
        x = self.embed(params, token)
        positions = None                    # rope's; a recurrence needs none
        if any(pe.mixer in ("attn", "local") for pe in cfg.pattern):
            positions = torch.full((x.shape[0], 1), pos, dtype=torch.int32,
                                   device=x.device)
        views, caches = [], []
        for g in range(cfg.n_groups):
            views.append(_index(cache, g))
            x, _, nc = self._apply_group(_index(params["layers"], g), x,
                                         positions=positions, prefix_len=0,
                                         cache_g=views[-1], cache_pos=pos)
            caches.append(nc)
        x = L.rms_norm(params["final_norm"], x, cfg.norm_eps)
        return self.unembed(params, x[:, -1]), _restack(cache, views, caches)

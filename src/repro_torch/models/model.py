"""The unified Model, ported: the dense attention stacks and RWKV-6.

The port of ``repro/models/model.py``.  The config's ``pattern`` of
``(mixer, ffn)`` pairs is unrolled inside one group; the groups run in a
loop over the leading ``layers`` dim of the group-stacked parameters (the
reference scans them).  Parameters are the reference's nested dict, with
its dotted paths and layouts, passed to every entry point as in the
reference, so a checkpoint of either package loads into either model by
name.  Ported: the ``attn`` and ``local`` mixers with the ``dense`` FFN
(qwen3, qwen2.5, stablelm, gemma2 with its post-norms, paligemma with its
image prefix) and RWKV-6.  The ``moe`` FFN, the ``mamba`` mixer, cross
attention and the encoder-decoder path raise ``NotImplementedError``
(ROADMAP A2).

Entry points:
  forward(params, batch)                -> (hidden (B,S,d), aux)
  loss(params, batch)                   -> (scalar, metrics)     [train]
  prefill(params, batch, max_len)       -> (last logits, cache)  [serve]
  decode_step(params, cache, token, pos)-> (logits, cache)       [serve]

``decode_step`` takes ``pos`` as a Python int (the mask is built without
a host sync).  It writes the step's keys and values into the KV cache in
place, at slot ``pos``; the recurrent states it returns are new tensors,
one stack a leaf, as in the RWKV-only port.
"""

from __future__ import annotations

import torch
from torch import nn

from . import layers as L
from . import rwkv as R
from .config import ModelConfig
from .specs import ParamSpec, init_params, tree_paths, _unflatten
from ..checkpoint.manager import _resolve_device
from ..parallel.actctx import constrain

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
        elif pe.mixer == "rwkv":
            sp["tm"] = R.rwkv_time_specs(cfg)
        else:
            raise L.not_ported(f"the {pe.mixer!r} mixer", "A2")
        if cfg.cross_attn:
            raise L.not_ported("cross attention", "A2")
        if pe.ffn != "none":
            sp["ln2"] = L.norm_specs(cfg.d_model)
            if pe.ffn == "dense":
                sp["ffn"] = L.ffn_specs(cfg.d_model, cfg.d_ff)
            elif pe.ffn == "rwkv_cm":
                sp["cm"] = R.rwkv_channel_specs(cfg)
            else:
                raise L.not_ported(f"the {pe.ffn!r} FFN", "A2")
            if cfg.post_norm and pe.ffn == "dense":
                sp["post_ln2"] = L.norm_specs(cfg.d_model)
        return sp

    def param_specs(self) -> dict:
        cfg = self.cfg
        if cfg.is_encdec:
            raise L.not_ported("the encoder-decoder path", "A2")
        group = {f"l{j}": self._layer_specs(pe) for j, pe in enumerate(cfg.pattern)}
        sp = {
            "embed": ParamSpec((cfg.vocab, cfg.d_model), ("vocab", "embed"), scale=1.0),
            "layers": _stack_specs(group, cfg.n_groups),
            "final_norm": L.norm_specs(cfg.d_model),
        }
        if not cfg.tie_embeddings:
            sp["lm_head"] = ParamSpec((cfg.d_model, cfg.vocab), ("embed", "vocab"))
        return sp

    def init(self, generator: torch.Generator, dtype=torch.float32):
        """Parameters drawn from ``generator``, on its device."""
        return init_params(self.param_specs(), generator, param_dtype=dtype)

    def abstract(self, dtype=torch.float32):
        """The parameter tree as tensors on the meta device: shapes and
        types, no storage (the reference's ShapeDtypeStruct tree)."""
        return _unflatten({
            path: torch.empty(spec.shape, dtype=dtype or spec.dtype, device="meta")
            for path, spec in tree_paths(self.param_specs()).items()})

    # ------------------------------------------------------------------
    # embedding / head
    # ------------------------------------------------------------------

    def embed(self, params, tokens):
        cfg = self.cfg
        x = params["embed"][tokens].to(_DTYPES[cfg.dtype])
        if cfg.embed_scale:
            x = x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype)
        return constrain(x, ("dp", None, None))

    def unembed(self, params, h):
        cfg = self.cfg
        w = params["lm_head"] if not cfg.tie_embeddings else params["embed"].T
        # h's type for the operands, float32 products and sums (exact
        # products for bf16, as the reference's preferred_element_type=f32)
        logits = torch.matmul(h.float(), w.to(h.dtype).float())
        if cfg.final_softcap:
            logits = cfg.final_softcap * torch.tanh(logits / cfg.final_softcap)
        return logits

    # ------------------------------------------------------------------
    # one group of layers (forward / prefill / decode share this)
    # ------------------------------------------------------------------

    def _apply_group(self, gp, x, *, positions, prefix_len, cache_g=None,
                     cache_pos=None, build_cache=0):
        """Unrolled pattern application.  Returns (x, new_cache_g)."""
        cfg = self.cfg
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
            else:                                       # rwkv
                tmx, (last_x, s_fin) = R.rwkv_time_mix(
                    sub["tm"], h, cfg,
                    shift_carry=lcache.get("tm_shift") if decoding else None,
                    state0=lcache.get("tm_state") if decoding else None)
                if decoding or build_cache:
                    nc["tm_shift"] = last_x
                    nc["tm_state"] = s_fin
                x = x + tmx
            # ---- ffn
            if pe.ffn == "dense":
                h2 = L.rms_norm(sub["ln2"], x, cfg.norm_eps)
                f = L.ffn(sub["ffn"], h2, cfg.ffn_act)
                if cfg.post_norm:
                    f = L.rms_norm(sub["post_ln2"], f, cfg.norm_eps)
                x = x + f
            elif pe.ffn == "rwkv_cm":
                h2 = L.rms_norm(sub["ln2"], x, cfg.norm_eps)
                f, cm_last = R.rwkv_channel_mix(
                    sub["cm"], h2, cfg,
                    shift_carry=lcache.get("cm_shift") if decoding else None)
                if decoding or build_cache:
                    nc["cm_shift"] = cm_last
                x = x + f
            x = constrain(x, ("dp", None, None))
            new_cache[key] = nc
        return x, new_cache

    def _inputs_to_x(self, params, batch):
        """tokens (+ image patches) -> (x, positions, prefix_len)."""
        cfg = self.cfg
        x = self.embed(params, batch["tokens"])
        prefix_len = 0
        if cfg.n_img_tokens and "patches" in batch:
            patches = batch["patches"].to(x.dtype)          # (B, P, d) stub
            x = torch.cat([patches, x], dim=1)
            prefix_len = patches.shape[1]
        B, S2 = x.shape[0], x.shape[1]
        positions = torch.arange(S2, dtype=torch.int32,
                                 device=x.device)[None].expand(B, S2)
        return x, positions, prefix_len

    def forward(self, params, batch):
        x, positions, prefix_len = self._inputs_to_x(params, batch)
        for g in range(self.cfg.n_groups):
            x, _ = self._apply_group(_index(params["layers"], g), x,
                                     positions=positions, prefix_len=prefix_len)
        x = L.rms_norm(params["final_norm"], x, self.cfg.norm_eps)
        return constrain(x, ("dp", None, None)), _zero_aux(x.device)

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
        nll, cnt, corr = [], [], []
        for lo in range(0, Sl, c):
            tc, mc = targets[:, lo:lo + c], mask[:, lo:lo + c]
            logits = self.unembed(params, h[:, lo:lo + c])  # (B, c, V) float32
            lse = torch.logsumexp(logits, dim=-1)
            tgt = torch.gather(logits, -1, tc[..., None].long())[..., 0]
            nll.append(((lse - tgt) * mc).sum())
            cnt.append(mc.sum())
            corr.append(((logits.argmax(-1) == tc) * mc).sum())
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

    def init_cache(self, batch_size: int, max_len: int,
                   cache_dtype=torch.bfloat16, device=None):
        """The decode state, stacked over the groups: a KV cache of
        ``(n_groups, B, max_len, KV, Dh)`` for each attention layer, the
        recurrent state of each RWKV layer, on ``device`` (default: the
        GPU; raises when there is none)."""
        cfg = self.cfg
        device = _resolve_device(device)
        g = {}
        for j, pe in enumerate(cfg.pattern):
            e: dict = {}
            if pe.mixer in ("attn", "local"):
                shape = (batch_size, max_len, cfg.n_kv_heads, cfg.d_head)
                e["self"] = {"k": torch.zeros(shape, dtype=cache_dtype, device=device),
                             "v": torch.zeros(shape, dtype=cache_dtype, device=device)}
            elif pe.mixer == "rwkv":
                st = R.init_rwkv_state(cfg, batch_size, device=device)
                e["tm_shift"], e["tm_state"] = st["tm_shift"], st["tm_state"]
            else:
                raise L.not_ported(f"the {pe.mixer!r} decode cache", "A2")
            if cfg.cross_attn:
                raise L.not_ported("the cross-attention cache", "A2")
            if pe.ffn == "rwkv_cm":
                e["cm_shift"] = torch.zeros((batch_size, cfg.d_model),
                                            dtype=cache_dtype, device=device)
            g[f"l{j}"] = e
        return _stack([g] * cfg.n_groups)

    def prefill(self, params, batch, max_len: int):
        """Run the prompt, build the cache (a bf16 KV cache, as in the
        reference).  Returns (last-pos logits, cache)."""
        x, positions, prefix_len = self._inputs_to_x(params, batch)
        caches = []
        for g in range(self.cfg.n_groups):
            x, nc = self._apply_group(_index(params["layers"], g), x,
                                      positions=positions, prefix_len=prefix_len,
                                      build_cache=max_len)
            caches.append(nc)
        x = L.rms_norm(params["final_norm"], x, self.cfg.norm_eps)
        return self.unembed(params, x[:, -1]), _stack(caches)

    def decode_step(self, params, cache, token, pos: int):
        """token: (B, 1) int; pos: the next position index, a Python int.
        Returns (logits (B, V), new cache); the KV leaves are ``cache``'s."""
        cfg = self.cfg
        x = self.embed(params, token)
        positions = None                    # rope's; a recurrence needs none
        if any(pe.mixer in ("attn", "local") for pe in cfg.pattern):
            positions = torch.full((x.shape[0], 1), pos, dtype=torch.int32,
                                   device=x.device)
        views, caches = [], []
        for g in range(cfg.n_groups):
            views.append(_index(cache, g))
            x, nc = self._apply_group(_index(params["layers"], g), x,
                                      positions=positions, prefix_len=0,
                                      cache_g=views[-1], cache_pos=pos)
            caches.append(nc)
        x = L.rms_norm(params["final_norm"], x, cfg.norm_eps)
        return self.unembed(params, x[:, -1]), _restack(cache, views, caches)

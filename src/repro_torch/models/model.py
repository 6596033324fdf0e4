"""The unified Model, ported: so far the RWKV-6 stack.

The port of ``repro/models/model.py``.  The config's ``pattern`` of
``(mixer, ffn)`` pairs is unrolled inside one group; the groups run in a
loop over the leading ``layers`` dim of the group-stacked parameters (the
reference scans them).  Parameters are the reference's nested dict, with
its dotted paths and layouts, passed to every entry point as in the
reference, so a checkpoint of either package loads into either model by
name.  Mixers and FFNs other than RWKV's raise ``NotImplementedError``
(ROADMAP A4).

Entry points:
  forward(params, batch)                -> (hidden (B,S,d), aux)
  prefill(params, batch, max_len)       -> (last logits, cache)  [serve]
  decode_step(params, cache, token, pos)-> (logits, new cache)   [serve]
"""

from __future__ import annotations

import torch
from torch import nn

from . import layers as L
from . import rwkv as R
from .config import ModelConfig
from .specs import ParamSpec, init_params
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
    """Group ``g`` of a group-stacked tree."""
    if isinstance(tree, dict):
        return {k: _index(v, g) for k, v in tree.items()}
    return tree[g]


def _stack(trees: list):
    """Group trees -> one tree with a leading group dim."""
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


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
        if pe.mixer != "rwkv" or pe.ffn not in ("rwkv_cm", "none") \
                or cfg.cross_attn:
            raise L.not_ported(f"mixer {pe.mixer!r} / ffn {pe.ffn!r}")
        sp: dict = {"ln1": L.norm_specs(cfg.d_model),
                    "tm": R.rwkv_time_specs(cfg)}
        if pe.ffn == "rwkv_cm":
            sp["ln2"] = L.norm_specs(cfg.d_model)
            sp["cm"] = R.rwkv_channel_specs(cfg)
        return sp

    def param_specs(self) -> dict:
        cfg = self.cfg
        if cfg.is_encdec:
            raise L.not_ported("the encoder-decoder path")
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

    def _apply_group(self, gp, x, *, cache_g=None, build_cache=False):
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
            tmx, (last_x, s_fin) = R.rwkv_time_mix(
                sub["tm"], h, cfg,
                shift_carry=lcache.get("tm_shift") if decoding else None,
                state0=lcache.get("tm_state") if decoding else None)
            if decoding or build_cache:
                nc["tm_shift"] = last_x
                nc["tm_state"] = s_fin
            x = x + tmx
            # ---- ffn (rwkv channel mix)
            if pe.ffn != "none":
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

    def forward(self, params, batch):
        x = self.embed(params, batch["tokens"])
        for g in range(self.cfg.n_groups):
            x, _ = self._apply_group(_index(params["layers"], g), x)
        x = L.rms_norm(params["final_norm"], x, self.cfg.norm_eps)
        return constrain(x, ("dp", None, None)), _zero_aux(x.device)

    # ------------------------------------------------------------------
    # serving: cache init / prefill / decode
    # ------------------------------------------------------------------

    def init_cache(self, batch_size: int, max_len: int,
                   cache_dtype=torch.bfloat16, device=None):
        """The decode state, stacked over the groups.  An RWKV stack keeps
        no per-token cache, so ``max_len`` sizes nothing here."""
        cfg = self.cfg
        g = {}
        for j, pe in enumerate(cfg.pattern):
            if pe.mixer != "rwkv" or cfg.cross_attn:
                raise L.not_ported(f"the {pe.mixer!r} decode cache")
            st = R.init_rwkv_state(cfg, batch_size, device=device)
            e = {"tm_shift": st["tm_shift"], "tm_state": st["tm_state"]}
            if pe.ffn == "rwkv_cm":
                e["cm_shift"] = torch.zeros((batch_size, cfg.d_model),
                                            dtype=cache_dtype, device=device)
            g[f"l{j}"] = e
        return _stack([g] * cfg.n_groups)

    def prefill(self, params, batch, max_len: int):
        """Run the prompt, build the cache.  Returns (last-pos logits, cache)."""
        x = self.embed(params, batch["tokens"])
        caches = []
        for g in range(self.cfg.n_groups):
            x, nc = self._apply_group(_index(params["layers"], g), x,
                                      build_cache=True)
            caches.append(nc)
        x = L.rms_norm(params["final_norm"], x, self.cfg.norm_eps)
        return self.unembed(params, x[:, -1]), _stack(caches)

    def decode_step(self, params, cache, token, pos):
        """token: (B, 1) int; pos: the next position index (attention's;
        an RWKV stack needs none).  Returns (logits (B, V), new cache)."""
        x = self.embed(params, token)
        caches = []
        for g in range(self.cfg.n_groups):
            x, nc = self._apply_group(_index(params["layers"], g), x,
                                      cache_g=_index(cache, g))
            caches.append(nc)
        x = L.rms_norm(params["final_norm"], x, self.cfg.norm_eps)
        return self.unembed(params, x[:, -1]), _stack(caches)

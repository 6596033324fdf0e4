"""Transformer building blocks of the port: so far only what RWKV-6 needs.

``norm_specs`` and ``rms_norm`` are the reference's
(``repro/models/layers.py:40`` and ``:60-81``, the baseline branch).
Attention, RoPE and the dense FFN arrive with the other model families
(ROADMAP A4); calling them raises ``NotImplementedError``.
"""

from __future__ import annotations

import torch

from .specs import ParamSpec

__all__ = ["rms_norm", "norm_specs", "rope", "attn_specs", "attention",
           "ffn_specs", "ffn", "not_ported"]


def not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported yet: the port serves rwkv6 only (ROADMAP A4)")


def norm_specs(d_model: int) -> dict:
    return {"scale": ParamSpec((d_model,), ("embed",), init="ones")}


# the reference's §Perf variants; the port has the baseline numerics only
PERF_FLAGS = {"rms_einsum": False, "softmax_bf16_probs": False}


def rms_norm(p: dict, x: torch.Tensor, eps: float = 1e-6,
             zero_centered: bool = False) -> torch.Tensor:
    """RMSNorm with float32 statistics over a float32 copy of ``x``."""
    if PERF_FLAGS["rms_einsum"]:
        raise not_ported("rms_norm's rms_einsum variant")
    dt = x.dtype
    scale = p["scale"].float()
    if zero_centered:
        scale = 1.0 + scale
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    xn = xf * torch.rsqrt(var + eps)
    return (xn * scale).to(dt)


def rope(*args, **kwargs):
    raise not_ported("rope")


def attn_specs(*args, **kwargs):
    raise not_ported("attention")


def attention(*args, **kwargs):
    raise not_ported("attention")


def ffn_specs(*args, **kwargs):
    raise not_ported("the dense FFN")


def ffn(*args, **kwargs):
    raise not_ported("the dense FFN")

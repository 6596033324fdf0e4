"""Causal self-attention over a whole prefill on the GPU
(``csrc/flash_attention.cu``), with float32 semantics and no scores in
device memory.

Replaces no Pallas kernel: the reference runs attention as float32 einsums
and an explicit softmax (``repro/models/layers.py``), which the port's eager
core reproduces (``models/layers.py:_scores_softmax_values``).  That eager
core stays the path for the CPU, autograd, fake tensors and every call the
kernel is not built for; ``models/layers.py:attend`` sends a real CUDA call
with autograd off, bf16 operands, the causal mask and no window, softcap or
bf16-probability variant, self-attention and head widths in ``WIDTHS`` to
:func:`flash_attention`, one launch over the whole sequence.

:func:`plain` is the kernel's order of the float32 operations in PyTorch
(bf16 products with float32 sums times the scale, an online softmax over
key tiles of ``BLOCK`` keys, each probability as three bf16 terms): the
CPU tests hold it to the eager core, and ``chip_smoke.py`` holds the
kernel to it.  The wrapper takes CUDA tensors alone and raises on anything
else; its checks are one ordered list, :func:`refusal`.
"""

from __future__ import annotations

import torch

from ._build import call

__all__ = ["flash_attention", "plain", "split3", "refusal", "WIDTHS", "BLOCK"]

WIDTHS = ((128, 128), (192, 128))   # (Dqk, Dv) the kernel is built for: GQA at
                                    # 128 (qwen3, jamba) and deepseek's expanded MLA
BLOCK = 64                          # keys a tile
_ROWS = 128                         # queries a CTA
_MAX_GRID = 65535                   # the grid's y (batch rows) and z (query tiles)


def refusal(q, k, v, q_pos, k_pos, cuda: bool = True) -> str | None:
    """Why the kernel cannot take these arguments (the first check they
    fail), or None.  ``cuda=False`` leaves the device check out."""
    for what, t in (("q", q), ("k", k), ("v", v)):
        if t.dim() != 4 or t.dtype != torch.bfloat16:
            return (f"{what} must be a 4-D bfloat16 tensor, got {t.dtype} "
                    f"{tuple(t.shape)}")
    B, S, H, dqk = q.shape
    T, KV = k.shape[1], k.shape[2]
    if k.shape != (B, T, KV, dqk) or v.shape[:3] != (B, T, KV):
        return (f"k and v must be (B, T, KV, D) beside q {tuple(q.shape)}, got "
                f"{tuple(k.shape)} and {tuple(v.shape)}")
    if (dqk, v.shape[3]) not in WIDTHS:
        return f"head widths {(dqk, v.shape[3])} are none of {WIDTHS}"
    if H % KV:
        return f"{H} query heads are no multiple of {KV} kv heads"
    for what, pos, n in (("q_pos", q_pos, S), ("k_pos", k_pos, T)):
        if pos.dtype != torch.int32 or pos.shape != (B, n) or (n > 1 and pos.stride(1) != 1):
            return (f"{what} must be int32 (B, {n}) with a unit stride, got {pos.dtype} "
                    f"{tuple(pos.shape)}")
    if B > _MAX_GRID or -(-S // _ROWS) > _MAX_GRID or T >= 2 ** 31:
        return f"at most {_MAX_GRID} batch rows and query tiles, got B {B}, S {S}, T {T}"
    for what, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(3) != 1 or any(s % 8 for s in t.stride()[:3]) or t.data_ptr() % 16:
            return (f"{what} must have a unit stride within a head, its other strides "
                    "multiples of 16 bytes and a 16-byte aligned start")
    if cuda and not (q.is_cuda and q.get_device() == k.get_device() == v.get_device()
                     == q_pos.get_device() == k_pos.get_device()):
        return (f"every tensor must lie on one CUDA device, got {q.device}, {k.device}, "
                f"{v.device}, {q_pos.device}, {k_pos.device}")
    return None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    q_pos: torch.Tensor, k_pos: torch.Tensor, scale: float) -> torch.Tensor:
    """Every query of q (B, S, H, Dqk) against every key of k (B, T, KV,
    Dqk) at a position no later than its own (``k_pos <= q_pos``), query
    head h reading kv head h // (H / KV), values v (B, T, KV, Dv): the
    softmax of the scores times ``scale``.  All three bf16; the positions
    int32 (B, S) and (B, T).  Returns (B, S, H, Dv) float32; a query that
    sees no key gets zeros."""
    why = refusal(q, k, v, q_pos, k_pos)
    if why is not None:
        raise ValueError(f"flash_attention: {why}")
    B, S, H, dqk = q.shape
    T, KV, dv = k.shape[1], k.shape[2], v.shape[3]
    out = torch.empty((B, S, H, dv), dtype=torch.float32, device=q.device)
    call(flash_attention, "rt_flash_attention", q.get_device(), q.data_ptr(),
         k.data_ptr(), v.data_ptr(), q_pos.data_ptr(), k_pos.data_ptr(), out.data_ptr(),
         B, S, T, H, KV, dqk, dv, *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
         q_pos.stride(0), k_pos.stride(0), scale)
    return out


flash_attention.launches = 0


def split3(p: torch.Tensor) -> tuple:
    """float32 p as three bf16 terms, each the rounding of what is left:
    p0 + p1 + p2 == p exactly wherever |p| >= 2**-110."""
    t0 = p.to(torch.bfloat16)
    r1 = p - t0.float()
    t1 = r1.to(torch.bfloat16)
    return t0, t1, (r1 - t1.float()).to(torch.bfloat16)


def plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, q_pos: torch.Tensor,
          k_pos: torch.Tensor, scale: float) -> torch.Tensor:
    """The kernel's order in PyTorch: the scores as float32 sums of exact
    products times ``scale``, masked where ``k_pos > q_pos``; an online
    softmax over tiles of ``BLOCK`` keys (a running max and sum, the
    accumulator rescaled by exp(old max - new max)); each probability as
    its three bf16 terms, each term's product with v summed in float32; the
    division by the row's sum last.  Arguments and result as
    :func:`flash_attention`'s, on any device."""
    B, S, H, dqk = q.shape
    T, KV, dv = k.shape[1], k.shape[2], v.shape[3]
    G = H // KV
    qf = q.float().reshape(B, S, KV, G, dqk)
    kf, vf = k.float(), v.float()
    m = torch.full((B, KV, G, S, 1), float("-inf"), device=q.device)
    l = torch.zeros((B, KV, G, S, 1), device=q.device)
    o = torch.zeros((B, KV, G, S, dv), device=q.device)
    for lo in range(0, T, BLOCK):
        hi = min(lo + BLOCK, T)
        s = torch.einsum("bskgd,btkd->bkgst", qf, kf[:, lo:hi]) * scale
        blocked = k_pos[:, None, lo:hi] > q_pos[:, :, None]              # (B,S,c)
        s = s.masked_fill(blocked[:, None, None], float("-inf"))
        mx = torch.maximum(m, s.amax(-1, keepdim=True))
        base = torch.where(mx == float("-inf"), torch.zeros_like(mx), mx)
        alpha = torch.exp(m - base)
        p = torch.exp(s - base)
        l = l * alpha + p.sum(-1, keepdim=True)
        o = o * alpha
        for term in split3(p):
            o = o + torch.einsum("bkgst,btkd->bkgsd", term.float(), vf[:, lo:hi])
        m = mx
    out = torch.where(l > 0, o / l.clamp_min(1e-30), torch.zeros_like(o))
    return out.permute(0, 3, 1, 2, 4).reshape(B, S, H, dv)

"""Dense transformer building blocks on torch: RMSNorm, rotary (incl.
M-RoPE), GQA attention (full / sliding-window / cached ring decode) and the
SwiGLU MLP (``repro``'s ``models/blocks.py``).

All blocks are functions over nested dicts of tensors with the reference's
keys. Matmuls run in the config dtype; norm statistics and softmax run in
f32, and every cast sits where the reference puts it (``cos``/``sin`` to
the activation dtype before the multiply, probabilities to the value dtype
before P.V, the online-softmax accumulator in the activation dtype, -1e30
as the mask fill). The JAX package computes attention and the projections
outside any Pallas kernel, so here they are plain torch.

Initializers take an explicit ``torch.Generator`` and a ``lead`` shape of
stacked layers: ``dense_init(g, (d, f), lead=(L,))`` draws an (L, d, f)
stack with the fan-in of one (d, f) layer.

The MoE layer and its expert-parallel path (``moe_*``, ``models/dist.py``)
come with slice 4 of the port (ROADMAP Queue A).
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig

Params = Dict[str, Any]
MASK_FILL = -1e30


# ---------------------------------------------------------------------------
# initialization helpers
# ---------------------------------------------------------------------------
def dense_init(gen: Optional[torch.Generator], shape, dtype: torch.dtype,
               scale: float = 1.0, *, lead=(),
               device=None) -> torch.Tensor:
    """Truncated-normal fan-in init (the LM-standard 1/sqrt(fan_in)) of a
    ``lead + shape`` stack; fan-in is that of one ``shape``. On the meta
    device (shapes only) nothing is drawn."""
    fan_in = shape[0] if len(shape) <= 2 else shape[-2]
    std = scale / max(1.0, fan_in) ** 0.5
    t = torch.empty((*lead, *shape), dtype=torch.float32, device=device)
    if t.device.type == "meta":
        return t.to(dtype)
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -3.0, 3.0, generator=gen)
    return (t.mul_(std)).to(dtype)


# ---------------------------------------------------------------------------
# RMSNorm
# ---------------------------------------------------------------------------
def rmsnorm_init(d: int, dtype: torch.dtype, *, lead=(),
                 device=None) -> Params:
    return {"scale": torch.ones((*lead, d), dtype=dtype, device=device)}


def rmsnorm(params: Params, x: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * params["scale"].float()).to(x.dtype)


# ---------------------------------------------------------------------------
# Rotary embeddings (standard + 3-axis M-RoPE)
# ---------------------------------------------------------------------------
def rope_angles(cfg: ArchConfig, positions: torch.Tensor) -> torch.Tensor:
    """Rotation angles per (batch, seq, d_head/2), f32.

    ``positions``: (B, S) integers for standard RoPE, or (3, B, S) for
    M-RoPE, where ``cfg.mrope_sections`` gives each position stream its
    band of frequencies."""
    half = cfg.head_dim // 2
    exps = torch.arange(0, half, dtype=torch.float32,
                        device=positions.device) / half
    inv_freq = 1.0 / torch.pow(torch.tensor(cfg.rope_theta,
                                            dtype=torch.float32,
                                            device=positions.device), exps)
    pos = positions.float()
    if cfg.mrope:
        sections = cfg.mrope_sections
        assert sum(sections) == half, (sections, half)
        axis_of_band = torch.repeat_interleave(
            torch.arange(3, device=positions.device),
            torch.tensor(sections, device=positions.device))
        pos_per_band = pos[axis_of_band]                     # (half, B, S)
        return torch.einsum("hbs,h->bsh", pos_per_band, inv_freq)
    return pos[..., None] * inv_freq                         # (B, S, half)


def apply_rope(x: torch.Tensor, angles: torch.Tensor) -> torch.Tensor:
    """x: (B, S, H, D); angles: (B, S, D/2). Rotate-half convention."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    cos = torch.cos(angles)[:, :, None, :].to(x.dtype)
    sin = torch.sin(angles)[:, :, None, :].to(x.dtype)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


# ---------------------------------------------------------------------------
# GQA attention
# ---------------------------------------------------------------------------
def attention_init(gen: Optional[torch.Generator], cfg: ArchConfig, *,
                   lead=(), device=None) -> Params:
    d, hd = cfg.d_model, cfg.head_dim
    kw = dict(lead=lead, device=device)
    p = {
        "wq": dense_init(gen, (d, cfg.num_heads * hd), cfg.dtype, **kw),
        "wk": dense_init(gen, (d, cfg.num_kv_heads * hd), cfg.dtype, **kw),
        "wv": dense_init(gen, (d, cfg.num_kv_heads * hd), cfg.dtype, **kw),
        "wo": dense_init(gen, (cfg.num_heads * hd, d), cfg.dtype,
                         scale=1.0 / (2 * cfg.num_layers) ** 0.5, **kw),
    }
    if cfg.qk_norm:
        p["q_norm"] = rmsnorm_init(hd, cfg.dtype, **kw)
        p["k_norm"] = rmsnorm_init(hd, cfg.dtype, **kw)
    return p


def _attn_scores_mask(q_pos: torch.Tensor, k_pos: torch.Tensor,
                      window: int) -> torch.Tensor:
    """Causal (+ optional sliding window) mask. q_pos/k_pos: (Sq,), (Sk,)."""
    causal = q_pos[:, None] >= k_pos[None, :]
    if window > 0:
        causal &= q_pos[:, None] - k_pos[None, :] < window
    return causal


ATTN_CHUNK = 512


def _chunked_causal_attention(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, window: int,
                              chunk: int = ATTN_CHUNK) -> torch.Tensor:
    """Memory-O(S·chunk) causal attention (online softmax over KV chunks).

    Outer loop over query chunks (the triangular structure is static, so
    no masked-out chunk is computed), inner loop over the causal KV range
    with a running (m, l, acc); SWA trims the range to the window.

    q: (B, S, Hkv, G, hd); k, v: (B, S, Hkv, hd) -> (B, S, Hkv, G, hd)
    """
    B, S, Hkv, G, hd = q.shape
    scale = hd ** -0.5
    if S <= chunk:
        logits = torch.einsum("bqhgd,bkhd->bhgqk", q, k).float() * scale
        pos = torch.arange(S, device=q.device)
        mask = _attn_scores_mask(pos, pos, window)
        logits = torch.where(mask, logits, MASK_FILL)
        probs = torch.softmax(logits, dim=-1).to(q.dtype)
        return torch.einsum("bhgqk,bkhd->bqhgd", probs, v)

    assert S % chunk == 0, (S, chunk)
    nq = S // chunk
    pos = torch.arange(chunk, device=q.device)
    blocks = []
    for qi in range(nq):
        # causal range: kv chunks [lo, qi]; SWA trims lo to the window
        lo = 0 if window <= 0 else max(0, qi - (window + chunk - 1) // chunk)
        q_blk = q[:, qi * chunk:(qi + 1) * chunk]
        q_pos = qi * chunk + pos
        m = torch.full((B, Hkv, G, chunk), -torch.inf, dtype=torch.float32,
                       device=q.device)
        l = torch.zeros((B, Hkv, G, chunk), dtype=torch.float32,
                        device=q.device)
        acc = torch.zeros((B, Hkv, G, chunk, hd), dtype=q.dtype,
                          device=q.device)
        for kj in range(lo, qi + 1):
            k_blk = k[:, kj * chunk:(kj + 1) * chunk]
            v_blk = v[:, kj * chunk:(kj + 1) * chunk]
            s = torch.einsum("bqhgd,bkhd->bhgqk", q_blk, k_blk).float() * scale
            mask = _attn_scores_mask(q_pos, kj * chunk + pos, window)
            s = torch.where(mask, s, MASK_FILL)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            pv = torch.einsum("bhgqk,bkhd->bhgqd", p.to(v_blk.dtype), v_blk)
            acc = acc * corr[..., None].to(acc.dtype) + pv
            m = m_new
        out = acc / torch.clamp(l, min=1e-30)[..., None].to(acc.dtype)
        blocks.append(out.permute(0, 3, 1, 2, 4))        # (B, chunk, Hkv, G, hd)
    return torch.cat(blocks, dim=1)


def multihead_attention(
    params: Params,
    cfg: ArchConfig,
    x: torch.Tensor,                         # (B, S, d)
    angles: torch.Tensor,                    # (B, S, hd/2)
    *,
    kv_cache: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    cache_pos: Optional[torch.Tensor] = None,    # 0-dim: tokens already cached
) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Full-sequence (prefill) or single-token cached (decode) attention.

    Decode: ``x`` is (B, 1, d); ``kv_cache`` = (k, v) each (B, W, Hkv, hd)
    where W is the cache window (ring-indexed when SWA is on). The token's
    K/V are written into the ring in place; returns (out, (k, v)) with the
    same cache tensors. Prefill returns the sequence's own (k, v).
    """
    B, S, _ = x.shape
    H, Hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q = (x @ params["wq"]).reshape(B, S, H, hd)
    k = (x @ params["wk"]).reshape(B, S, Hkv, hd)
    v = (x @ params["wv"]).reshape(B, S, Hkv, hd)
    if cfg.qk_norm:
        q = rmsnorm(params["q_norm"], q, cfg.norm_eps)
        k = rmsnorm(params["k_norm"], k, cfg.norm_eps)
    q = apply_rope(q, angles)
    k = apply_rope(k, angles)
    scale = hd ** -0.5
    g = H // Hkv

    if kv_cache is None:
        # ---- prefill: chunked causal (+SWA) attention -----------------------
        out = _chunked_causal_attention(q.reshape(B, S, Hkv, g, hd), k, v,
                                        cfg.sliding_window,
                                        chunk=min(cfg.attn_chunk, S))
        return out.reshape(B, S, H * hd) @ params["wo"], (k, v)

    # ---- decode: write one token into the (ring) cache, in place -----------
    ck, cv = kv_cache
    W = ck.shape[1]
    slot = torch.remainder(cache_pos, W).long()
    ck.index_copy_(1, slot.view(1), k.to(ck.dtype))
    cv.index_copy_(1, slot.view(1), v.to(cv.dtype))
    qh = q.reshape(B, 1, Hkv, g, hd)
    logits = torch.einsum("bqhgd,bkhd->bhgqk", qh, ck).float() * scale
    # valid cache entries: absolute position of slot i in the ring
    idx = torch.arange(W, device=x.device)
    if cfg.sliding_window > 0:
        abs_pos = torch.where(idx <= slot, cache_pos - slot + idx,
                              cache_pos - slot + idx - W)
        valid = (abs_pos >= 0) & (abs_pos > cache_pos - cfg.sliding_window)
    else:
        valid = idx < cache_pos + 1              # tokens seen incl. current
    logits = torch.where(valid, logits, MASK_FILL)
    probs = torch.softmax(logits, dim=-1).to(x.dtype)
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs, cv).reshape(B, 1, H * hd)
    return out @ params["wo"], (ck, cv)


# ---------------------------------------------------------------------------
# SwiGLU MLP
# ---------------------------------------------------------------------------
def mlp_init(gen: Optional[torch.Generator], cfg: ArchConfig,
             d_ff: Optional[int] = None, *, lead=(), device=None) -> Params:
    d, f = cfg.d_model, d_ff or cfg.d_ff
    kw = dict(lead=lead, device=device)
    p = {}
    if cfg.gated_mlp:
        p["w_gate"] = dense_init(gen, (d, f), cfg.dtype, **kw)
    p["w_up"] = dense_init(gen, (d, f), cfg.dtype, **kw)
    p["w_down"] = dense_init(gen, (f, d), cfg.dtype,
                             scale=1.0 / (2 * cfg.num_layers) ** 0.5, **kw)
    return p


def mlp(params: Params, x: torch.Tensor) -> torch.Tensor:
    if "w_gate" in params:             # SwiGLU
        return (F.silu(x @ params["w_gate"])
                * (x @ params["w_up"])) @ params["w_down"]
    return F.gelu(x @ params["w_up"], approximate="tanh") @ params["w_down"]


# ---------------------------------------------------------------------------
# Mixture of Experts: slice 4
# ---------------------------------------------------------------------------
def _moe_not_ported(*_args, **_kwargs):
    raise NotImplementedError(
        "MoE blocks (moe_init, moe_ffn and the expert-parallel path of "
        "models/dist.py) are ported in slice 4 of the port (ROADMAP Queue A)")


moe_init = moe_ffn = moe_capacity = _moe_not_ported

"""Transformer building blocks on torch: RMSNorm, rotary (incl. M-RoPE),
GQA attention (full / sliding-window / cached ring decode), the SwiGLU MLP
and the sort-based MoE layer (``repro``'s ``models/blocks.py``).

All blocks are functions over nested dicts of tensors with the reference's
keys. Matmuls run in the config dtype; norm statistics and softmax run in
f32, and every cast sits where the reference puts it (``cos``/``sin`` to
the activation dtype before the multiply, probabilities to the value dtype
before P.V, the online-softmax accumulator in the activation dtype, -1e30
as the mask fill). Attention prefill goes through ``ops.flash_attention``:
on the card kernel B5 (``kernels/csrc/flash_attention.cu``), on the CPU
``kernels/ref.chunked_causal_attention``, the JAX package's XLA-path
equivalent of its Pallas kernel. Decode attention and the projections are plain
torch, as the JAX package computes them outside any Pallas kernel.

Initializers take an explicit ``torch.Generator`` and a ``lead`` shape of
stacked layers: ``dense_init(g, (d, f), lead=(L,))`` draws an (L, d, f)
stack with the fan-in of one (d, f) layer.

The MoE layer is the reference's local path: router, top-k and dispatch
are plain torch ops, as the JAX package computes them outside any Pallas
kernel, and the three expert products are batched matmuls. Its
expert-parallel path over a mesh (``_moe_ffn_sharded`` and
``models/dist.py``: all-to-all between cards) waits for ROADMAP item 16,
which needs more than one card; on one card the local path is the whole
computation.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig, MoEConfig
from repro_torch.kernels import ops
from repro_torch.kernels.ref import MASK_FILL

Params = Dict[str, Any]


# ---------------------------------------------------------------------------
# initialization helpers
# ---------------------------------------------------------------------------
def dense_init(gen: Optional[torch.Generator], shape, dtype: torch.dtype,
               scale: float = 1.0, *, lead=(),
               device=None) -> torch.Tensor:
    """Truncated-normal fan-in init (the LM-standard 1/sqrt(fan_in)) of a
    ``lead + shape`` stack; fan-in is that of one ``shape``. Drawn one
    (fan_in, fan_out) matrix at a time into the output, so the f32 scratch
    is one matrix (a whole f32 expert stack of qwen3-moe is 38.7 GB). On
    the meta device (shapes only) nothing is drawn."""
    fan_in = shape[0] if len(shape) <= 2 else shape[-2]
    std = scale / max(1.0, fan_in) ** 0.5
    out = torch.empty((*lead, *shape), dtype=dtype, device=device)
    if out.device.type == "meta":
        return out
    for part in out.view(-1, *shape[-2:]):
        t = torch.empty(part.shape, dtype=torch.float32, device=device)
        torch.nn.init.trunc_normal_(t, 0.0, 1.0, -3.0, 3.0, generator=gen)
        part.copy_(t.mul_(std))
    return out


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
        # ---- prefill: causal (+SWA) attention, B5 on the card ---------------
        out = ops.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                                  v.transpose(1, 2),
                                  window=cfg.sliding_window,
                                  chunk=min(cfg.attn_chunk, S))
        return (out.transpose(1, 2).reshape(B, S, H * hd) @ params["wo"],
                (k, v))

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
# Mixture of Experts (sort-based dispatch)
# ---------------------------------------------------------------------------
def moe_init(gen: Optional[torch.Generator], cfg: ArchConfig, *, lead=(),
             device=None) -> Params:
    """The router stays f32 in a bf16 model, as in the reference."""
    m = cfg.moe
    d, f, E = cfg.d_model, m.d_ff_expert, m.num_experts
    kw = dict(lead=lead, device=device)
    p = {
        "router": dense_init(gen, (d, E), torch.float32, **kw),
        "w_gate": dense_init(gen, (E, d, f), cfg.dtype, **kw),
        "w_up": dense_init(gen, (E, d, f), cfg.dtype, **kw),
        "w_down": dense_init(gen, (E, f, d), cfg.dtype,
                             scale=1.0 / (2 * cfg.num_layers) ** 0.5, **kw),
    }
    if m.num_shared_experts:
        p["shared"] = mlp_init(gen, cfg, d_ff=m.num_shared_experts * f, **kw)
    return p


def moe_capacity(m: MoEConfig, num_tokens: int) -> int:
    """Slots per expert for ``num_tokens`` tokens, rounded up to 8 as the
    reference rounds it (the rounding decides which tokens drop)."""
    cap = int(num_tokens * m.top_k * m.capacity_factor / m.num_experts) + 1
    return max(8, -(-cap // 8) * 8)


def _route(params: Params, m: MoEConfig, xt: torch.Tensor):
    """Router: (T, d) -> (gate (T, K) f32, expert (T, K) int64, p_sum (E,),
    c_sum (E,)). Top-k over the f32 softmax probabilities, gates
    renormalised over K; p_sum and c_sum are the load-balance sums."""
    E = m.num_experts
    logits = xt.float() @ params["router"]                    # (T, E)
    probs = torch.softmax(logits, dim=-1)
    gate, expert = torch.topk(probs, m.top_k, dim=-1)
    gate = gate / gate.sum(dim=-1, keepdim=True)
    p_sum = probs.sum(dim=0)
    flat = expert.reshape(-1)
    c_sum = torch.zeros(E, device=xt.device).index_add_(
        0, flat, torch.ones(flat.shape, device=xt.device))
    return gate, expert, p_sum, c_sum


def _fill_buffer(xt: torch.Tensor, expert: torch.Tensor, E: int, C: int):
    """Sort-based dispatch: rank each (token, k) within its expert by a
    stable argsort of the flat expert ids, scatter into an (E, C, d)
    capacity buffer; overflow goes to row E*C, which is dropped. Returns
    (buffer, slot (T*K,))."""
    T, d = xt.shape
    TK = expert.numel()
    K = TK // T
    flat_e = expert.reshape(-1)
    order = torch.argsort(flat_e, stable=True)
    counts = torch.zeros(E, dtype=flat_e.dtype, device=xt.device
                         ).index_add_(0, flat_e, torch.ones_like(flat_e))
    starts = torch.cumsum(counts, 0) - counts
    pos = torch.empty_like(flat_e)
    pos[order] = (torch.arange(TK, device=xt.device)
                  - starts[flat_e[order]])
    slot = torch.where(pos < C, flat_e * C + pos, E * C)      # OOB -> drop
    x_rep = xt.repeat_interleave(K, dim=0)                    # (T*K, d)
    buf = xt.new_zeros((E * C + 1, d)).index_copy(0, slot, x_rep)
    return buf[: E * C].reshape(E, C, d), slot


def _expert_swiglu(h: torch.Tensor, wg, wu, wd) -> torch.Tensor:
    """(E, C, d) through each expert's SwiGLU: three batched products."""
    a = F.silu(torch.bmm(h, wg))
    return torch.bmm(a * torch.bmm(h, wu), wd)


def _combine(y: torch.Tensor, slot: torch.Tensor, gate: torch.Tensor,
             T: int) -> torch.Tensor:
    """Each token's K expert outputs, gated in the outputs' dtype and summed
    over K; a dropped (token, k) adds zeros."""
    E_C, d = y.shape[0] * y.shape[1], y.shape[-1]
    K = slot.numel() // T
    dropped = (slot >= E_C)[:, None]
    gathered = y.reshape(E_C, d)[slot.clamp(max=E_C - 1)]
    gathered = torch.where(dropped, y.new_zeros(()), gathered)
    weighted = gathered * gate.reshape(-1, 1).to(y.dtype)
    return weighted.reshape(T, K, d).sum(dim=1)


def moe_ffn(params: Params, cfg: ArchConfig, x: torch.Tensor
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k expert layer. x: (B, S, d) -> (out, aux_loss f32 0-dim).

    The capacity is taken over all B*S tokens of the call. Every expert
    runs its products over its C slots, empty or not, as the reference
    does."""
    m = cfg.moe
    B, S, d = x.shape
    T, E = B * S, m.num_experts
    xt = x.reshape(T, d)
    gate, expert, p_sum, c_sum = _route(params, m, xt)
    aux = E * torch.sum((p_sum / T) * (c_sum / (T * m.top_k))) \
        * m.aux_loss_weight
    C = moe_capacity(m, T)
    buf, slot = _fill_buffer(xt, expert, E, C)
    del expert
    y = _expert_swiglu(buf, params["w_gate"], params["w_up"],
                       params["w_down"])
    del buf
    out = _combine(y, slot, gate, T)
    del y
    if m.num_shared_experts:
        out = out + mlp(params["shared"], xt)
    return out.reshape(B, S, d), aux

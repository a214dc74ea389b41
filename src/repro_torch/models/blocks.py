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
equivalent of its Pallas kernel. Decode attention against a whole ring
goes through ``ops.decode_attention`` from the projections' outputs
(rotary, the ring write and the attention over the ring in place): on the
card ``kernels/csrc/decode_attention.cu``, on the CPU
``kernels/ref.decode_attention_ref``, the composition the JAX package
computes outside any Pallas kernel. The projections, and the decode
against a ring cut along its window (``_decode_window``), are plain torch.

zamba2's shared block (``shared_block``: attention over concat(h, token
embeddings), a gated MLP with a per-call LoRA, the call's linear) is here
too; ``models/lm.py``'s ``hybrid_ids`` wiring calls it. A config's
``attn_scale`` replaces the softmax scale ``head_dim ** -0.5`` in prefill
(given to B5) and in the whole-ring decode.

Initializers take an explicit ``torch.Generator`` and a ``lead`` shape of
stacked layers: ``dense_init(g, (d, f), lead=(L,))`` draws an (L, d, f)
stack with the fan-in of one (d, f) layer.

The MoE layer's router, top-k and dispatch are plain torch ops, as the
JAX package computes them outside any Pallas kernel, and the three expert
products are batched matmuls. Under a ``models/dist.DistContext`` the
layer is the reference's expert-parallel path (``_moe_ffn_sharded``): each
rank routes its tokens, sends them to their experts' ranks with an
all-to-all over the ``model`` axis, gathers its experts' weights over
``data`` (ZeRO-3), and sends the outputs back; its weights are cut by
``moe_shard_params``.

Under a context the attention and the MLP are tensor-parallel too
(Megatron's layout, the one GSPMD gives the reference from
``launch/sharding``'s rules): ``wq``/``wk``/``wv`` and ``w_gate``/``w_up``
are column blocks over ``model`` and ZeRO-3 shards over ``data``
(all-gathered there before use), ``wo`` and ``w_down`` row blocks whose
partial products leave the region through ``dist.tp_exit``. A rank
computes its H/tp query heads and the KV heads they read (kernel B5 takes
them as they are); its decode reads its block of the KV ring, the KV heads
(``launch/sharding.kv_split``) or, where ``model`` does not divide them,
the ring's window, whose per-slice softmax sums are merged over ``model``,
or, cut neither way, the whole ring. Where ``model`` does not cut the
heads (``head_split``), every rank computes all of them on the gathered
weights (``_attention_replicated``).
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig, MoEConfig
from repro_torch.kernels import ops
from repro_torch.kernels.ref import MASK_FILL, apply_rope, decode_valid
from repro_torch.runtime import spans

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
        # from the sections' sizes on the host: a repeat count read from a
        # tensor is a shape that a trace on fake tensors cannot know
        axis_of_band = torch.tensor(
            [a for a, n in enumerate(sections) for _ in range(n)],
            device=positions.device)
        pos_per_band = pos[axis_of_band]                     # (half, B, S)
        return torch.einsum("hbs,h->bsh", pos_per_band, inv_freq)
    return pos[..., None] * inv_freq                         # (B, S, half)


# ---------------------------------------------------------------------------
# GQA attention
# ---------------------------------------------------------------------------
def attention_init(gen: Optional[torch.Generator], cfg: ArchConfig, *,
                   d_in: Optional[int] = None, lead=(),
                   device=None) -> Params:
    """q, k, v from an input of ``d_in`` (default d_model), o back to
    d_model."""
    d, hd = cfg.d_model, cfg.head_dim
    di = d_in or d
    kw = dict(lead=lead, device=device)
    p = {
        "wq": dense_init(gen, (di, cfg.num_heads * hd), cfg.dtype, **kw),
        "wk": dense_init(gen, (di, cfg.num_kv_heads * hd), cfg.dtype, **kw),
        "wv": dense_init(gen, (di, cfg.num_kv_heads * hd), cfg.dtype, **kw),
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
    from repro_torch.models import dist
    ctx = dist.current()
    if ctx is not None:
        return _attention_tp(params, cfg, x, angles, kv_cache, cache_pos,
                             ctx)
    B, S, _ = x.shape
    q, k, v = _qkv(params, cfg, x, angles, rotate=kv_cache is None)
    if kv_cache is None:
        # ---- prefill: causal (+SWA) attention, B5 on the card ---------------
        out = ops.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                                  v.transpose(1, 2),
                                  window=cfg.sliding_window,
                                  chunk=min(cfg.attn_chunk, S),
                                  scale=cfg.attn_scale or None)
        return (out.transpose(1, 2).reshape(B, S, -1) @ params["wo"],
                (k, v))
    # ---- decode: write one token into the (ring) cache, in place -----------
    out = _decode_whole(cfg, q, k, v, angles, kv_cache, cache_pos)
    return out @ params["wo"], kv_cache


def _qkv(params: Params, cfg: ArchConfig, x: torch.Tensor,
         angles: torch.Tensor, *, rotate: bool = True):
    """Every head's q, k, v (B, S, heads, hd) from whole weights: the
    projections, ``qk_norm``, and unless ``rotate`` is False (a whole-ring
    decode, whose op takes them before rotary) rotary on q and k."""
    B, S, _ = x.shape
    hd = cfg.head_dim
    q = (x @ params["wq"]).reshape(B, S, cfg.num_heads, hd)
    k = (x @ params["wk"]).reshape(B, S, cfg.num_kv_heads, hd)
    v = (x @ params["wv"]).reshape(B, S, cfg.num_kv_heads, hd)
    if cfg.qk_norm:
        q = rmsnorm(params["q_norm"], q, cfg.norm_eps)
        k = rmsnorm(params["k_norm"], k, cfg.norm_eps)
    if not rotate:
        return q, k, v
    return apply_rope(q, angles), apply_rope(k, angles), v


def _decode_whole(cfg: ArchConfig, q: torch.Tensor, k: torch.Tensor,
                  v: torch.Tensor, angles: torch.Tensor, ring, cache_pos,
                  kv=None) -> torch.Tensor:
    """One token's decode against a ring that holds every slot of the
    window, by ``ops.decode_attention``: ``q`` (B, 1, n, hd) and ``k``/``v``
    (B, 1, heads, hd), the heads the ring holds, before rotary; rotary on
    q and k, k/v written into slot ``cache_pos`` % W in place; the query
    heads read the ring's KV heads ``kv`` = [kv0, kv1) (all of them by
    default) in GQA groups. Returns (B, 1, n hd)."""
    return ops.decode_attention(q, k, v, angles, ring, cache_pos,
                                window=cfg.sliding_window,
                                scale=cfg.attn_scale or None, kv=kv)


def _decode_window(cfg: ArchConfig, q: torch.Tensor, k: torch.Tensor,
                   v: torch.Tensor, ring, cache_pos, ctx) -> torch.Tensor:
    """One token's decode against the rank's block of a ring cut along its
    window over ``model`` (``launch/sharding.kv_split`` "window"): slots
    [r Wl, (r+1) Wl) of the W = Wl tp, every KV head. The rank that holds
    the token's slot writes ``k``/``v`` there; every query head ``q`` (B,
    1, H, hd) attends to the rank's slots, and the blocks' softmax sums are
    merged over ``model``. Returns every head's output (B, 1, H hd), the
    same on every rank."""
    from repro_torch.models import dist
    mesh, ax = ctx.mesh, ctx.tp_axis
    tp, r = dist.tp_size(ctx), dist.tp_rank(ctx)
    ck, cv = ring
    B, _, H, hd = q.shape
    Hkv = ck.shape[2]
    Wl = ck.shape[1]
    W = Wl * tp
    slot = torch.remainder(cache_pos, W).long()
    here = slot - r * Wl                    # the slot in this rank's block
    mine = (here >= 0) & (here < Wl)
    li = here.clamp(0, Wl - 1).view(1)
    for c, t in ((ck, k), (cv, v)):
        c.index_copy_(1, li, torch.where(mine, t.to(c.dtype),
                                         c.index_select(1, li)))
    qh = q.reshape(B, 1, Hkv, H // Hkv, hd)
    logits = torch.einsum("bqhgd,bkhd->bhgqk", qh, ck).float() * hd ** -0.5
    idx = r * Wl + torch.arange(Wl, device=q.device)
    logits = torch.where(decode_valid(cfg.sliding_window, W, cache_pos, slot,
                                      idx), logits, MASK_FILL)
    # log-sum-exp merge over the window's blocks: the max over every block
    # first, then each block's exp-sums and P.V summed over ``model``
    top = dist.all_reduce_max(logits.amax(dim=-1, keepdim=True), mesh, ax)
    p = torch.exp(logits - top)
    denom = dist.reduce_from_tp(p.sum(dim=-1), mesh, ax)      # (B, h, g, 1)
    pv = dist.reduce_from_tp(
        torch.einsum("bhgqk,bkhd->bqhgd", p, cv.float()), mesh, ax)
    out = (pv / denom.permute(0, 3, 1, 2)[..., None]).to(q.dtype)
    return out.reshape(B, 1, H * hd)


def head_split(cfg: ArchConfig, tp: int) -> str:
    """How the attention sits on a ``model`` axis of ``tp`` ranks:
    ``"heads"`` where the axis divides the query heads and each rank's
    block of H/tp heads is whole GQA groups of its KV heads, or lies in one
    group (B5 reads query head h from KV head h // group), so a rank
    computes its own heads (``_attention_tp``); else ``"replicated"``:
    ``launch/sharding``'s cuts of ``wq``/``wk``/``wv``/``wo`` do not fall on
    head boundaries, or leave the weights whole, and every rank computes
    every head (``_attention_replicated``), as GSPMD computes the
    reference's layout there. Read from the config and the mesh alone,
    before any launch."""
    H, Hkv = cfg.num_heads, cfg.num_kv_heads
    if tp == 1:
        return "heads"
    if H % tp:
        return "replicated"
    Hq, g = H // tp, H // Hkv
    return "heads" if Hq % g == 0 or g % Hq == 0 else "replicated"


def ring_split(cfg: ArchConfig, ctx, Wl: int) -> Optional[str]:
    """How ``model`` cut the rank's decode ring of ``Wl`` slots
    (``launch/sharding.kv_split`` of the whole ring): ``"heads"``,
    ``"window"`` or None (the whole ring on every rank). The whole ring's
    window is ``ctx.kv_window`` where the caller set it; without it, a
    block of ``Wl`` slots that ``model`` divides is a window's block (a
    whole ring the axis divides would be cut along its window), and any
    other block is ambiguous, refused."""
    from repro_torch.launch.sharding import kv_split
    from repro_torch.models import dist
    tp, Hkv = dist.tp_size(ctx), cfg.num_kv_heads
    if Hkv % tp == 0:
        return "heads"
    W = ctx.kv_window
    if W is None:
        if Wl % tp:
            raise ValueError(
                f"decode on a model axis of {tp}: a ring block of {Wl} slots "
                f"is a whole ring or 1/{tp} of a ring of {Wl * tp} cut along "
                "its window; set the context's kv_window "
                "(dist.model_context)")
        W = Wl * tp
    where = kv_split(ctx.mesh, Hkv, W)
    if Wl != (W // tp if where == "window" else W):
        raise ValueError(f"decode: a ring block of {Wl} slots is not the "
                         f"rank's block of a ring of {W} cut by {where}")
    return where


def _kv_block(cfg: ArchConfig, tp: int, r: int) -> Tuple[int, int]:
    """The KV heads [kv0, kv1) that rank ``r`` of ``tp``'s query heads
    [r H/tp, (r+1) H/tp) read, under ``head_split`` "heads"."""
    Hq, g = cfg.num_heads // tp, cfg.num_heads // cfg.num_kv_heads
    return (r * Hq) // g, ((r + 1) * Hq - 1) // g + 1


def _attention_tp(params: Params, cfg: ArchConfig, x: torch.Tensor,
                  angles: torch.Tensor, kv_cache, cache_pos, ctx):
    """``multihead_attention`` on this rank under ``ctx``: under
    ``head_split`` "heads" its H/tp query heads and the KV heads they read
    (``_kv_block``), else ``_attention_replicated``.

    ``params`` are the rank's slices (``launch/sharding``): ``wq`` the
    columns of its heads; ``wk``/``wv`` those of its KV heads where
    ``model`` divides them, else all-gathered over ``model`` (or whole,
    replicated) and every KV head computed; ``wo`` the rows of its heads;
    every one a ZeRO-3 shard over ``data``, all-gathered here. Prefill
    (and training) runs B5 on the rank's heads over the whole sequence
    (with ``seq_shard`` ``dist.tp_enter`` gathers it) and returns the K/V
    in the rank's ring layout: its KV heads, or all of them where the ring
    is not cut by heads. Decode reads the rank's block of the ring
    (``ring_split``): its KV heads; the ring's slots [r W/tp, (r+1) W/tp)
    with every head, softmax sums merged over ``model``
    (``_decode_window``); or the whole ring (``_decode_whole``) on the
    rank's heads."""
    from repro_torch.models import dist
    tp, r = dist.tp_size(ctx), dist.tp_rank(ctx)
    if head_split(cfg, tp) == "replicated":
        return _attention_replicated(params, cfg, x, angles, kv_cache,
                                     cache_pos, ctx)
    mesh, ax = ctx.mesh, ctx.tp_axis
    d, H, Hkv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    kv0, kv1 = _kv_block(cfg, tp, r)
    Hq = H // tp
    wq = dist.fsdp(params["wq"], ctx, d, 0)
    wo = dist.fsdp(params["wo"], ctx, d, 1)
    own_kv = Hkv % tp == 0                 # wk/wv hold the rank's KV heads

    def kv_weight(w):
        w = dist.fsdp(w, ctx, d, 0)
        if own_kv or w.shape[1] == Hkv * hd:
            # a replicated weight used for part of the work: sum its grads
            return w if own_kv else dist.tp_param(w, ctx)
        return dist.all_gather(w, mesh, ax, dim=1)

    wk, wv = kv_weight(params["wk"]), kv_weight(params["wv"])
    norms = {}
    if cfg.qk_norm:
        norms = {n: {"scale": dist.tp_param(params[n]["scale"], ctx)}
                 for n in ("q_norm", "k_norm")}
    x = dist.tp_enter(x, ctx)
    B, S, _ = x.shape

    def project(w, heads, norm):
        t = (x @ w).reshape(B, S, heads, hd)
        if norm:
            t = rmsnorm(norms[norm], t, cfg.norm_eps)
        return t

    where = None if kv_cache is None else ring_split(cfg, ctx,
                                                     kv_cache[0].shape[1])
    by_window = where == "window"
    if by_window:                          # every query head, see below
        wq = dist.all_gather(wq, mesh, ax, dim=1)
    q = project(wq, H if by_window else Hq, cfg.qk_norm and "q_norm")
    n_kv = wk.shape[1] // hd
    k = project(wk, n_kv, cfg.qk_norm and "k_norm")
    v = project(wv, n_kv, None)
    if kv_cache is None or by_window:      # the whole-ring op rotates
        q, k = apply_rope(q, angles), apply_rope(k, angles)
    lo = kv0 if own_kv else 0              # the rank's heads within k, v
    if kv_cache is None:
        out = ops.flash_attention(
            q.transpose(1, 2), k[:, :, kv0 - lo:kv1 - lo].transpose(1, 2),
            v[:, :, kv0 - lo:kv1 - lo].transpose(1, 2),
            window=cfg.sliding_window, chunk=min(cfg.attn_chunk, S))
        o = out.transpose(1, 2).reshape(B, S, Hq * hd) @ wo
        return dist.tp_exit(o, ctx), (k, v)
    if by_window:
        out = _decode_window(cfg, q, k, v, kv_cache, cache_pos, ctx)
        out = out[..., r * Hq * hd:(r + 1) * Hq * hd]
    else:                                  # the rank's KV heads, or all
        out = _decode_whole(cfg, q, k, v, angles, kv_cache, cache_pos,
                            (kv0 - lo, kv1 - lo))
    return dist.tp_exit(out @ wo, ctx), kv_cache


def _attention_replicated(params: Params, cfg: ArchConfig, x: torch.Tensor,
                          angles: torch.Tensor, kv_cache, cache_pos, ctx):
    """``multihead_attention`` on this rank under ``head_split``
    "replicated": every rank computes all H query heads and all Hkv KV
    heads (B5 on the card), on the whole weights, as GSPMD computes the
    reference where the rules cut ``wq``/``wk``/``wv``/``wo`` across head
    boundaries (qwen2-vl's 1,536 ``wq`` columns over 16 ranks: 96 columns,
    0.75 of a head, a rank) or leave them whole.

    The collectives, and why each backward is what it is:

    * each weight's ZeRO-3 shard is all-gathered over ``data``
      (``dist.fsdp``; backward a reduce-scatter, since each ``data`` rank
      saw other tokens), then its ``model`` block over ``model`` by
      ``dist.gather_split``, whose backward keeps the rank's own block of
      the gradient and sums nothing: every ``model`` rank runs the same
      computation on the same tokens, so each already holds the whole
      gradient of the gathered weight, and the all-gather's transpose (a
      reduce-scatter) would give tp times it;
    * ``q_norm``/``k_norm`` are used as they are, without ``tp_param``'s
      sum over ``model``, for the same reason;
    * the region is entered and left without a collective: its input is
      the stream every ``model`` rank holds alike and its output is whole
      on every rank, so ``tp_exit``'s all-reduce would sum tp equal copies
      and ``tp_enter``'s backward tp equal gradients. With ``seq_shard``
      the stream's blocks are gathered along the sequence by
      ``gather_split`` (backward: the rank's block of the whole gradient)
      and the output cut back by ``dist.split`` (backward: the blocks'
      gradients gathered).

    Prefill returns every KV head over the whole sequence; ``lm`` writes
    the rank's block of the ring from it. Decode reads the ring as
    ``ring_split`` says ``model`` cut it: along its window
    (``_decode_window``), or not at all (the whole ring on every rank,
    ``_decode_whole``, the local decode); a ring is not cut by heads where
    the heads are replicated (``model`` dividing the KV heads divides the
    query heads in whole groups)."""
    from repro_torch.models import dist
    mesh, ax = ctx.mesh, ctx.tp_axis
    d, H, Hkv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim

    def whole(w, cols, data_dim):
        w = dist.fsdp(w, ctx, d, data_dim)
        tp_dim = 1 - data_dim
        if w.shape[tp_dim] == cols:
            return w
        return dist.gather_split(w, mesh, ax, dim=tp_dim)

    full = {"wq": whole(params["wq"], H * hd, 0),
            "wk": whole(params["wk"], Hkv * hd, 0),
            "wv": whole(params["wv"], Hkv * hd, 0),
            "wo": whole(params["wo"], H * hd, 1)}
    if cfg.qk_norm:
        full.update(q_norm=params["q_norm"], k_norm=params["k_norm"])
    seq = ctx.seq_shard and kv_cache is None
    if seq:
        x = dist.gather_split(x, mesh, ax, dim=1)
    if kv_cache is None or ring_split(cfg, ctx, kv_cache[0].shape[1]) is None:
        with dist.use(None):                   # the local path
            o, kv = multihead_attention(full, cfg, x, angles,
                                        kv_cache=kv_cache,
                                        cache_pos=cache_pos)
        return (dist.split(o, mesh, ax, dim=1) if seq else o), kv
    out = _decode_window(cfg, *_qkv(full, cfg, x, angles), kv_cache,
                         cache_pos, ctx)
    return out @ full["wo"], kv_cache


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


def mlp(params: Params, x: torch.Tensor, *, exact: bool = False
        ) -> torch.Tensor:
    """SwiGLU (or GELU without ``w_gate``). Under a ``dist`` context
    tensor-parallel: ``params`` are this rank's column blocks of
    ``w_gate``/``w_up`` and row block of ``w_down`` (ZeRO-3 shards over
    ``data``, all-gathered here), the region entered and left by
    ``dist.tp_enter``/``tp_exit`` (``exact``: the transpose convention of
    the MoE layer, whose shared expert this is)."""
    from repro_torch.models import dist
    ctx = dist.current()
    if ctx is None:
        return _mlp_local(params, x)
    d = x.shape[-1]
    x = dist.tp_enter(x, ctx, exact=exact)
    params = {k: dist.fsdp(w, ctx, d, 1 if k == "w_down" else 0)
              for k, w in params.items()}
    return dist.tp_exit(_mlp_local(params, x), ctx, exact=exact)


def shared_block_init(gen: Optional[torch.Generator], cfg: ArchConfig, *,
                      lead=(), device=None) -> Params:
    """zamba2's shared block: ``ln1`` over the 2 d-wide concat(h,
    embeddings), attention from it (``num_heads`` of ``head_dim``) back to
    d, ``ln2``, the gated MLP."""
    d = cfg.d_model
    kw = dict(lead=lead, device=device)
    attn = attention_init(gen, cfg, d_in=2 * d, **kw)
    return {"ln1": rmsnorm_init(2 * d, cfg.dtype, **kw), "attn": attn,
            "ln2": rmsnorm_init(d, cfg.dtype, **kw),
            "mlp": mlp_init(gen, cfg, **kw)}


def shared_call_init(gen: Optional[torch.Generator], cfg: ArchConfig, *,
                     lead=(), device=None) -> Params:
    """One call's own weights: the LoRA of ``adapter_rank`` r on the MLP's
    gate and up (``lora_a`` (d, r), ``lora_b`` (r, 2 d_ff): gate's columns,
    then up's) and ``linear`` (d, d), whose output the next Mamba2 layer
    takes as its extra input."""
    d, r = cfg.d_model, cfg.adapter_rank
    kw = dict(lead=lead, device=device)
    return {"linear": dense_init(gen, (d, d), cfg.dtype, **kw),
            "lora_a": dense_init(gen, (d, r), cfg.dtype, **kw),
            "lora_b": dense_init(gen, (r, 2 * cfg.d_ff), cfg.dtype, **kw)}


def shared_block(params: Params, call: Params, cfg: ArchConfig,
                 x: torch.Tensor, emb: torch.Tensor, angles: torch.Tensor, *,
                 kv_cache: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                 cache_pos: Optional[torch.Tensor] = None):
    """One call of zamba2's shared block on the residual stream ``x`` and
    the token embeddings ``emb`` (B, S, d): RMSNorm of concat(x, emb),
    attention (rotary over the whole head, ``cfg.attn_scale``), RMSNorm,
    the gated MLP (GELU, erf, on the gate) with the call's LoRA added to
    its gate and up, and the call's ``linear``. No residual inside.
    Returns (the call's output (B, S, d), the K/V or ring as
    ``multihead_attention`` gives them). Spans: ``shared.attention`` (the
    concat, its norm and the attention), ``shared.mlp`` (the norm and the
    MLP with the LoRA), ``shared.linear``."""
    with spans.span("shared.attention"):
        h = rmsnorm(params["ln1"], torch.cat([x, emb], dim=-1), cfg.norm_eps)
        a, kv = multihead_attention(params["attn"], cfg, h, angles,
                                    kv_cache=kv_cache, cache_pos=cache_pos)
    with spans.span("shared.mlp"):
        h = rmsnorm(params["ln2"], a, cfg.norm_eps)
        m = params["mlp"]
        # gate and up each with its half of the LoRA, added in place: at a
        # prefill pass of 8 x 4,080 one (B, S, d_ff) is 0.94 GB, and the
        # prefill runs beside the cache of the batch before it
        f = m["w_gate"].shape[-1]
        lo = h @ call["lora_a"]
        gate = h @ m["w_gate"]
        gate += lo @ call["lora_b"][:, :f]
        gate = F.gelu(gate)
        up = h @ m["w_up"]
        up += lo @ call["lora_b"][:, f:]
        gate *= up
        del up
        y = gate @ m["w_down"]
    with spans.span("shared.linear"):
        return y @ call["linear"], kv


def _mlp_local(params: Params, x: torch.Tensor) -> torch.Tensor:
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
    does. With a ``dist.current()`` context this is the expert-parallel
    path (``_moe_ffn_sharded``): ``x`` and ``params`` are then this rank's
    block and shares."""
    from repro_torch.models import dist
    ctx = dist.current()
    if ctx is not None:
        return _moe_ffn_sharded(params, cfg, x, ctx)
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


def moe_shard_params(mesh, params: Params) -> Params:
    """This rank's share of one MoE layer's full params for the
    expert-parallel path, cut by ``launch/sharding.param_shardings``:
    router (d, E/tp); w_gate, w_up (E/tp, d/data, f); w_down (E/tp, f,
    d/data); the shared expert by the dense MLP's 2-D rules (the
    reference's ``_looks_expert`` sends it there), run tensor-parallel."""
    from repro_torch.launch import sharding
    return sharding.param_shardings(mesh, {"moe": params})["moe"]


def _moe_ffn_sharded(params: Params, cfg: ArchConfig, x: torch.Tensor,
                     ctx) -> Tuple[torch.Tensor, torch.Tensor]:
    """Expert-parallel MoE on this rank: tokens over the batch and
    ``model`` axes, experts over ``model``, ZeRO-3 expert weights over
    ``data``. ``x`` is this rank's (B_loc, S_loc, d) block
    (``dist.local_tokens``), ``params`` its shares (``moe_shard_params``).

    Route the rank's tokens (the router's (d, E/tp) shards all-gathered
    over ``model``, then the local path's product) -> capacity buffer (E,
    C, d), C from the tokens this rank routes -> all-to-all over ``model``
    (tokens
    travel to their experts' ranks) -> the expert weights all-gathered
    over ``data`` -> expert SwiGLU -> all-to-all back -> weighted combine.
    Token modes, as the reference's: ``seq`` (the block is a sequence
    slice), ``slice`` (each ``model`` rank routes its share of the block
    and the outputs are all-gathered over ``model``), ``dup`` (too few
    tokens to split, as in decode: every ``model`` rank routes them all and
    the load-balance sums skip ``model``). Gradients pass through every
    collective (``dist``'s autograd-aware forms).

    One deviation from the reference, a fault there (ROADMAP C-9): it
    multiplies each ``model`` rank's tokens by that rank's router shard and
    all-gathers the logits, which in ``slice`` and ``seq`` modes joins the
    logits of different tokens (rank r's tokens for its experts beside rank
    r+1's tokens for theirs). The port gathers the router's columns (d x E
    f32, 1 MB a layer at qwen3-moe) and routes each token on its own
    logits, as the local path does."""
    from repro_torch.launch.mesh import axis_rank, axis_size
    from repro_torch.models import dist

    # The reference's 'expert_inner_shard' (Megatron row/col inside each
    # expert, f over 'data') is invalid on this mesh, as it records: 'data'
    # is also the token-shard axis, so the output sum over 'data' would mix
    # different tokens' partial results. ZeRO-3 is the only layout.
    if ctx.expert_inner_shard:
        raise ValueError("expert_inner_shard: sharding the expert FFN's "
                         "inner dim over 'data' mixes tokens on this mesh; "
                         "the expert-parallel MoE takes ZeRO-3 only")
    m = cfg.moe
    mesh, bd, tp = ctx.mesh, ctx.batch_axes, ctx.tp_axis
    tp_n, nb = axis_size(mesh, tp), dist.batch_size(ctx)
    B, S, d = x.shape
    E, K = m.num_experts, m.top_k
    T_loc = B * S
    if ctx.seq_shard:
        sp_mode, T_tp = "seq", T_loc
    elif T_loc % tp_n == 0:
        sp_mode, T_tp = "slice", T_loc // tp_n
    else:
        sp_mode, T_tp = "dup", T_loc    # tiny-token decode: dup work, exact
    C = moe_capacity(m, T_tp)
    E_loc = E // tp_n

    xt = x.reshape(T_loc, d)
    if sp_mode == "slice":
        r = axis_rank(mesh, tp)
        xt = xt[r * T_tp:(r + 1) * T_tp]
    router = dist.all_gather(params["router"], mesh, tp, dim=1)  # (d, E)
    gate, expert, p_sum, c_sum = _route({"router": router}, m, xt)
    T_tot = T_tp * (1 if sp_mode == "dup" else tp_n) * nb
    for a in bd + (() if sp_mode == "dup" else (tp,)):
        p_sum = dist.all_reduce(p_sum, mesh, a)
        c_sum = dist.all_reduce(c_sum, mesh, a)
    aux = E * torch.sum((p_sum / T_tot) * (c_sum / (T_tot * K))) \
        * m.aux_loss_weight

    buf, slot = _fill_buffer(xt, expert, E, C)               # (E, C, d)
    del expert
    recv = dist.all_to_all(buf, mesh, tp)                    # (tp E_loc, C, d)
    del buf
    recv = recv.reshape(tp_n, E_loc, C, d).transpose(0, 1).reshape(
        E_loc, tp_n * C, d)
    wg = dist.all_gather(params["w_gate"], mesh, "data", dim=1)
    wu = dist.all_gather(params["w_up"], mesh, "data", dim=1)
    wd = dist.all_gather(params["w_down"], mesh, "data", dim=2)
    h = _expert_swiglu(recv, wg, wu, wd)                     # (E_loc, tp C, d)
    del recv, wg, wu, wd
    h = h.reshape(E_loc, tp_n, C, d).transpose(0, 1)
    back = dist.all_to_all(h, mesh, tp).reshape(E, C, d)
    del h
    y = _combine(back, slot, gate, T_tp)                     # (T_tp, d)
    del back
    if sp_mode == "slice":
        y = dist.all_gather(y, mesh, tp, dim=0)
    out = y.reshape(B, S, d).to(x.dtype)
    if m.num_shared_experts:
        out = out + mlp(params["shared"], x, exact=True)
    return out, aux

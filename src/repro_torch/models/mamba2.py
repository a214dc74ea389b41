"""Mamba2 (SSD) block on torch — zamba2's backbone mixer (``repro``'s
``models/mamba2.py``).

Fused in-projection -> short causal depthwise conv over (x, B, C) -> SSD
scan -> gated RMSNorm -> out-projection, with the per-head scalar decay
a_t = exp(dt_t * A_h). B and C come in ``ssm.n_groups`` groups (Mamba2's
``ngroups``): the H heads fall into G runs of H / G, head h reading group
h // (H / G), and the gated RMSNorm normalizes each group's d_in / G
channels (its heads') on their own. Prefill runs the scan through
``kernels.ops.ssm_scan`` (kernel B4 on the card) once a group, over its
heads, with that group's B and C broadcast over them and the decay over
the state dimension as stride-0 views, so nothing head-sized is
materialized and B4 keeps its form for q and k shared by every head; each
group's output joins the others' in the model's dtype before the gated
norm and ``out_proj``. Decode runs the one-token recurrence
(``gla.gla_decode_step``) on every head at once.

Parameters are the reference's keys; ``A_log``, ``D`` and ``dt_bias`` are
f32 whatever the config's dtype, as in the reference.

On a ``(data, model)`` mesh (a ``models/dist`` context) a rank computes its
H/tp heads. The rules cut ``in_proj`` and ``out_proj`` over ``data`` only
(ZeRO-3) and leave the rest whole, so the rank gathers them over ``data``
and takes its heads' part of every leaf through ``dist.tp_block`` (its
gradient summed over ``model``): ``in_proj``'s columns of its z and x
channels and its dt, and the B and C columns every head shares (one
group); the conv's weights on those channels; its ``A_log``, ``D``,
``dt_bias`` and norm scale; ``out_proj``'s rows, whose partial products
leave through ``dist.tp_exit``. B4 runs on the rank's heads, q/k still
stride-0 views over them. The gated RMSNorm averages over the whole
d_in, so its f32 sum of squares is summed over ``model``
(``dist.tp_sum``) before the rsqrt. The SSD state is cut on its heads;
the conv carry (W-1 = 3 steps, which the rules do not cut) is whole on
every rank. To write it, a rank all-gathers its x channels over
``model`` for the last W-1 tokens at prefill and for the new token at
each decode step, rather than projecting every x channel itself: that
moves (B, W-1, d_in) values once a layer, where computing them would
take d x d_in more of ``in_proj`` (gathered over ``data`` too) on every
rank.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import ops
from repro_torch.models import dist, gla
from repro_torch.models.blocks import dense_init, rmsnorm, rmsnorm_init
from repro_torch.runtime import spans

Params = Dict[str, torch.Tensor]


def dims(cfg: ArchConfig) -> Tuple[int, int, int, int]:
    """(d_in, heads, state size N, conv channels: x and G groups of B and
    C)."""
    s = cfg.ssm
    d_in = s.expand * cfg.d_model
    nheads = d_in // s.head_dim
    conv_ch = d_in + 2 * s.n_groups * s.state_dim
    return d_in, nheads, s.state_dim, conv_ch


def mamba2_init(gen: Optional[torch.Generator], cfg: ArchConfig, *,
                lead=(), device=None) -> Params:
    """One layer's params, or a ``lead`` stack of them, drawn from ``gen``
    (nothing is drawn on the meta device)."""
    s = cfg.ssm
    d = cfg.d_model
    d_in, H, N, conv_ch = dims(cfg)
    proj_out = d_in + conv_ch + H            # [z, xBC..., dt]
    kw = dict(lead=lead, device=device)
    f32 = torch.float32
    a_log = torch.log(torch.linspace(1.0, 16.0, H, dtype=f32, device=device))
    dt = torch.empty((*lead, H), dtype=f32, device=device)
    if dt.device.type != "meta":             # dt log-uniform in [1e-3, 1e-1]
        dt.uniform_(math.log(1e-3), math.log(1e-1), generator=gen)
    return {
        "in_proj": dense_init(gen, (d, proj_out), cfg.dtype, **kw),
        "conv_w": dense_init(gen, (s.conv_width, conv_ch), cfg.dtype,
                             scale=2.0, **kw),
        "conv_b": torch.zeros((*lead, conv_ch), dtype=cfg.dtype,
                              device=device),
        "A_log": a_log.expand(*lead, H).clone(),
        "D": torch.ones((*lead, H), dtype=f32, device=device),
        "dt_bias": torch.log(torch.expm1(torch.exp(dt))),   # softplus^-1 of dt
        "norm": rmsnorm_init(d_in, cfg.dtype, **kw),
        "out_proj": dense_init(gen, (d_in, d), cfg.dtype,
                               scale=1.0 / (2 * cfg.num_layers) ** 0.5, **kw),
    }


Dims = Tuple[int, int, int, int]


def _split_proj(dm: Dims, proj: torch.Tensor):
    d_in, _, _, conv_ch = dm
    z = proj[..., :d_in]
    xBC = proj[..., d_in: d_in + conv_ch]
    dt = proj[..., d_in + conv_ch:]
    return z, xBC, dt


def _causal_depthwise_conv(xBC: torch.Tensor, w: torch.Tensor,
                           b: torch.Tensor,
                           prev: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """Width-W causal depthwise conv via shifted adds. ``prev``: (B, W-1, C)
    carry for decode continuation."""
    W = w.shape[0]
    if prev is not None:
        xBC = torch.cat([prev.to(xBC.dtype), xBC], dim=1)
    pad = W - 1 if prev is None else 0
    xp = F.pad(xBC, (0, 0, pad, 0))
    S_out = xBC.shape[1] - (0 if prev is None else W - 1)
    out = sum(xp[:, i: i + S_out] * w[i] for i in range(W))
    return out + b


def _ssd_inputs(params: Params, cfg: ArchConfig, dm: Dims,
                xBC: torch.Tensor, dt_raw: torch.Tensor):
    """Conv'd xBC + raw dt -> (q, k, v, log_decay, x_heads, dt) for the GLA
    core; q (C) and k (B) are (..., G N), group g in columns [g N, (g+1) N).
    """
    d_in, H, N, conv_ch = dm
    P = cfg.ssm.head_dim
    GN = (conv_ch - d_in) // 2
    xBC = F.silu(xBC)
    x = xBC[..., :d_in]
    Bm = xBC[..., d_in: d_in + GN]
    Cm = xBC[..., d_in + GN:]
    dt = F.softplus(dt_raw.float() + params["dt_bias"])      # (..., H)
    A = -torch.exp(params["A_log"])                           # (H,)

    # heads: x (..., H, P); B/C shared by the heads of a group
    xh = x.reshape(*x.shape[:-1], H, P)
    v = xh * dt[..., None].to(xh.dtype)
    log_decay = dt * A                                        # (..., H)
    return Cm, Bm, v, log_decay, xh, dt


def _rank_view(params: Params, cfg: ArchConfig, ctx
               ) -> Tuple[Params, Dims, int]:
    """The layer as this rank computes it: (params, dims, x channels of the
    rank). Without a context the layer itself. Under one the rank's H/tp
    heads: the ZeRO-3 projections gathered over ``data``, and of every leaf
    whole over ``model`` its heads' part (``dist.tp_block``, gradients
    summed over ``model``): ``in_proj``'s columns of its z and x channels,
    the shared B and C and its dt, the conv's x channels and B/C, its
    ``A_log``, ``D``, ``dt_bias`` and norm scale, ``out_proj``'s rows."""
    dm = dims(cfg)
    if ctx is None:
        return params, dm, dm[0]
    if cfg.ssm.n_groups != 1:
        raise NotImplementedError(f"{cfg.name}: Mamba2 with "
                                  f"{cfg.ssm.n_groups} B/C groups on a mesh")
    d_in, H, N, _ = dm
    d = cfg.d_model
    tp, r = dist.tp_size(ctx), dist.tp_rank(ctx)
    di, h = d_in // tp, H // tp
    x_r = (d_in + r * di, d_in + (r + 1) * di)
    bc = (2 * d_in, 2 * d_in + 2 * N)
    proj_cols = [(r * di, (r + 1) * di), x_r, bc,
                 (bc[1] + r * h, bc[1] + (r + 1) * h)]
    conv_cols = [(r * di, (r + 1) * di), (d_in, d_in + 2 * N)]
    mine = {
        # the rank's columns first, then the gather over ``data``
        "in_proj": dist.fsdp(dist.tp_block(params["in_proj"], ctx, 1,
                                           proj_cols), ctx, d, 0),
        "conv_w": dist.tp_block(params["conv_w"], ctx, 1, conv_cols),
        "conv_b": dist.tp_block(params["conv_b"], ctx, 0, conv_cols),
        "norm": {"scale": dist.tp_block(params["norm"]["scale"], ctx, 0)},
        "out_proj": dist.fsdp(dist.tp_block(params["out_proj"], ctx, 0),
                              ctx, d, 1),
    }
    for k in ("A_log", "D", "dt_bias"):
        mine[k] = dist.tp_block(params[k], ctx, 0)
    return mine, (di, h, N, di + 2 * N), di


def _gated_norm(params: Params, cfg: ArchConfig, y: torch.Tensor,
                z: torch.Tensor, ctx) -> torch.Tensor:
    """RMSNorm of y * silu(z) over each group's d_in / G channels (with
    one group, the whole d_in). Under a context y and z are the rank's
    channels of one group: the f32 sum of squares is summed over ``model``
    (``dist.tp_sum``) before the rsqrt."""
    g = y * F.silu(z)
    if ctx is None:
        G = cfg.ssm.n_groups
        if G == 1:
            return rmsnorm(params["norm"], g, cfg.norm_eps)
        # a group at a time, so that the f32 temporaries of a prefill span
        # one group's channels
        return torch.cat([
            rmsnorm({"scale": s}, part, cfg.norm_eps) for s, part in
            zip(params["norm"]["scale"].chunk(G), g.chunk(G, dim=-1))],
            dim=-1)
    gf = g.float()
    ss = dist.tp_sum((gf * gf).sum(dim=-1, keepdim=True), ctx)
    out = gf * torch.rsqrt(ss / dims(cfg)[0] + cfg.norm_eps)
    return (out * params["norm"]["scale"].float()).to(g.dtype)


def scan_groups(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                log_decay: torch.Tensor, groups: int):
    """The SSD scan once a group of heads: q (C) and k (B) (B, S, G N),
    v (B, S, H, P), the per-head log decay (B, S, H). Yields, group by
    group, ``ops.ssm_scan``'s (y (B, H/G, S, P) f32, final state
    (B, H/G, N, P) f32) for heads [g H/G, (g+1) H/G), the group's C and B
    broadcast over its heads and the decay over N as stride-0 views: B4's
    form for q and k shared by every head of a launch, and nothing
    head-sized built."""
    Bsz, S, H, _ = v.shape
    N, Hg = q.shape[-1] // groups, H // groups
    for g in range(groups):
        hs, ns = slice(g * Hg, (g + 1) * Hg), slice(g * N, (g + 1) * N)
        qh = q[:, None, :, ns].expand(Bsz, Hg, S, N)
        kh = k[:, None, :, ns].expand(Bsz, Hg, S, N)
        vh = v[:, :, hs].permute(0, 2, 1, 3)                  # (B,Hg,S,P)
        lw = log_decay[:, :, hs].permute(0, 2, 1)[..., None].expand(
            Bsz, Hg, S, N)
        with spans.span("mamba2.scan", g):
            out = ops.ssm_scan(qh, kh, vh, lw)
        yield out


def _per_head(t: torch.Tensor, H: int, groups: int) -> torch.Tensor:
    """(B, G N) B or C of one token -> (B, H, N): group g's for heads
    [g H/G, (g+1) H/G); one group as a stride-0 view."""
    Bsz, N = t.shape[0], t.shape[-1] // groups
    if groups == 1:
        return t[:, None, :].expand(Bsz, H, N)
    return t.view(Bsz, groups, 1, N).expand(
        Bsz, groups, H // groups, N).reshape(Bsz, H, N)


def _whole_carry(xBC_raw: torch.Tensor, di: int, ctx) -> torch.Tensor:
    """Pre-activation conv inputs (.., x channels, B, C) as the whole
    carry's channels: under a context the rank's x channels all-gathered
    over ``model`` (every rank holds the whole carry)."""
    if ctx is None:
        return xBC_raw
    xs = dist.all_gather(xBC_raw[..., :di], ctx.mesh, ctx.tp_axis, dim=-1)
    return torch.cat([xs, xBC_raw[..., di:]], dim=-1)


def mamba2_forward(params: Params, cfg: ArchConfig, x: torch.Tensor, *,
                   want_state: bool = True
                   ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Full-sequence forward. Returns (y, (conv_state, ssd_state)) so
    prefill can hand off to decode; without ``want_state`` the conv carry
    is None (training). Under a ``dist`` context (module docstring) the
    rank's heads: the SSD state is theirs, the conv carry whole."""
    ctx = dist.current()
    if ctx is not None:
        x = dist.tp_enter(x, ctx)
    p, dm, di = _rank_view(params, cfg, ctx)
    B, S, _ = x.shape
    d_in, H, N, _ = dm
    Wc = cfg.ssm.conv_width
    z, xBC_raw, dt_raw = _split_proj(dm, x @ p["in_proj"])
    xBC = _causal_depthwise_conv(xBC_raw, p["conv_w"], p["conv_b"])
    q, k, v, logw, xh, _ = _ssd_inputs(p, cfg, dm, xBC, dt_raw)
    G = cfg.ssm.n_groups
    Hg = H // G
    ys, states = [], []
    for g, (y, st) in enumerate(scan_groups(q, k, v, logw, G)):
        hs = slice(g * Hg, (g + 1) * Hg)
        y = y + p["D"][None, hs, None, None] * xh[:, :, hs].permute(0, 2, 1, 3)
        ys.append(y.permute(0, 2, 1, 3).reshape(B, S, -1).to(x.dtype))
        states.append(st)
    y = ys[0] if G == 1 else torch.cat(ys, dim=-1)
    state = states[0] if G == 1 else torch.cat(states, dim=1)
    with spans.span("mamba2.gated_norm"):
        y = _gated_norm(p, cfg, y, z, ctx)
    y = y @ p["out_proj"]
    if ctx is not None:
        y = dist.tp_exit(y, ctx)
    conv_state = None
    if want_state:
        # pre-activation carry, copied out of the projection it slices
        conv_state = _whole_carry(xBC_raw[:, -(Wc - 1):, :], di, ctx).clone(
            memory_format=torch.contiguous_format)
    return y, (conv_state, state.float())


def mamba2_decode(params: Params, cfg: ArchConfig, x: torch.Tensor,
                  cache: Tuple[torch.Tensor, torch.Tensor]
                  ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Single-token step. x: (B, 1, d); cache = (conv_state, ssd_state).
    Returns new state tensors; ``cache`` is only read. Under a context the
    SSD state is the rank's heads' and the conv carry whole: the rank's
    channels of it feed its conv, and the new token's x channels are
    gathered over ``model`` into the new carry."""
    conv_state, ssd_state = cache
    ctx = dist.current()
    if ctx is not None:
        x = dist.tp_enter(x, ctx)
    p, dm, di = _rank_view(params, cfg, ctx)
    B = x.shape[0]
    d_in, H, N, _ = dm
    z, xBC_raw, dt_raw = _split_proj(dm, x @ p["in_proj"])
    prev = conv_state
    if ctx is not None:
        full_in, r = dims(cfg)[0], dist.tp_rank(ctx)
        prev = torch.cat([conv_state[..., r * di:(r + 1) * di],
                          conv_state[..., full_in:]], dim=-1)
    xBC = _causal_depthwise_conv(xBC_raw, p["conv_w"], p["conv_b"],
                                 prev=prev)
    new_conv = torch.cat([conv_state[:, 1:],
                          _whole_carry(xBC_raw, di, ctx).to(
                              conv_state.dtype)], dim=1)
    q, k, v, logw, xh, _ = _ssd_inputs(p, cfg, dm, xBC, dt_raw)

    G = cfg.ssm.n_groups
    qh, kh = _per_head(q[:, 0], H, G), _per_head(k[:, 0], H, G)
    vh = v[:, 0]                                       # (B,H,P)
    lw = logw[:, 0, :, None].expand(B, H, N)
    y, new_state = gla.gla_decode_step(qh, kh, vh, lw, ssd_state)
    y = y + p["D"][None, :, None] * xh[:, 0]
    y = y.reshape(B, 1, d_in).to(x.dtype)
    y = _gated_norm(p, cfg, y, z, ctx) @ p["out_proj"]
    if ctx is not None:
        y = dist.tp_exit(y, ctx)
    return y, (new_conv, new_state)


def init_cache(cfg: ArchConfig, batch: int, dtype: torch.dtype, *, lead=(),
               device=None, tp: int = 1) -> Tuple[torch.Tensor, torch.Tensor]:
    """Zero (conv_state (.., B, W-1, C) in ``dtype``, ssd_state
    (.., B, H, N, P) f32), with ``lead`` stacked layers in front; ``tp``:
    a rank's block on a model axis of that size (its H/tp heads of the SSD
    state, the conv carry whole)."""
    d_in, H, N, conv_ch = dims(cfg)
    P = cfg.ssm.head_dim
    return (torch.zeros((*lead, batch, cfg.ssm.conv_width - 1, conv_ch),
                        dtype=dtype, device=device),
            torch.zeros((*lead, batch, H // tp, N, P), dtype=torch.float32,
                        device=device))

"""Mamba2 (SSD) block on torch — zamba2's backbone mixer (``repro``'s
``models/mamba2.py``).

Fused in-projection -> short causal depthwise conv over (x, B, C) -> SSD
scan -> gated RMSNorm -> out-projection, with the per-head scalar decay
a_t = exp(dt_t * A_h). Prefill runs the scan through ``kernels.ops.ssm_scan``
(kernel B4 on the card) with B and C broadcast over heads and the decay
over the state dimension as stride-0 views, so nothing head-sized is
materialized; decode runs the one-token recurrence
(``gla.gla_decode_step``).

Parameters are the reference's keys; ``A_log``, ``D`` and ``dt_bias`` are
f32 whatever the config's dtype, as in the reference.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import ops
from repro_torch.models import gla
from repro_torch.models.blocks import dense_init, rmsnorm, rmsnorm_init

Params = Dict[str, torch.Tensor]


def dims(cfg: ArchConfig) -> Tuple[int, int, int, int]:
    s = cfg.ssm
    d_in = s.expand * cfg.d_model
    nheads = d_in // s.head_dim
    conv_ch = d_in + 2 * s.state_dim
    return d_in, nheads, s.state_dim, conv_ch


def mamba2_init(gen: Optional[torch.Generator], cfg: ArchConfig, *,
                lead=(), device=None) -> Params:
    """One layer's params, or a ``lead`` stack of them, drawn from ``gen``
    (nothing is drawn on the meta device)."""
    s = cfg.ssm
    d = cfg.d_model
    d_in, H, N, conv_ch = dims(cfg)
    proj_out = 2 * d_in + 2 * N + H          # [z, xBC..., dt]
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


def _split_proj(cfg: ArchConfig, proj: torch.Tensor):
    d_in, H, N, _ = dims(cfg)
    z = proj[..., :d_in]
    xBC = proj[..., d_in: 2 * d_in + 2 * N]
    dt = proj[..., 2 * d_in + 2 * N:]
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


def _ssd_inputs(params: Params, cfg: ArchConfig, xBC: torch.Tensor,
                dt_raw: torch.Tensor):
    """Conv'd xBC + raw dt -> (q, k, v, log_decay, x_heads, dt) for the GLA
    core."""
    d_in, H, N, _ = dims(cfg)
    P = cfg.ssm.head_dim
    xBC = F.silu(xBC)
    x = xBC[..., :d_in]
    Bm = xBC[..., d_in: d_in + N]
    Cm = xBC[..., d_in + N:]
    dt = F.softplus(dt_raw.float() + params["dt_bias"])      # (..., H)
    A = -torch.exp(params["A_log"])                           # (H,)

    # heads: x (..., H, P); B/C shared across heads (n_groups=1)
    xh = x.reshape(*x.shape[:-1], H, P)
    v = xh * dt[..., None].to(xh.dtype)
    log_decay = dt * A                                        # (..., H)
    return Cm, Bm, v, log_decay, xh, dt


def mamba2_forward(params: Params, cfg: ArchConfig, x: torch.Tensor
                   ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Full-sequence forward. Returns (y, (conv_state, ssd_state)) so
    prefill can hand off to decode."""
    B, S, _ = x.shape
    d_in, H, N, _ = dims(cfg)
    Wc = cfg.ssm.conv_width
    z, xBC_raw, dt_raw = _split_proj(cfg, x @ params["in_proj"])
    xBC = _causal_depthwise_conv(xBC_raw, params["conv_w"], params["conv_b"])
    q, k, v, logw, xh, _ = _ssd_inputs(params, cfg, xBC, dt_raw)

    # GLA layout (B, H, S, D*) as views: B/C and the decay stride 0
    qh = q[:, None].expand(B, H, S, N)
    kh = k[:, None].expand(B, H, S, N)
    vh = v.permute(0, 2, 1, 3)                         # (B,H,S,P)
    lw = logw.permute(0, 2, 1)[..., None].expand(B, H, S, N)
    y, state = ops.ssm_scan(qh, kh, vh, lw)
    y = y + params["D"][None, :, None, None] * xh.permute(0, 2, 1, 3)  # D*x skip
    y = y.permute(0, 2, 1, 3).reshape(B, S, d_in).to(x.dtype)

    y = rmsnorm(params["norm"], y * F.silu(z), cfg.norm_eps)
    # pre-activation carry, copied out of the projection it slices
    conv_state = xBC_raw[:, -(Wc - 1):, :].clone(
        memory_format=torch.contiguous_format)
    return y @ params["out_proj"], (conv_state, state.float())


def mamba2_decode(params: Params, cfg: ArchConfig, x: torch.Tensor,
                  cache: Tuple[torch.Tensor, torch.Tensor]
                  ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Single-token step. x: (B, 1, d); cache = (conv_state, ssd_state).
    Returns new state tensors; ``cache`` is only read."""
    conv_state, ssd_state = cache
    B = x.shape[0]
    d_in, H, N, _ = dims(cfg)
    z, xBC_raw, dt_raw = _split_proj(cfg, x @ params["in_proj"])
    xBC = _causal_depthwise_conv(xBC_raw, params["conv_w"], params["conv_b"],
                                 prev=conv_state)
    new_conv = torch.cat([conv_state[:, 1:], xBC_raw], dim=1)
    q, k, v, logw, xh, _ = _ssd_inputs(params, cfg, xBC, dt_raw)

    qh = q[:, 0, None, :].expand(B, H, N)
    kh = k[:, 0, None, :].expand(B, H, N)
    vh = v[:, 0]                                       # (B,H,P)
    lw = logw[:, 0, :, None].expand(B, H, N)
    y, new_state = gla.gla_decode_step(qh, kh, vh, lw, ssd_state)
    y = y + params["D"][None, :, None] * xh[:, 0]
    y = y.reshape(B, 1, d_in).to(x.dtype)
    y = rmsnorm(params["norm"], y * F.silu(z), cfg.norm_eps)
    return y @ params["out_proj"], (new_conv, new_state)


def init_cache(cfg: ArchConfig, batch: int, dtype: torch.dtype, *, lead=(),
               device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Zero (conv_state (.., B, W-1, C) in ``dtype``, ssd_state
    (.., B, H, N, P) f32), with ``lead`` stacked layers in front."""
    d_in, H, N, conv_ch = dims(cfg)
    P = cfg.ssm.head_dim
    return (torch.zeros((*lead, batch, cfg.ssm.conv_width - 1, conv_ch),
                        dtype=dtype, device=device),
            torch.zeros((*lead, batch, H, N, P), dtype=torch.float32,
                        device=device))

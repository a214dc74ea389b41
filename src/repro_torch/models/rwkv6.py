"""RWKV6 ("Finch") block on torch — attention-free mixer with
data-dependent decay (``repro``'s ``models/rwkv6.py``).

Per layer: time-mix (token-shift DDLerp -> r/k/v/g projections, LoRA
data-dependent per-channel decay, WKV outer-product recurrence with bonus
``u``, per-head norm, gate, out-proj) then channel-mix (token-shift
squared-ReLU FFN with receptance gate). Prefill runs the WKV recurrence
through ``kernels.ops.ssm_scan`` in RWKV semantics (kernel B4 on the
card); decode runs the one-token recurrence (``gla.gla_decode_step``).

Parameters are the reference's keys; ``decay_base`` and ``faaaa`` are f32
whatever the config's dtype, as in the reference.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import ops
from repro_torch.models import gla
from repro_torch.models.blocks import dense_init, rmsnorm, rmsnorm_init

Params = Dict[str, torch.Tensor]


def _hdims(cfg: ArchConfig) -> Tuple[int, int]:
    P = cfg.ssm.head_dim
    return cfg.d_model // P, P


def rwkv6_init(gen: Optional[torch.Generator], cfg: ArchConfig, *,
               lead=(), device=None) -> Params:
    """One layer's params, or a ``lead`` stack of them, drawn from ``gen``."""
    d, f = cfg.d_model, cfg.d_ff
    H, P = _hdims(cfg)
    r = cfg.ssm.decay_lora
    kw = dict(lead=lead, device=device)
    out_scale = 1.0 / (2 * cfg.num_layers) ** 0.5

    def zeros(*shape, dtype=cfg.dtype):
        return torch.zeros((*lead, *shape), dtype=dtype, device=device)

    decay = -6.0 + 5.0 * (torch.arange(d, dtype=torch.float32, device=device)
                          / max(1, d - 1)) ** 0.7   # per-channel, in (-6,-1)
    return {
        # --- time-mix ---------------------------------------------------------
        "maa_x": zeros(d),
        "maa_base": zeros(5, d),
        "maa_w1": dense_init(gen, (d, 5 * r), cfg.dtype, **kw),
        "maa_w2": dense_init(gen, (5, r, d), cfg.dtype, **kw),
        "decay_base": decay.expand(*lead, d).clone(),
        "decay_w1": dense_init(gen, (d, r), cfg.dtype, **kw),
        "decay_w2": dense_init(gen, (r, d), cfg.dtype, **kw),
        "faaaa": zeros(H, P, dtype=torch.float32),        # bonus 'u'
        "wr": dense_init(gen, (d, d), cfg.dtype, **kw),
        "wk": dense_init(gen, (d, d), cfg.dtype, **kw),
        "wv": dense_init(gen, (d, d), cfg.dtype, **kw),
        "wg": dense_init(gen, (d, d), cfg.dtype, **kw),
        "wo": dense_init(gen, (d, d), cfg.dtype, scale=out_scale, **kw),
        "ln_x": rmsnorm_init(d, cfg.dtype, **kw),         # per-head norm scale
        # --- channel-mix ------------------------------------------------------
        "cm_maa_k": zeros(d),
        "cm_maa_r": zeros(d),
        "cm_wk": dense_init(gen, (d, f), cfg.dtype, **kw),
        "cm_wv": dense_init(gen, (f, d), cfg.dtype, scale=out_scale, **kw),
        "cm_wr": dense_init(gen, (d, d), cfg.dtype, **kw),
        # --- layer norms ------------------------------------------------------
        "ln1": rmsnorm_init(d, cfg.dtype, **kw),
        "ln2": rmsnorm_init(d, cfg.dtype, **kw),
    }


def _shift(x: torch.Tensor, prev: Optional[torch.Tensor]) -> torch.Tensor:
    """Token shift: value of the previous position. prev: (B, d) carry."""
    if x.shape[1] == 1 and prev is not None:
        return prev[:, None, :]
    shifted = F.pad(x[:, :-1], (0, 0, 1, 0))
    if prev is not None:
        shifted[:, 0] = prev.to(x.dtype)
    return shifted


def _ddlerp(p: Params, x: torch.Tensor, xs: torch.Tensor):
    """Data-dependent interpolation of the five r/k/v/g/w input streams."""
    dx = xs - x
    base = x + dx * p["maa_x"]
    lora = torch.tanh(base @ p["maa_w1"])                   # (B,S,5r)
    B, S, _ = x.shape
    lora = lora.reshape(B, S, 5, -1).permute(2, 0, 1, 3)    # (5,B,S,r)
    mix = (torch.einsum("nbsr,nrd->nbsd", lora, p["maa_w2"])
           + p["maa_base"][:, None, None])
    return tuple(x + dx * mix[i] for i in range(5))         # order: w,k,v,r,g


def _wkv_inputs(p: Params, cfg: ArchConfig, x: torch.Tensor,
                shift_prev: Optional[torch.Tensor]):
    H, P = _hdims(cfg)
    B, S, d = x.shape
    xs = _shift(x, shift_prev)
    xw, xk, xv, xr, xg = _ddlerp(p, x, xs)
    r = (xr @ p["wr"]).reshape(B, S, H, P).permute(0, 2, 1, 3)
    k = (xk @ p["wk"]).reshape(B, S, H, P).permute(0, 2, 1, 3)
    v = (xv @ p["wv"]).reshape(B, S, H, P).permute(0, 2, 1, 3)
    g = F.silu(xg @ p["wg"])
    logw = -torch.exp(p["decay_base"]
                      + (torch.tanh(xw @ p["decay_w1"])
                         @ p["decay_w2"]).float())
    logw = logw.reshape(B, S, H, P).permute(0, 2, 1, 3)     # (B,H,S,P)
    return r, k, v, g, logw, x[:, -1, :].clone()


def _time_mix_out(p: Params, cfg: ArchConfig, y: torch.Tensor,
                  g: torch.Tensor, B: int, S: int) -> torch.Tensor:
    """Per-head normalization, gate, output projection. y: (B,H,S,P)."""
    H, P = _hdims(cfg)
    d = H * P
    y = y.permute(0, 2, 1, 3).float()                        # (B,S,H,P)
    mean2 = (y * y).mean(dim=-1, keepdim=True)               # per-head RMS
    y = (y * torch.rsqrt(mean2 + 64e-5)).reshape(B, S, d)
    y = (y * p["ln_x"]["scale"].float()).to(g.dtype) * g
    return y @ p["wo"]


def _channel_mix(p: Params, x: torch.Tensor,
                 shift_prev: Optional[torch.Tensor]):
    xs = _shift(x, shift_prev)
    dx = xs - x
    xk = x + dx * p["cm_maa_k"]
    xr = x + dx * p["cm_maa_r"]
    h = torch.square(F.relu(xk @ p["cm_wk"]))
    return (torch.sigmoid(xr @ p["cm_wr"]) * (h @ p["cm_wv"]),
            x[:, -1, :].clone())


RwkvCache = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]   # (shift_tm, shift_cm, state)


def rwkv6_block(params: Params, cfg: ArchConfig, x: torch.Tensor,
                cache: Optional[RwkvCache] = None
                ) -> Tuple[torch.Tensor, RwkvCache]:
    """Full RWKV6 layer (time-mix + channel-mix residual branches).

    Prefill: cache=None (or a carry when continuing). Decode: x is
    (B, 1, d) and cache is the (shift_tm, shift_cm, wkv_state) triple,
    only read; the new triple is returned."""
    B, S, d = x.shape
    st_tm, st_cm, wkv = cache if cache is not None else (None, None, None)

    xn = rmsnorm(params["ln1"], x, cfg.norm_eps)
    r, k, v, g, logw, last_tm = _wkv_inputs(params, cfg, xn, st_tm)
    if S == 1 and wkv is not None:
        y, new_wkv = gla.gla_decode_step(
            r[:, :, 0], k[:, :, 0], v[:, :, 0], logw[:, :, 0], wkv,
            bonus=params["faaaa"])
        y = y[:, :, None, :]                                 # (B,H,1,P)
    else:
        y, new_wkv = ops.ssm_scan(r, k, v, logw, bonus=params["faaaa"],
                                  initial_state=wkv)
    x = x + _time_mix_out(params, cfg, y, g, B, S)

    xn2 = rmsnorm(params["ln2"], x, cfg.norm_eps)
    cm_out, last_cm = _channel_mix(params, xn2, st_cm)
    x = x + cm_out
    return x, (last_tm, last_cm, new_wkv)


def init_cache(cfg: ArchConfig, batch: int, dtype: torch.dtype, *, lead=(),
               device=None) -> RwkvCache:
    """Zero (shift_tm (.., B, d), shift_cm (.., B, d) in ``dtype``, wkv
    state (.., B, H, P, P) f32), with ``lead`` stacked layers in front."""
    H, P = _hdims(cfg)
    d = cfg.d_model
    return (torch.zeros((*lead, batch, d), dtype=dtype, device=device),
            torch.zeros((*lead, batch, d), dtype=dtype, device=device),
            torch.zeros((*lead, batch, H, P, P), dtype=torch.float32,
                        device=device))

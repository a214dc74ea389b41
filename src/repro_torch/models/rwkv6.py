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

On a ``(data, model)`` mesh (a ``models/dist`` context) a rank computes its
H/tp wkv heads, in Megatron's form. The layer norms, token shift, DDLerp
(``maa_*``) and the decay LoRA's first product work on the whole d and
are computed alike on every rank: the time-mix region is entered after
``ln1`` (``dist.tp_enter``), and the leaves of that replicated part
(``maa_*``, ``decay_w1``) enter through ``dist.tp_param``, as each rank's
use of them reaches only its heads. ``wr``/``wk``/``wv``/``wg`` are cut
over ``model`` by the rules and give the rank's heads; ``decay_w2``'s
columns, ``decay_base``, ``faaaa`` and ``ln_x`` are taken for them
(``dist.tp_block``); B4 runs with the bonus on the rank's heads, the
per-head norm is local, and ``wo``'s rows leave through
``dist.tp_exit``. In the channel-mix ``cm_wk``/``cm_wv`` are a Megatron
pair entered at their input. ``cm_wr`` is cut over ``model`` and would
give the receptance on the rank's d/tp channels only, while the gate
multiplies the FFN's whole output: the port all-gathers ``cm_wr``'s
columns (a d x d weight; gathering the (B, S, d) receptance instead
moves more at the prefill and training lengths) and computes the whole
receptance on every rank, outside the region, with the mixes. Every
ZeRO-3 leaf is gathered over ``data`` before use. The rules cut the shift
carries (B, d) along d and the wkv state along its heads: prefill keeps
the rank's d-slice of the last position, and decode all-gathers the two
carries over ``model`` before the shift.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import ops
from repro_torch.models import dist, gla
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


def _rank_view(p: Params, cfg: ArchConfig, ctx) -> Tuple[Params, int]:
    """The layer as this rank computes it: (params, its wkv heads). Without
    a context the layer itself. Under one (module docstring) the ZeRO-3
    leaves gathered over ``data``; the time-mix's replicated region
    (``maa_*``, ``decay_w1``) through ``dist.tp_param``, and
    ``decay_w2``'s columns, ``decay_base``, ``faaaa`` and ``ln_x`` for the
    rank's heads through ``dist.tp_block`` (gradients summed over
    ``model``); ``wr``/``wk``/``wv``/``wg``/``cm_wk`` are the rank's
    columns and ``wo``/``cm_wv`` its rows already; ``cm_wr``'s columns are
    all-gathered over ``model`` (``dist.gather_split``)."""
    H, _ = _hdims(cfg)
    if ctx is None:
        return p, H
    d = cfg.d_model
    mine = dict(p)
    for k in ("maa_x", "maa_base", "maa_w1", "maa_w2", "decay_w1"):
        mine[k] = dist.tp_param(p[k], ctx)
    for k in ("maa_w1", "decay_w1", "wr", "wk", "wv", "wg", "cm_wk",
              "cm_wr"):
        mine[k] = dist.fsdp(mine[k], ctx, d, 0)
    for k in ("wo", "cm_wv"):
        mine[k] = dist.fsdp(p[k], ctx, d, 1)
    mine["decay_w2"] = dist.tp_block(p["decay_w2"], ctx, 1)
    mine["decay_base"] = dist.tp_block(p["decay_base"], ctx, 0)
    mine["faaaa"] = dist.tp_block(p["faaaa"], ctx, 0)
    mine["ln_x"] = {"scale": dist.tp_block(p["ln_x"]["scale"], ctx, 0)}
    mine["cm_wr"] = dist.gather_split(mine["cm_wr"], ctx.mesh, ctx.tp_axis,
                                      dim=1)
    return mine, H // dist.tp_size(ctx)


def _wkv_inputs(p: Params, cfg: ArchConfig, H: int, x: torch.Tensor,
                shift_prev: Optional[torch.Tensor]):
    P = cfg.ssm.head_dim
    B, S, _ = x.shape
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
    return r, k, v, g, logw


def _time_mix_out(p: Params, cfg: ArchConfig, y: torch.Tensor,
                  g: torch.Tensor, B: int, S: int) -> torch.Tensor:
    """Per-head normalization, gate, output projection. y: (B,H,S,P), the
    rank's heads under a context (the norm is per head, so local)."""
    H, P = y.shape[1], cfg.ssm.head_dim
    y = y.permute(0, 2, 1, 3).float()                        # (B,S,H,P)
    mean2 = (y * y).mean(dim=-1, keepdim=True)               # per-head RMS
    y = (y * torch.rsqrt(mean2 + 64e-5)).reshape(B, S, H * P)
    y = (y * p["ln_x"]["scale"].float()).to(g.dtype) * g
    return y @ p["wo"]


def _channel_mix(p: Params, x: torch.Tensor,
                 shift_prev: Optional[torch.Tensor], ctx):
    """Squared-ReLU FFN gated by the receptance. Under a context the FFN
    is a Megatron region entered at its input ``xk`` (``cm_wk`` columns,
    ``cm_wv`` rows, partial sums left through ``dist.tp_exit``) and the
    shift, the mixes and the receptance (``cm_wr`` gathered whole) stay
    replicated, as the gate multiplies the FFN's whole output."""
    xs = _shift(x, shift_prev)
    dx = xs - x
    xk = x + dx * p["cm_maa_k"]
    xr = x + dx * p["cm_maa_r"]
    if ctx is not None:
        xk = dist.tp_enter(xk, ctx)
    kv = torch.square(F.relu(xk @ p["cm_wk"])) @ p["cm_wv"]
    if ctx is not None:
        kv = dist.tp_exit(kv, ctx)
    return torch.sigmoid(xr @ p["cm_wr"]) * kv


def _last(x: torch.Tensor, ctx) -> torch.Tensor:
    """The last position's (B, d) shift carry; under a context the rank's
    d/tp slice of it (the rules cut the carries along d)."""
    last = x[:, -1, :]
    if ctx is not None:
        dl, r = last.shape[-1] // dist.tp_size(ctx), dist.tp_rank(ctx)
        last = last[:, r * dl:(r + 1) * dl]
    return last.clone()


def _whole(carry: Optional[torch.Tensor], ctx) -> Optional[torch.Tensor]:
    """A shift carry as ``_shift`` reads it: under a context the ranks'
    d-slices all-gathered over ``model``."""
    if carry is None or ctx is None:
        return carry
    return dist.all_gather(carry, ctx.mesh, ctx.tp_axis, dim=-1)


RwkvCache = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]   # (shift_tm, shift_cm, state)


def rwkv6_block(params: Params, cfg: ArchConfig, x: torch.Tensor,
                cache: Optional[RwkvCache] = None
                ) -> Tuple[torch.Tensor, RwkvCache]:
    """Full RWKV6 layer (time-mix + channel-mix residual branches).

    Prefill: cache=None (or a carry when continuing). Decode: x is
    (B, 1, d) and cache is the (shift_tm, shift_cm, wkv_state) triple,
    only read; the new triple is returned. Under a ``dist`` context the
    cache is the rank's block of it (module docstring)."""
    ctx = dist.current()
    B, S, d = x.shape
    st_tm, st_cm, wkv = cache if cache is not None else (None, None, None)
    p, H = _rank_view(params, cfg, ctx)

    xn = rmsnorm(params["ln1"], x, cfg.norm_eps)
    last_tm = _last(xn, ctx)
    if ctx is not None:
        xn = dist.tp_enter(xn, ctx)
    r, k, v, g, logw = _wkv_inputs(p, cfg, H, xn, _whole(st_tm, ctx))
    if S == 1 and wkv is not None:
        y, new_wkv = gla.gla_decode_step(
            r[:, :, 0], k[:, :, 0], v[:, :, 0], logw[:, :, 0], wkv,
            bonus=p["faaaa"])
        y = y[:, :, None, :]                                 # (B,H,1,P)
    else:
        y, new_wkv = ops.ssm_scan(r, k, v, logw, bonus=p["faaaa"],
                                  initial_state=wkv)
    tm = _time_mix_out(p, cfg, y, g, B, S)
    if ctx is not None:
        tm = dist.tp_exit(tm, ctx)
    x = x + tm

    xn2 = rmsnorm(params["ln2"], x, cfg.norm_eps)
    x = x + _channel_mix(p, xn2, _whole(st_cm, ctx), ctx)
    return x, (last_tm, _last(xn2, ctx), new_wkv)


def init_cache(cfg: ArchConfig, batch: int, dtype: torch.dtype, *, lead=(),
               device=None, tp: int = 1) -> RwkvCache:
    """Zero (shift_tm (.., B, d), shift_cm (.., B, d) in ``dtype``, wkv
    state (.., B, H, P, P) f32), with ``lead`` stacked layers in front;
    ``tp``: a rank's block on a model axis of that size (d/tp of each
    carry, H/tp heads of the state)."""
    H, P = _hdims(cfg)
    d = cfg.d_model // tp
    return (torch.zeros((*lead, batch, d), dtype=dtype, device=device),
            torch.zeros((*lead, batch, d), dtype=dtype, device=device),
            torch.zeros((*lead, batch, H // tp, P, P), dtype=torch.float32,
                        device=device))

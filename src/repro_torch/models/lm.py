"""Language model on torch: embedding -> layer stack -> head
(``repro``'s ``models/lm.py``), for the ``uniform`` wiring of attention
layers.

Params are the reference's nested dict with its keys, every layer stacked
on dim 0 of ``params["blocks"]``; the stack is walked with a Python loop
over layer views (the reference scans it). Pre-copy walks this tree, and
weights carried across from the JAX package need no renaming
(``models/convert.py``).

The decode cache is ``{"pos": int32 0-dim, kind: {"k", "v"}}`` with
(L, B, W, Hkv, hd) rings, W = min(cache_len, sliding_window) under SWA.
``decode_step`` writes the new token's K/V into the rings in place and
returns a cache dict holding the same ring tensors and a new ``pos``.

Not ported yet: the ``hybrid_shared`` (zamba2) and ``prefix_dense``
(kimi-k2) wirings and the ``mamba``/``rwkv``/``moe`` kinds (slice 4), and
``lm_loss`` with training (slice 3); each raises ``NotImplementedError``.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from repro_torch import tree
from repro_torch.configs.base import ArchConfig
from repro_torch.kernels.backend import DeviceLike, resolve_device
from repro_torch.models import blocks as B

Params = Dict[str, Any]
Batch = Dict[str, torch.Tensor]


# ---------------------------------------------------------------------------
# wiring
# ---------------------------------------------------------------------------
def wiring_mode(cfg: ArchConfig) -> str:
    if "shared_attn" in cfg.block_pattern:
        return "hybrid_shared"
    if cfg.first_k_dense > 0:
        return "prefix_dense"
    assert len(set(cfg.block_pattern)) == 1, cfg.block_pattern
    return "uniform"


def _require_ported(cfg: ArchConfig) -> str:
    """The layer kind of a config this slice runs, else raise."""
    mode = wiring_mode(cfg)
    if mode != "uniform":
        raise NotImplementedError(
            f"{cfg.name}: the {mode!r} wiring is ported in slice 4 of the "
            f"port (ROADMAP Queue A)")
    kind = cfg.block_pattern[0]
    if kind != "attn":
        raise NotImplementedError(
            f"{cfg.name}: {kind!r} layers are ported in slice 4 of the port "
            f"(ROADMAP Queue A)")
    return kind


# ---------------------------------------------------------------------------
# model init
# ---------------------------------------------------------------------------
def _attn_block_init(gen, cfg: ArchConfig, *, lead=(), device=None) -> Params:
    kw = dict(lead=lead, device=device)
    return {
        "ln1": B.rmsnorm_init(cfg.d_model, cfg.dtype, **kw),
        "attn": B.attention_init(gen, cfg, **kw),
        "ln2": B.rmsnorm_init(cfg.d_model, cfg.dtype, **kw),
        "mlp": B.mlp_init(gen, cfg, **kw),
    }


def init_params(cfg: ArchConfig, seed: int = 0, *,
                device: DeviceLike = None) -> Params:
    """Random weights from ``torch.Generator(device).manual_seed(seed)``,
    drawn on ``device`` (``None`` is the card; ``"meta"`` gives shapes and
    dtypes only). They are not the JAX package's numbers for the same seed:
    to run its weights, use ``models.convert.params_from_numpy``."""
    _require_ported(cfg)
    if device is not None and torch.device(device).type == "meta":
        dev, gen = torch.device("meta"), None
    else:
        dev = resolve_device(device)
        gen = torch.Generator(device=dev).manual_seed(seed)
    embed = torch.empty((cfg.vocab_size, cfg.d_model), dtype=torch.float32,
                        device=dev)
    if dev.type != "meta":
        embed.normal_(generator=gen).mul_(cfg.d_model ** -0.5)
    p: Params = {
        "embed": embed.to(cfg.dtype),
        "final_ln": B.rmsnorm_init(cfg.d_model, cfg.dtype, device=dev),
    }
    if not cfg.tie_embeddings:
        p["head"] = B.dense_init(gen, (cfg.d_model, cfg.vocab_size),
                                 cfg.dtype, device=dev)
    p["blocks"] = _attn_block_init(gen, cfg, lead=(cfg.num_layers,),
                                   device=dev)
    return p


# ---------------------------------------------------------------------------
# embedding / positions / head
# ---------------------------------------------------------------------------
def _positions(cfg: ArchConfig, batch: Batch, Bsz: int, S: int,
               offset=0) -> torch.Tensor:
    if "positions" in batch:
        return batch["positions"]
    device = batch["tokens"].device
    pos = (torch.arange(S, device=device)[None, :] + offset).expand(Bsz, S)
    if cfg.mrope:
        return pos[None].expand(3, Bsz, S)       # stub: t=h=w stream
    return pos


def _embed(cfg: ArchConfig, params: Params, batch: Batch) -> torch.Tensor:
    x = params["embed"][batch["tokens"].long()]
    if cfg.frontend_prefix and "prefix_embeds" in batch:
        pe = batch["prefix_embeds"].to(x.dtype)   # (B, P, d) stub frontend
        x = x.clone()
        x[:, : pe.shape[1]] = pe
    return x


def _head(cfg: ArchConfig, params: Params, x: torch.Tensor) -> torch.Tensor:
    x = B.rmsnorm(params["final_ln"], x, cfg.norm_eps)
    w = params["embed"].T if cfg.tie_embeddings else params["head"]
    return x @ w


def _layer(stack: Params, i: int) -> Params:
    return tree.map(lambda a: a[i], stack)


def apply_block(kind: str, params: Params, cfg: ArchConfig, x: torch.Tensor,
                angles: torch.Tensor, cache, cache_pos):
    """Attention + MLP block. Returns (x, (k, v)): the layer's prefill K/V,
    or with ``cache`` its ring tensors after the in-place write."""
    h, new_kv = B.multihead_attention(
        params["attn"], cfg, B.rmsnorm(params["ln1"], x, cfg.norm_eps),
        angles, kv_cache=cache, cache_pos=cache_pos)
    x = x + h
    x = x + B.mlp(params["mlp"], B.rmsnorm(params["ln2"], x, cfg.norm_eps))
    return x, new_kv


# ---------------------------------------------------------------------------
# forward (prefill)
# ---------------------------------------------------------------------------
def _ring_src(S: int, W: int, device) -> Optional[torch.Tensor]:
    """Prefill position held by each ring slot when S > W (the last W
    tokens, token t at slot t % W); None when the prompt fits."""
    if S <= W:
        return None
    s_idx = torch.arange(W, device=device)
    return S - 1 - torch.remainder(S - 1 - s_idx, W)


def _kv_window(cfg: ArchConfig, cache_len: int) -> int:
    return (min(cache_len, cfg.sliding_window) if cfg.sliding_window > 0
            else cache_len)


@torch.no_grad()
def forward(params: Params, cfg: ArchConfig, batch: Batch, *,
            want_cache: bool = False, cache_len: int = 0):
    """Full-sequence forward. Returns (hidden, aux_loss, cache-or-None).

    ``want_cache`` (prefill): also build the decode cache with capacity
    ``cache_len`` (>= S; SWA archs use min(cache_len, window)), each layer's
    K/V written into its ring as the layer runs."""
    kind = _require_ported(cfg)
    Bsz, S = batch["tokens"].shape
    x = _embed(cfg, params, batch)
    angles = B.rope_angles(cfg, _positions(cfg, batch, Bsz, S))
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    cache = None
    if want_cache:
        W = _kv_window(cfg, cache_len)
        cache = init_cache(cfg, Bsz, cache_len, device=x.device)
        cache["pos"].fill_(S)
        src = _ring_src(S, W, x.device)
        rings = cache[kind]
    for i in range(cfg.num_layers):
        x, (k, v) = apply_block(kind, _layer(params["blocks"], i), cfg, x,
                                angles, None, None)
        if want_cache:
            for name, t in (("k", k), ("v", v)):
                if src is None:
                    rings[name][i, :, :S] = t
                else:
                    rings[name][i] = t.index_select(1, src)
    return x, aux_total, cache


# ---------------------------------------------------------------------------
# decode (one token)
# ---------------------------------------------------------------------------
@torch.no_grad()
def decode_step(params: Params, cfg: ArchConfig, token: torch.Tensor,
                cache: Dict[str, Any]):
    """token: (B, 1) int32. Returns (logits (B, V), new_cache); the rings of
    ``cache`` are updated in place and shared by ``new_cache``."""
    kind = _require_ported(cfg)
    Bsz = token.shape[0]
    pos = cache["pos"]
    x = params["embed"][token.long()]
    positions = pos.reshape(1, 1).expand(Bsz, 1)
    if cfg.mrope:
        positions = positions[None].expand(3, Bsz, 1)
    angles = B.rope_angles(cfg, positions)
    rings = cache[kind]
    for i in range(cfg.num_layers):
        x, _ = apply_block(kind, _layer(params["blocks"], i), cfg, x, angles,
                           (rings["k"][i], rings["v"][i]), pos)
    logits = _head(cfg, params, x)[:, 0]                  # (B, V)
    return logits, {"pos": pos + 1, kind: rings}


# ---------------------------------------------------------------------------
# cache init
# ---------------------------------------------------------------------------
def init_cache(cfg: ArchConfig, batch: int, cache_len: int, *,
               device: DeviceLike = None) -> Dict[str, Any]:
    """Empty decode cache at position 0: zero (L, B, W, Hkv, hd) rings."""
    kind = _require_ported(cfg)
    dev = resolve_device(device)
    shape = (cfg.num_layers, batch, _kv_window(cfg, cache_len),
             cfg.num_kv_heads, cfg.head_dim)
    return {"pos": torch.zeros((), dtype=torch.int32, device=dev),
            kind: {"k": torch.zeros(shape, dtype=cfg.dtype, device=dev),
                   "v": torch.zeros(shape, dtype=cfg.dtype, device=dev)}}


def lm_loss(*_args, **_kwargs):
    raise NotImplementedError("training (lm_loss, train steps) is ported in "
                              "slice 3 of the port (ROADMAP Queue A)")

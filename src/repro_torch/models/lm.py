"""Language model on torch: embedding -> layer stack -> head
(``repro``'s ``models/lm.py``), for its three wirings: ``uniform`` (one
kind of layer: ``attn``, ``moe``, ``mamba`` or ``rwkv``),
``hybrid_shared`` (zamba2: groups of Mamba2 layers, one shared-weight
attention block after each) and ``prefix_dense`` (kimi-k2: one dense
attention layer, then a stack of ``moe`` layers).

Params are the reference's nested dict with its keys: a uniform stack on
dim 0 of ``params["blocks"]``; the hybrid's Mamba2 layers as an
(n_groups, per, ...) stack in ``params["mamba"]`` beside one
``params["shared_attn"]`` block; the prefix-dense model's dense layer in
``params["dense0"]`` and its MoE stack in ``params["blocks"]``. Stacks
are walked with Python loops over layer views (the reference scans
them). Pre-copy walks this tree, and weights carried across from the JAX
package need no renaming (``models/convert.py``).

The decode cache is the reference's: ``{"pos": int32 0-dim, ...}`` with
``{"k", "v"}`` (L, B, W, Hkv, hd) rings under ``attn`` (W =
min(cache_len, sliding_window) under SWA), ``moe``, ``dense0`` (one
ring) or ``shared_attn`` (one ring per group), and tuples of stacked
states under ``mamba`` ((L, B, W-1, C) conv, (L, B, H, N, P) f32 SSD)
and ``rwkv`` ((L, B, d) twice, (L, B, H, P, P) f32). Unlike the
reference, which is functional, prefill writes into a cache from
``init_cache`` and ``decode_step`` writes the new token's K/V and every
layer's new state into that cache in place, returning a dict that holds
the same tensors and a new ``pos``.

Prefill's attention layers (``attn``, ``shared_attn``, ``moe``) go
through ``ops.flash_attention``: kernel B5 on the card, the chunked plain
version on the CPU; decode attention is plain torch. A ``moe`` layer's
expert FFN (``blocks.moe_ffn``) returns a load-balance aux loss, summed
over the layers in order as the reference's scan sums it.

Training: ``lm_loss`` runs the same layers with grad on (``_forward``),
each layer of a uniform stack or each hybrid group under
``torch.utils.checkpoint`` when ``cfg.remat`` is ``block`` or ``full``.
B5 and B4 run forward there; their backward is plain PyTorch
(``kernels/vjp.py``). ``forward`` (prefill) and ``decode_step`` stay under
``torch.no_grad()``, which their in-place cache writes need.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels.backend import DeviceLike, resolve_device
from repro_torch.models import blocks as B
from repro_torch.models import mamba2, rwkv6

Params = Dict[str, Any]
Batch = Dict[str, torch.Tensor]
ATTN_KINDS = ("attn", "shared_attn", "moe")      # layers with a KV ring


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


def _group_shape(cfg: ArchConfig) -> Tuple[int, int]:
    """hybrid_shared: (n_groups, mamba_per_group)."""
    per = sum(1 for k in cfg.block_pattern if k == "mamba")
    n_groups = cfg.num_layers // len(cfg.block_pattern)
    return n_groups, per


# ---------------------------------------------------------------------------
# per-kind block init / apply
# ---------------------------------------------------------------------------
def _attn_block_init(gen, cfg: ArchConfig, *, lead=(), device=None) -> Params:
    kw = dict(lead=lead, device=device)
    return {
        "ln1": B.rmsnorm_init(cfg.d_model, cfg.dtype, **kw),
        "attn": B.attention_init(gen, cfg, **kw),
        "ln2": B.rmsnorm_init(cfg.d_model, cfg.dtype, **kw),
        "mlp": B.mlp_init(gen, cfg, **kw),
    }


def _moe_block_init(gen, cfg: ArchConfig, *, lead=(), device=None) -> Params:
    kw = dict(lead=lead, device=device)
    return {
        "ln1": B.rmsnorm_init(cfg.d_model, cfg.dtype, **kw),
        "attn": B.attention_init(gen, cfg, **kw),
        "ln2": B.rmsnorm_init(cfg.d_model, cfg.dtype, **kw),
        "moe": B.moe_init(gen, cfg, **kw),
    }


def _mamba_block_init(gen, cfg: ArchConfig, *, lead=(), device=None) -> Params:
    return {
        "ln": B.rmsnorm_init(cfg.d_model, cfg.dtype, lead=lead,
                             device=device),
        "mixer": mamba2.mamba2_init(gen, cfg, lead=lead, device=device),
    }


BLOCK_INIT = {
    "attn": _attn_block_init,
    "shared_attn": _attn_block_init,
    "moe": _moe_block_init,
    "mamba": _mamba_block_init,
    "rwkv": rwkv6.rwkv6_init,
}


def apply_block(kind: str, params: Params, cfg: ArchConfig, x: torch.Tensor,
                angles: Optional[torch.Tensor], cache, cache_pos):
    """One layer. Returns (x, layer cache, aux loss): an attention layer's
    prefill K/V, or with ``cache`` its ring tensors after the in-place
    write; a Mamba2 or RWKV6 layer's new state tuple (``cache`` is only
    read). The aux loss (f32 0-dim) is a ``moe`` layer's; other layers
    have none (None), where the reference adds a zero."""
    aux = None
    if kind in ATTN_KINDS:
        h, new_kv = B.multihead_attention(
            params["attn"], cfg, B.rmsnorm(params["ln1"], x, cfg.norm_eps),
            angles, kv_cache=cache, cache_pos=cache_pos)
        x = x + h
        h2 = B.rmsnorm(params["ln2"], x, cfg.norm_eps)
        if kind == "moe":
            mo, aux = B.moe_ffn(params["moe"], cfg, h2)
            return x + mo, new_kv, aux
        return x + B.mlp(params["mlp"], h2), new_kv, aux
    if kind == "mamba":
        xn = B.rmsnorm(params["ln"], x, cfg.norm_eps)
        if cache is None:
            h, new_c = mamba2.mamba2_forward(params["mixer"], cfg, xn)
        else:
            h, new_c = mamba2.mamba2_decode(params["mixer"], cfg, xn, cache)
        return x + h, new_c, aux
    if kind == "rwkv":
        return (*rwkv6.rwkv6_block(params, cfg, x, cache), aux)
    raise ValueError(kind)


# ---------------------------------------------------------------------------
# model init
# ---------------------------------------------------------------------------
def init_params(cfg: ArchConfig, seed: int = 0, *,
                device: DeviceLike = None) -> Params:
    """Random weights from ``torch.Generator(device).manual_seed(seed)``,
    drawn on ``device`` (``None`` is the card; ``"meta"`` gives shapes and
    dtypes only). They are not the JAX package's numbers for the same seed:
    to run its weights, use ``models.convert.params_from_numpy``."""
    mode = wiring_mode(cfg)
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
    if mode == "uniform":
        kind = cfg.block_pattern[0]
        p["blocks"] = BLOCK_INIT[kind](gen, cfg, lead=(cfg.num_layers,),
                                       device=dev)
    elif mode == "prefix_dense":
        p["dense0"] = _attn_block_init(gen, cfg, device=dev)
        p["blocks"] = _moe_block_init(
            gen, cfg, lead=(cfg.num_layers - cfg.first_k_dense,), device=dev)
    else:  # hybrid_shared
        p["mamba"] = _mamba_block_init(gen, cfg, lead=_group_shape(cfg),
                                       device=dev)
        p["shared_attn"] = _attn_block_init(gen, cfg, device=dev)
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
    # F.embedding, not indexing: on the card its backward is deterministic,
    # an indexed gather's (index_put_ with accumulate) is not
    x = F.embedding(batch["tokens"].long(), params["embed"])
    if cfg.frontend_prefix and "prefix_embeds" in batch:
        pe = batch["prefix_embeds"].to(x.dtype)   # (B, P, d) stub frontend
        x = x.clone()
        x[:, : pe.shape[1]] = pe
    return x


def _head(cfg: ArchConfig, params: Params, x: torch.Tensor) -> torch.Tensor:
    x = B.rmsnorm(params["final_ln"], x, cfg.norm_eps)
    w = params["embed"].T if cfg.tie_embeddings else params["head"]
    return x @ w


def _unstack(stack: Any, n: int) -> List[Any]:
    """The ``n`` layers of a stacked tree as views along dim 0 (``unbind``:
    in backward, one stacked gradient per leaf)."""
    if isinstance(stack, torch.Tensor):
        return list(stack.unbind(0))
    parts = {k: _unstack(v, n) for k, v in stack.items()}
    return [{k: parts[k][i] for k in stack} for i in range(n)]


def _units(cfg: ArchConfig, params: Params):
    """The layers in order, grouped as the reference scans (and remats)
    them: each layer of a uniform stack, the prefix-dense model's dense
    layer and then each MoE layer, each group of the hybrid (its Mamba2
    layers, then the shared attention block). A unit is a list of (kind,
    layer params, cache key, index in that cache)."""
    mode = wiring_mode(cfg)
    if mode == "uniform":
        kind = cfg.block_pattern[0]
        for i, lp in enumerate(_unstack(params["blocks"], cfg.num_layers)):
            yield [(kind, lp, kind, i)]
        return
    if mode == "prefix_dense":
        yield [("attn", params["dense0"], "dense0", 0)]
        n = cfg.num_layers - cfg.first_k_dense
        for i, lp in enumerate(_unstack(params["blocks"], n)):
            yield [("moe", lp, "moe", i)]
        return
    n_groups, per = _group_shape(cfg)
    for g, group in enumerate(_unstack(params["mamba"], n_groups)):
        yield ([("mamba", lp, "mamba", g * per + j)
                for j, lp in enumerate(_unstack(group, per))]
               + [("shared_attn", params["shared_attn"], "shared_attn", g)])


def _layers(cfg: ArchConfig, params: Params):
    """(kind, layer params, cache key, index in that cache) in order."""
    for unit in _units(cfg, params):
        yield from unit


def _apply_unit(unit, cfg: ArchConfig, x: torch.Tensor,
                angles: Optional[torch.Tensor], aux: torch.Tensor):
    """The unit's layers in order; returns (x, aux plus theirs)."""
    for kind, lp, _, _ in unit:
        x, _, a = apply_block(kind, lp, cfg, x, angles, None, None)
        if a is not None:
            aux = aux + a
    return x, aux


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


def _angles(cfg: ArchConfig, positions: torch.Tensor):
    """Rotary angles, or None for an attention-free model."""
    return None if cfg.attention_free else B.rope_angles(cfg, positions)


@torch.no_grad()
def forward(params: Params, cfg: ArchConfig, batch: Batch, *,
            want_cache: bool = False, cache_len: int = 0):
    """Full-sequence forward without grad (prefill). Returns (hidden,
    aux_loss, cache-or-None).

    ``want_cache`` (prefill): also build the decode cache with capacity
    ``cache_len`` (>= S; SWA archs use min(cache_len, window)), each layer's
    K/V or state written into it as the layer runs."""
    return _forward(params, cfg, batch, want_cache=want_cache,
                    cache_len=cache_len)


def _forward(params: Params, cfg: ArchConfig, batch: Batch, *,
             want_cache: bool = False, cache_len: int = 0,
             remat: bool = False):
    """``forward`` in the caller's grad mode. Training (no cache) runs each
    unit of ``_units`` under ``torch.utils.checkpoint`` when ``remat``, as
    the reference's ``jax.checkpoint`` wraps its scanned body: the unit's
    activations are recomputed in backward, its kernels launched again.
    Each layer's aux loss is added in layer order."""
    Bsz, S = batch["tokens"].shape
    x = _embed(cfg, params, batch)
    angles = _angles(cfg, _positions(cfg, batch, Bsz, S))
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    if not want_cache:
        for unit in _units(cfg, params):
            if remat:
                x, aux_total = checkpoint(_apply_unit, unit, cfg, x, angles,
                                          aux_total, use_reentrant=False)
            else:
                x, aux_total = _apply_unit(unit, cfg, x, angles, aux_total)
        return x, aux_total, None
    cache = init_cache(cfg, Bsz, cache_len, device=x.device)
    cache["pos"].fill_(S)
    src = _ring_src(S, _kv_window(cfg, cache_len), x.device)
    for kind, lp, key, i in _layers(cfg, params):
        x, c, a = apply_block(kind, lp, cfg, x, angles, None, None)
        if a is not None:
            aux_total = aux_total + a
        if kind in ATTN_KINDS:
            rings = cache[key]
            for name, t in zip(("k", "v"), c):
                if src is None:
                    rings[name][i, :, :S] = t
                else:
                    rings[name][i] = t.index_select(1, src)
        else:
            for dst, t in zip(cache[key], c):
                dst[i].copy_(t)
    return x, aux_total, cache


# ---------------------------------------------------------------------------
# decode (one token)
# ---------------------------------------------------------------------------
@torch.no_grad()
def decode_step(params: Params, cfg: ArchConfig, token: torch.Tensor,
                cache: Dict[str, Any]):
    """token: (B, 1) int32. Returns (logits (B, V), new_cache); the rings
    and states of ``cache`` are updated in place and shared by
    ``new_cache``."""
    Bsz = token.shape[0]
    pos = cache["pos"]
    x = params["embed"][token.long()]
    positions = pos.reshape(1, 1).expand(Bsz, 1)
    if cfg.mrope:
        positions = positions[None].expand(3, Bsz, 1)
    angles = _angles(cfg, positions)
    for kind, lp, key, i in _layers(cfg, params):
        if kind in ATTN_KINDS:
            x, _, _ = apply_block(kind, lp, cfg, x, angles,
                                  (cache[key]["k"][i], cache[key]["v"][i]),
                                  pos)
        else:
            state = tuple(t[i] for t in cache[key])
            x, c, _ = apply_block(kind, lp, cfg, x, angles, state, pos)
            for dst, t in zip(state, c):
                dst.copy_(t)
    logits = _head(cfg, params, x)[:, 0]                  # (B, V)
    return logits, {**cache, "pos": pos + 1}


# ---------------------------------------------------------------------------
# cache init
# ---------------------------------------------------------------------------
def init_cache(cfg: ArchConfig, batch: int, cache_len: int, *,
               device: DeviceLike = None) -> Dict[str, Any]:
    """Empty decode cache at position 0: zero (L, B, W, Hkv, hd) rings and
    zero stacked layer states."""
    mode = wiring_mode(cfg)
    dev = resolve_device(device)
    shape = (_kv_window(cfg, cache_len), cfg.num_kv_heads, cfg.head_dim)

    def rings(n):
        return {name: torch.zeros((n, batch, *shape), dtype=cfg.dtype,
                                  device=dev) for name in ("k", "v")}

    cache: Dict[str, Any] = {"pos": torch.zeros((), dtype=torch.int32,
                                                device=dev)}
    if mode == "hybrid_shared":
        n_groups, per = _group_shape(cfg)
        cache["mamba"] = mamba2.init_cache(cfg, batch, cfg.dtype,
                                           lead=(n_groups * per,), device=dev)
        cache["shared_attn"] = rings(n_groups)
        return cache
    if mode == "prefix_dense":
        cache["dense0"] = rings(1)
        cache["moe"] = rings(cfg.num_layers - cfg.first_k_dense)
        return cache
    kind = cfg.block_pattern[0]
    lead = (cfg.num_layers,)
    if kind in ("attn", "moe"):
        cache[kind] = rings(cfg.num_layers)
    elif kind == "mamba":
        cache["mamba"] = mamba2.init_cache(cfg, batch, cfg.dtype, lead=lead,
                                           device=dev)
    else:
        cache["rwkv"] = rwkv6.init_cache(cfg, batch, cfg.dtype, lead=lead,
                                         device=dev)
    return cache


# ---------------------------------------------------------------------------
# loss
# ---------------------------------------------------------------------------
def lm_loss(params: Params, cfg: ArchConfig, batch: Batch):
    """Next-token cross entropy plus z-loss and the MoE aux loss (0 without
    ``moe`` layers) in the caller's grad mode, with ``cfg.remat``'s
    recomputation. Targets < 0 are masked; the logits go to logsumexp in
    f32. Returns (loss, {ce, z_loss, aux_loss, tokens}), the metrics
    detached."""
    x, aux, _ = _forward(params, cfg, batch,
                         remat=cfg.remat in ("block", "full"))
    logits = _head(cfg, params, x).float()                # (B, S, V)
    targets = batch["targets"]
    mask = (targets >= 0).float()
    tgt = targets.clamp(min=0).long()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, tgt[..., None])[..., 0]
    nll = (logz - gold) * mask
    tokens = torch.sum(mask)
    denom = torch.clamp(tokens, min=1.0)
    ce = torch.sum(nll) / denom
    zl = cfg.z_loss * torch.sum(torch.square(logz) * mask) / denom
    loss = ce + zl + aux
    return loss, {"ce": ce.detach(), "z_loss": zl.detach(),
                  "aux_loss": aux.detach(), "tokens": tokens}

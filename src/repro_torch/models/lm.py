"""Language model on torch: embedding -> layer stack -> head
(``repro``'s ``models/lm.py``), for its three wirings: ``uniform`` (one
kind of layer: ``attn``, ``moe``, ``mamba`` or ``rwkv``),
``hybrid_shared`` (zamba2: groups of Mamba2 layers, one shared-weight
attention block after each) and ``prefix_dense`` (kimi-k2: one dense
attention layer, then a stack of ``moe`` layers); and a fourth of the port's
own, ``hybrid_ids`` (zamba2 as published, zamba2-7b: a config with
``hybrid_layer_ids``), which the JAX package does not have: a flat stack of
Mamba2 layers, and before the layer at the j-th hybrid id a call of shared
block j mod ``num_mem_blocks`` on concat(h, token embeddings)
(``blocks.shared_block``, with call j's LoRA), whose output, through call
j's ``linear``, is added to that Mamba2 layer's input before its RMSNorm;
the layer's residual stays h. Its params: ``mamba`` an (L, ...) stack,
``shared`` the blocks' (num_mem_blocks, ...) stack, ``calls`` the calls'
(LoRA, ``linear``) stack; its cache: the L Mamba2 states under ``mamba``
and one (B, W, Hkv, hd) ring a call under ``shared`` (each call attends
over its own activations). Each call runs under the span ``lm.block``
("shared", j), each Mamba2 layer under ``lm.block`` ("mamba", i) (the
spans inside them: ``blocks.shared_block``'s, ``mamba2``'s). Its prefill
takes the batch in passes of at most ``PREFILL_TOKENS`` tokens. It runs
on one device, without remat.

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
version on the CPU; decode attention through ``ops.decode_attention``
(rotary, the ring write and attention over the ring in one kernel on the
card, ``ref.decode_attention_ref`` on the CPU), but for a ring that a mesh
cuts along its window (``blocks._decode_window``, plain torch). A ``moe``
layer's expert FFN (``blocks.moe_ffn``) returns a load-balance aux loss,
summed over the layers in order as the reference's scan sums it.

Training: ``lm_loss`` runs the same layers with grad on (``_forward``),
each layer of a uniform stack or each hybrid group under
``torch.utils.checkpoint`` when ``cfg.remat`` is ``block`` or ``full``.
B5 and B4 run forward there; their backward is plain PyTorch
(``kernels/vjp.py``). ``forward`` (prefill) and ``decode_step`` stay under
``torch.no_grad()``, which their in-place cache writes need.

On a ``(data, model)`` mesh (a ``models/dist`` context, params, batch and
cache in this rank's slices from ``launch/sharding``) the dense and MoE
wirings run tensor-parallel: the embedding table's columns are looked up
and all-gathered over ``model``, the attention and MLP are Megatron
regions (``blocks``), the MoE layer expert-parallel, and the head's
vocabulary is split over ``model`` (a tied head's partial products are
all-reduced, then cut by ``constrain_logits``), so ``lm_loss`` takes the
log-sum-exp over the split vocabulary. Every rank of a ``model`` group
computes the same loss; ``lm_loss`` returns this ``data`` rank's share of
it (its tokens over the global count), the shares summing to the loss.
``constrain`` (``launch/sharding.make_constrain``) cuts the residual
stream once, after the embedding, where the reference constrains it after
every residual add: a rank's stream keeps its layout between layers
(``dist.tp_exit`` leaves it so). The ``mamba``, ``rwkv`` and
``hybrid_shared`` wirings run on a mesh too: a Mamba2 or RWKV6 layer on
the rank's heads (``models/mamba2``, ``models/rwkv6``), zamba2's shared
attention block as the attention and MLP regions above, once a group
(its gradient summed over the groups by autograd), its ring cut as the
others. ``_mesh_context`` refuses a width that ``model`` does not divide,
and ``seq_shard`` with SSM layers; the attention's heads are the exception:
where ``model`` does not cut them (``blocks.head_split``) every rank
computes them all on the gathered weights
(``blocks._attention_replicated``), and a ring cut neither by heads nor by
window is whole on every rank.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels.backend import DeviceLike, resolve_device
from repro_torch.models import blocks as B
from repro_torch.models import dist, mamba2, rwkv6
from repro_torch.runtime import spans

Params = Dict[str, Any]
Batch = Dict[str, torch.Tensor]
ATTN_KINDS = ("attn", "shared_attn", "moe")      # layers with a KV ring
Identity = lambda x: x  # noqa: E731


# ---------------------------------------------------------------------------
# wiring
# ---------------------------------------------------------------------------
def wiring_mode(cfg: ArchConfig) -> str:
    if cfg.hybrid_layer_ids:
        return "hybrid_ids"
    if "shared_attn" in cfg.block_pattern:
        return "hybrid_shared"
    if cfg.first_k_dense > 0:
        return "prefix_dense"
    assert len(set(cfg.block_pattern)) == 1, cfg.block_pattern
    return "uniform"


def _mesh_context(cfg: ArchConfig) -> Optional[dist.DistContext]:
    """The ``dist`` context, once the config is known to run on it: every
    width the rules cut over ``model`` must divide it, or it would stay
    whole on every rank (the rules' fallback) and a region's exit would sum
    its copies. The attention is the exception: where ``model`` does not
    cut its heads (``blocks.head_split``) every rank computes them all."""
    ctx = dist.current()
    if ctx is None:
        return None
    if cfg.hybrid_layer_ids or cfg.attn_scale:
        raise NotImplementedError(f"{cfg.name}: the hybrid_ids wiring and "
                                  "attn_scale run on one device only")
    kinds = set(cfg.block_pattern)
    widths = {}
    if kinds & {"attn", "shared_attn"} or cfg.first_k_dense:
        widths["d_ff"] = cfg.d_ff
    if cfg.moe is not None:
        widths["experts"] = cfg.moe.num_experts
        if cfg.moe.num_shared_experts:
            widths["the shared expert's d_ff"] = (
                cfg.moe.num_shared_experts * cfg.moe.d_ff_expert)
    if "mamba" in kinds:
        widths["Mamba2 heads"] = mamba2.dims(cfg)[1]
    if "rwkv" in kinds:
        widths["RWKV heads"] = cfg.d_model // cfg.ssm.head_dim
        widths["d_model (the shift carries, cm_wr)"] = cfg.d_model
        widths["the channel-mix d_ff"] = cfg.d_ff
    tp = dist.tp_size(ctx)
    bad = {k: w for k, w in widths.items() if w % tp}
    if bad:
        raise NotImplementedError(f"{cfg.name} on a model axis of {tp}: "
                                  f"it does not divide {bad}")
    if kinds & {"mamba", "rwkv"} and ctx.seq_shard:
        raise NotImplementedError(f"{cfg.name}: seq_shard with {kinds} "
                                  "layers (a scan runs over the whole "
                                  "sequence); use a context without it")
    if "mamba" in kinds and tp > 1 and (cfg.ssm.conv_width - 1) % tp == 0:
        raise NotImplementedError(
            f"{cfg.name}: the rules would cut the conv carry's "
            f"{cfg.ssm.conv_width - 1} steps over a model axis of {tp}")
    return ctx


def _norm(params: Params, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """RMSNorm; with ``seq_shard`` a rank's scale sees only its tokens, so
    its gradient is summed over ``model``."""
    ctx = dist.current()
    if ctx is not None and ctx.seq_shard:
        params = {"scale": dist.tp_param(params["scale"], ctx)}
    return B.rmsnorm(params, x, cfg.norm_eps)


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
                angles: Optional[torch.Tensor], cache, cache_pos, *,
                want_state: bool = True):
    """One layer. Returns (x, layer cache, aux loss): an attention layer's
    prefill K/V, or with ``cache`` its ring tensors after the in-place
    write; a Mamba2 or RWKV6 layer's new state tuple (``cache`` is only
    read; without ``want_state``, in training, a Mamba2 layer's conv carry
    is None). The aux loss (f32 0-dim) is a ``moe`` layer's; other layers
    have none (None), where the reference adds a zero."""
    aux = None
    if kind in ATTN_KINDS:
        h, new_kv = B.multihead_attention(
            params["attn"], cfg, _norm(params["ln1"], x, cfg),
            angles, kv_cache=cache, cache_pos=cache_pos)
        x = x + h
        h2 = _norm(params["ln2"], x, cfg)
        if kind == "moe":
            mo, aux = _moe(params["moe"], cfg, h2)
            return x + mo, new_kv, aux
        return x + B.mlp(params["mlp"], h2), new_kv, aux
    if kind == "mamba":
        xn = B.rmsnorm(params["ln"], x, cfg.norm_eps)
        if cache is None:
            h, new_c = mamba2.mamba2_forward(params["mixer"], cfg, xn,
                                             want_state=want_state)
        else:
            h, new_c = mamba2.mamba2_decode(params["mixer"], cfg, xn, cache)
        return x + h, new_c, aux
    if kind == "rwkv":
        return (*rwkv6.rwkv6_block(params, cfg, x, cache), aux)
    raise ValueError(kind)


def _moe(params: Params, cfg: ArchConfig, x: torch.Tensor):
    """``B.moe_ffn``; on a mesh adapted to the replicated loss. The
    expert-parallel layer's collectives take their exact transposes (the
    gradient of the sum of every rank's output), while every rank of a
    ``model`` group here computes the same loss: a replicated input enters
    by ``copy_to_tp`` and the replicated output's and the aux loss's
    gradients are divided by the ``model`` size (the aux loss is
    replicated under ``seq_shard`` too, the output then split)."""
    ctx = dist.current()
    if ctx is None:
        return B.moe_ffn(params, cfg, x)
    tp = dist.tp_size(ctx)
    if not ctx.seq_shard:
        x = dist.copy_to_tp(x, ctx.mesh, ctx.tp_axis)
    out, aux = B.moe_ffn(params, cfg, x)
    if not ctx.seq_shard:
        out = dist.scale_grad(out, 1.0 / tp)
    return out, dist.scale_grad(aux, 1.0 / tp)


# ---------------------------------------------------------------------------
# model init
# ---------------------------------------------------------------------------
def _check_hybrid_ids(cfg: ArchConfig) -> None:
    """Raise unless the ``hybrid_ids`` wiring is well formed: increasing
    ids of a stack of Mamba2 layers, at least one shared block and a LoRA
    of rank >= 1."""
    ids = list(cfg.hybrid_layer_ids)
    if (ids != sorted(set(ids)) or ids[0] < 0 or ids[-1] >= cfg.num_layers
            or cfg.num_mem_blocks < 1 or cfg.adapter_rank < 1
            or set(cfg.block_pattern) != {"mamba"}):
        raise ValueError(f"{cfg.name}: hybrid_layer_ids {tuple(ids)} need "
                         "increasing ids of the Mamba2 stack (block_pattern "
                         "('mamba',)), num_mem_blocks and adapter_rank >= 1")


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
    elif mode == "hybrid_ids":
        _check_hybrid_ids(cfg)
        p["mamba"] = _mamba_block_init(gen, cfg, lead=(cfg.num_layers,),
                                       device=dev)
        p["shared"] = B.shared_block_init(gen, cfg,
                                          lead=(cfg.num_mem_blocks,),
                                          device=dev)
        p["calls"] = B.shared_call_init(
            gen, cfg, lead=(len(cfg.hybrid_layer_ids),), device=dev)
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


def _lookup(cfg: ArchConfig, params: Params, tokens: torch.Tensor
            ) -> torch.Tensor:
    """The tokens' rows of the table. On a mesh the table is cut along d
    over ``model``: the rank's columns, all-gathered (each rank's gradient
    its own columns of the replicated one)."""
    # F.embedding, not indexing: on the card its backward is deterministic,
    # an indexed gather's (index_put_ with accumulate) is not
    x = F.embedding(tokens.long(), params["embed"])
    ctx = dist.current()
    if ctx is not None and x.shape[-1] != cfg.d_model:
        x = dist.gather_split(x, ctx.mesh, ctx.tp_axis, dim=-1)
    return x


def _embed(cfg: ArchConfig, params: Params, batch: Batch) -> torch.Tensor:
    x = _lookup(cfg, params, batch["tokens"])
    if cfg.frontend_prefix and "prefix_embeds" in batch:
        pe = batch["prefix_embeds"].to(x.dtype)   # (B, P, d) stub frontend
        x = x.clone()
        x[:, : pe.shape[1]] = pe
    return x


def _head(cfg: ArchConfig, params: Params, x: torch.Tensor,
          constrain_logits: Callable = Identity, *,
          whole: bool = False) -> torch.Tensor:
    """Final norm and the product with the head (``embed.T`` when tied).

    On a mesh the logits come out split along the vocabulary over
    ``model`` (V/tp columns): ``head`` is cut there; a tied head's d-cut
    table gives partial products, all-reduced to whole logits and then
    cut by ``constrain_logits``. A head that ``model`` does not cut gives
    whole logits. ``whole`` all-gathers split logits (prefill and decode,
    without grad)."""
    ctx = dist.current()
    x = _norm(params["final_ln"], x, cfg)
    if ctx is None:
        w = params["embed"].T if cfg.tie_embeddings else params["head"]
        return constrain_logits(x @ w)
    mesh, ax = ctx.mesh, ctx.tp_axis
    hook = Identity if whole else constrain_logits
    if cfg.tie_embeddings:
        w = params["embed"].T                            # (d or d/tp, V)
        cut = w.shape[0] != cfg.d_model
    else:
        w = params["head"]                               # (d, V or V/tp)
        cut = w.shape[1] != cfg.vocab_size
    if not cut:                        # replicated head: whole logits
        if ctx.seq_shard:
            x = dist.gather_split(x, mesh, ax, dim=1)
        return hook(x @ w)
    x = dist.tp_enter(x, ctx)
    if cfg.tie_embeddings:             # d-cut table: partial products
        dl, r = w.shape[0], dist.tp_rank(ctx)
        return hook(dist.reduce_from_tp(x[..., r * dl:(r + 1) * dl] @ w,
                                        mesh, ax))
    logits = x @ w                     # (.., V/tp)
    if whole:
        logits = dist.all_gather(logits, mesh, ax, dim=-1)
    return logits


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


def _hybrid_ids(params: Params, cfg: ArchConfig, x: torch.Tensor,
                angles: torch.Tensor, cache: Optional[Dict[str, Any]],
                write: Callable, pos=None) -> torch.Tensor:
    """The ``hybrid_ids`` wiring's layers on ``x`` (module docstring).
    ``cache`` None: prefill or training; ``write(kind, i, state)``, where
    given (prefill), takes each layer's new state (a call's (k, v), a
    Mamba2 layer's tuple).
    Else decode at ``pos``: the rings and states of ``cache`` are read and
    written in place."""
    emb = x
    nb = cfg.num_mem_blocks
    call_at = {i: j for j, i in enumerate(cfg.hybrid_layer_ids)}
    shared = _unstack(params["shared"], nb)
    calls = _unstack(params["calls"], len(call_at))
    for i, lp in enumerate(_unstack(params["mamba"], cfg.num_layers)):
        t = None
        if i in call_at:
            j = call_at[i]
            ring = None if cache is None else (cache["shared"]["k"][j],
                                               cache["shared"]["v"][j])
            with spans.span("lm.block", ("shared", j)):
                t, kv = B.shared_block(shared[j % nb], calls[j], cfg, x, emb,
                                       angles, kv_cache=ring, cache_pos=pos)
            if write is not None:
                write("shared", j, kv)
        with spans.span("lm.block", ("mamba", i)):
            xn = B.rmsnorm(lp["ln"], x if t is None else x + t, cfg.norm_eps)
            if cache is None:
                h, c = mamba2.mamba2_forward(lp["mixer"], cfg, xn,
                                             want_state=write is not None)
                if write is not None:
                    write("mamba", i, c)
            else:
                state = tuple(s[i] for s in cache["mamba"])
                h, c = mamba2.mamba2_decode(lp["mixer"], cfg, xn, state)
                for dst, new in zip(state, c):
                    dst.copy_(new)
            x = x + h
    return x


#: tokens the ``hybrid_ids`` prefill takes through its layers at once: a
#: pass of whole sequences, at least one. zamba2-7b's activations at 16 x
#: 4,080 in one pass peak near 13 GiB, and a serving replica prefills beside
#: the cache of the batch before it (25 GiB of rings and states); 8 x 4,080
#: a pass keeps the two caches, the weights and the pass on an 80 GB card.
#: Measured on an H100 80GB HBM3 (85.0 GB): that prefill peaks at 76.3 to
#: 77.7 GB, 0.90 to 0.91 of the card, which leaves 7 GB; ``chip_smoke.py``
#: fails past 0.95 (``Z7_MEM_SHARE``)
PREFILL_TOKENS = 1 << 15


def _hybrid_ids_prefill(params: Params, cfg: ArchConfig, x: torch.Tensor,
                        angles: torch.Tensor, cache: Dict[str, Any],
                        src: Optional[torch.Tensor], lo: int) -> torch.Tensor:
    """The ``hybrid_ids`` prefill in passes of whole sequences of at most
    ``PREFILL_TOKENS`` tokens, each pass's K/V and states written into its
    rows of ``cache``. Returns the hidden states of every position."""
    Bsz, S = x.shape[:2]
    rows = max(1, PREFILL_TOKENS // S)
    out = []
    for b0 in range(0, Bsz, rows):
        part = slice(b0, b0 + rows)

        def write(kind, i, c):
            if kind == "shared":
                for name, t in zip(("k", "v"), c):
                    _ring_block(cache["shared"][name][i][part], t, src, lo)
            else:
                for dst, t in zip(cache["mamba"], c):
                    dst[i][part].copy_(t)

        out.append(_hybrid_ids(params, cfg, x[part], angles[part], None,
                               write))
    return out[0] if len(out) == 1 else torch.cat(out)


def _layers(cfg: ArchConfig, params: Params):
    """(kind, layer params, cache key, index in that cache) in order."""
    for unit in _units(cfg, params):
        yield from unit


def _apply_unit(unit, cfg: ArchConfig, x: torch.Tensor,
                angles: Optional[torch.Tensor], aux: torch.Tensor,
                ctx: Optional[dist.DistContext] = None):
    """The unit's layers in order; returns (x, aux plus theirs). ``ctx``:
    run under that ``dist`` context (a checkpointed unit's recompute runs
    in backward, on the autograd engine's thread for a card, where the
    caller's thread-local context is not set)."""
    if ctx is not None:
        with dist.use(ctx):
            return _apply_unit(unit, cfg, x, angles, aux)
    for kind, lp, _, i in unit:
        with spans.span("lm.block", (kind, i)):
            x, _, a = apply_block(kind, lp, cfg, x, angles, None, None,
                                  want_state=False)
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
            constrain: Callable = Identity, want_cache: bool = False,
            cache_len: int = 0):
    """Full-sequence forward without grad (prefill). Returns (hidden,
    aux_loss, cache-or-None).

    ``want_cache`` (prefill): also build the decode cache with capacity
    ``cache_len`` (>= S; SWA archs use min(cache_len, window)), each layer's
    K/V or state written into it as the layer runs. On a mesh the cache is
    this rank's block of it (``init_cache``)."""
    with spans.span("lm.forward"):
        return _forward(params, cfg, batch, constrain=constrain,
                        want_cache=want_cache, cache_len=cache_len)


def _stream(cfg: ArchConfig, params: Params, batch: Batch,
            constrain: Callable) -> torch.Tensor:
    """The embedded tokens through ``constrain``; on a mesh with
    ``seq_shard`` the hook must have cut the sequence over ``model``."""
    x = constrain(_embed(cfg, params, batch))
    ctx = dist.current()
    if ctx is not None and ctx.seq_shard:
        S, tp = batch["tokens"].shape[1], dist.tp_size(ctx)
        if x.shape[1] * tp != S:
            raise ValueError(f"seq_shard: the residual stream holds "
                             f"{x.shape[1]} of {S} positions on a model axis "
                             f"of {tp}; pass launch/sharding.make_constrain "
                             "and a sequence the axis divides")
    return x


def _ring_block(ring: torch.Tensor, t: torch.Tensor,
                src: Optional[torch.Tensor], lo: int):
    """A layer's prefill K/V ``t`` (B, S, heads, hd) as the slots of the
    rank's ring block ``ring`` (B, W_r, heads, hd) that start at slot
    ``lo`` of the window: the whole window (``lo`` 0), or on a ring cut
    along its window the rank's slots."""
    S, Wr = t.shape[1], ring.shape[1]
    if src is None:
        n = max(0, min(S - lo, Wr))
        ring[:, :n] = t[:, lo:lo + n]
    else:
        ring.copy_(t.index_select(1, src[lo:lo + Wr]))


def _forward(params: Params, cfg: ArchConfig, batch: Batch, *,
             constrain: Callable = Identity, want_cache: bool = False,
             cache_len: int = 0, remat: bool = False):
    """``forward`` in the caller's grad mode. Training (no cache) runs each
    unit of ``_units`` under ``torch.utils.checkpoint`` when ``remat``, as
    the reference's ``jax.checkpoint`` wraps its scanned body: the unit's
    activations are recomputed in backward, its kernels launched again.
    Each layer's aux loss is added in layer order."""
    _mesh_context(cfg)
    Bsz, S = batch["tokens"].shape
    with spans.span("lm.embed"):
        x = _stream(cfg, params, batch, constrain)
        angles = _angles(cfg, _positions(cfg, batch, Bsz, S))
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    hybrid_ids = wiring_mode(cfg) == "hybrid_ids"
    if hybrid_ids and not want_cache:
        return _hybrid_ids(params, cfg, x, angles, None, None), aux_total, None
    if not want_cache:
        for unit in _units(cfg, params):
            if remat:
                x, aux_total = checkpoint(_apply_unit, unit, cfg, x, angles,
                                          aux_total, dist.current(),
                                          use_reentrant=False)
            else:
                x, aux_total = _apply_unit(unit, cfg, x, angles, aux_total)
        return x, aux_total, None
    cache = init_cache(cfg, Bsz, cache_len, device=x.device)
    cache["pos"].fill_(S)
    W = _kv_window(cfg, cache_len)
    src = _ring_src(S, W, x.device)
    ctx, lo = dist.current(), 0
    if ctx is not None and _ring_cut(cfg, ctx, W) == "window":
        lo = dist.tp_rank(ctx) * (W // dist.tp_size(ctx))
    if hybrid_ids:
        return (_hybrid_ids_prefill(params, cfg, x, angles, cache, src, lo),
                aux_total, cache)
    for kind, lp, key, i in _layers(cfg, params):
        with spans.span("lm.block", (kind, i)):
            x, c, a = apply_block(kind, lp, cfg, x, angles, None, None)
        if a is not None:
            aux_total = aux_total + a
        if kind in ATTN_KINDS:
            rings = cache[key]
            for name, t in zip(("k", "v"), c):
                _ring_block(rings[name][i], t, src, lo)
        else:
            for dst, t in zip(cache[key], c):
                dst[i].copy_(t)
    return x, aux_total, cache


# ---------------------------------------------------------------------------
# decode (one token)
# ---------------------------------------------------------------------------
@torch.no_grad()
def decode_step(params: Params, cfg: ArchConfig, token: torch.Tensor,
                cache: Dict[str, Any], *, constrain: Callable = Identity):
    """token: (B, 1) int32. Returns (logits (B, V), new_cache); the rings
    and states of ``cache`` are updated in place and shared by
    ``new_cache``. On a mesh the rank's rows of the batch and its block of
    the cache, and the logits whole (gathered over ``model``); the context
    must not split the sequence (one position)."""
    ctx = _mesh_context(cfg)
    if ctx is not None and ctx.seq_shard:
        raise ValueError("decode_step: one position cannot be split over "
                         "the model axis; decode under a context without "
                         "seq_shard")
    with spans.span("lm.decode_step"):
        Bsz = token.shape[0]
        pos = cache["pos"]
        with spans.span("lm.embed"):
            x = constrain(_lookup(cfg, params, token))
            positions = pos.reshape(1, 1).expand(Bsz, 1)
            if cfg.mrope:
                positions = positions[None].expand(3, Bsz, 1)
            angles = _angles(cfg, positions)
        if wiring_mode(cfg) == "hybrid_ids":
            x = _hybrid_ids(params, cfg, x, angles, cache, None, pos)
        else:
            x = _decode_layers(params, cfg, x, angles, cache, pos)
        with spans.span("lm.head"):
            logits = _head(cfg, params, x, whole=True)[:, 0]  # (B, V)
        return logits, {**cache, "pos": pos + 1}


def _decode_layers(params: Params, cfg: ArchConfig, x: torch.Tensor,
                   angles, cache: Dict[str, Any], pos) -> torch.Tensor:
    """Every layer of the stack wirings on one token, each ring and state
    of ``cache`` written in place."""
    for kind, lp, key, i in _layers(cfg, params):
        with spans.span("lm.block", (kind, i)):
            if kind in ATTN_KINDS:
                x, _, _ = apply_block(
                    kind, lp, cfg, x, angles,
                    (cache[key]["k"][i], cache[key]["v"][i]), pos)
            else:
                state = tuple(t[i] for t in cache[key])
                x, c, _ = apply_block(kind, lp, cfg, x, angles, state, pos)
                for dst, t in zip(state, c):
                    dst.copy_(t)
    return x


# ---------------------------------------------------------------------------
# cache init
# ---------------------------------------------------------------------------
def _ring_cut(cfg: ArchConfig, ctx, W: int) -> Optional[str]:
    """How ``model`` cuts a KV ring of window ``W`` under ``ctx``
    (``launch/sharding.kv_split``): "heads", "window", or None (whole on
    every rank, also without a context)."""
    from repro_torch.launch.sharding import kv_split
    if dist.tp_size(ctx) == 1:
        return None
    return kv_split(ctx.mesh, cfg.num_kv_heads, W)


def init_cache(cfg: ArchConfig, batch: int, cache_len: int, *,
               device: DeviceLike = None) -> Dict[str, Any]:
    """Empty decode cache at position 0: zero (L, B, W, Hkv, hd) rings and
    zero stacked layer states. On a mesh ``batch`` is the rank's rows and
    each leaf the rank's block (``launch/sharding.cache_pspec``): a ring's
    KV heads, or where ``model`` does not divide them its slots of the
    window, or where it divides neither the whole ring; the Mamba2 SSD and
    RWKV6 wkv states' heads, the RWKV6 shift carries' d-slices, the Mamba2
    conv carry whole. ``"meta"`` gives shapes and dtypes only, as
    ``init_params``."""
    mode = wiring_mode(cfg)
    ctx = _mesh_context(cfg)
    dev = (torch.device("meta") if device is not None
           and torch.device(device).type == "meta" else resolve_device(device))
    W, Hkv = _kv_window(cfg, cache_len), cfg.num_kv_heads
    tp, where = dist.tp_size(ctx), _ring_cut(cfg, ctx, W)
    if where == "heads":
        Hkv //= tp
    elif where == "window":
        W //= tp
    shape = (W, Hkv, cfg.head_dim)

    def rings(n):
        return {name: torch.zeros((n, batch, *shape), dtype=cfg.dtype,
                                  device=dev) for name in ("k", "v")}

    cache: Dict[str, Any] = {"pos": torch.zeros((), dtype=torch.int32,
                                                device=dev)}
    if mode == "hybrid_ids":
        cache["mamba"] = mamba2.init_cache(cfg, batch, cfg.dtype,
                                           lead=(cfg.num_layers,), device=dev)
        cache["shared"] = rings(len(cfg.hybrid_layer_ids))
        return cache
    if mode == "hybrid_shared":
        n_groups, per = _group_shape(cfg)
        cache["mamba"] = mamba2.init_cache(cfg, batch, cfg.dtype,
                                           lead=(n_groups * per,), device=dev,
                                           tp=tp)
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
                                           device=dev, tp=tp)
    else:
        cache["rwkv"] = rwkv6.init_cache(cfg, batch, cfg.dtype, lead=lead,
                                         device=dev, tp=tp)
    return cache


# ---------------------------------------------------------------------------
# loss
# ---------------------------------------------------------------------------
def _vocab_split_nll(logits: torch.Tensor, tgt: torch.Tensor, ctx):
    """(log Z, gold logit) from logits whose vocabulary is split over
    ``model`` (this rank's V/tp columns): the max all-reduced (no
    gradient), the exp-sums and the gold logit (from the rank that holds
    the target's column) summed over ``model``."""
    mesh, ax = ctx.mesh, ctx.tp_axis
    Vl = logits.shape[-1]
    top = dist.all_reduce_max(logits.amax(dim=-1), mesh, ax)
    sumexp = dist.reduce_from_tp(
        torch.exp(logits - top[..., None]).sum(dim=-1), mesh, ax)
    logz = top + torch.log(sumexp)
    local = tgt - dist.tp_rank(ctx) * Vl
    held = (local >= 0) & (local < Vl)
    g = torch.gather(logits, -1, local.clamp(0, Vl - 1)[..., None])[..., 0]
    gold = dist.reduce_from_tp(torch.where(held, g, g.new_zeros(())),
                               mesh, ax)
    return logz, gold


def _batch_sum(t: torch.Tensor, ctx) -> torch.Tensor:
    """A detached sum over the batch axes."""
    t = t.detach()
    for a in ctx.batch_axes:
        t = dist.all_reduce(t, ctx.mesh, a)
    return t


def lm_loss(params: Params, cfg: ArchConfig, batch: Batch, *,
            constrain: Callable = Identity,
            constrain_logits: Callable = Identity):
    """Next-token cross entropy plus z-loss and the MoE aux loss (0 without
    ``moe`` layers) in the caller's grad mode, with ``cfg.remat``'s
    recomputation. Targets < 0 are masked; the logits go to logsumexp in
    f32. Returns (loss, {ce, z_loss, aux_loss, tokens}), the metrics
    detached.

    On a mesh the returned loss is this ``data`` rank's share (its tokens'
    terms over the global token count, the aux loss over the number of
    batch ranks), the same on every rank of its ``model`` group, and the
    metrics are the global values."""
    x, aux, _ = _forward(params, cfg, batch, constrain=constrain,
                         remat=cfg.remat in ("block", "full"))
    logits = _head(cfg, params, x, constrain_logits).float()  # (B, S, V*)
    targets = batch["targets"]
    mask = (targets >= 0).float()
    tgt = targets.clamp(min=0).long()
    ctx = dist.current()
    if ctx is not None and logits.shape[-1] != cfg.vocab_size:
        logz, gold = _vocab_split_nll(logits, tgt, ctx)
    else:
        logz = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, tgt[..., None])[..., 0]
    nll = (logz - gold) * mask
    tokens = torch.sum(mask)
    if ctx is not None:
        tokens = _batch_sum(tokens, ctx)
        aux = aux / dist.batch_size(ctx)
    denom = torch.clamp(tokens, min=1.0)
    ce = torch.sum(nll) / denom
    zl = cfg.z_loss * torch.sum(torch.square(logz) * mask) / denom
    loss = ce + zl + aux
    if ctx is None:
        return loss, {"ce": ce.detach(), "z_loss": zl.detach(),
                      "aux_loss": aux.detach(), "tokens": tokens}
    return loss, {"ce": _batch_sum(ce, ctx), "z_loss": _batch_sum(zl, ctx),
                  "aux_loss": _batch_sum(aux, ctx), "tokens": tokens}

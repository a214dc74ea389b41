"""The port's accelerated ops, dispatched by the tensor's device: the cycle
fit's spectrum and lag scores, pre-copy's dirty-block scan, the SSM
layers' chunked scan, attention prefill and decode attention.

  ==============  ===============================  ===========================
  op              CUDA tensor                      CPU tensor
  ==============  ===============================  ===========================
  power_spectrum  dft.power_spectrum (dft_power.cu) ref.power_spectrum_ref
  autocorr_score  autocorr.autocorr_score          ref.autocorr_score_ref
                  (autocorr.cu): consecutive lag
                  tiles a 3xTF32 Hankel product
                  on the tensor cores, other
                  tiles direct sums; rows must
                  be finite (a NaN reaches its
                  whole tensor tile)
  dirty_blocks    dirty_delta.max_abs_delta        ref.max_abs_delta_ref
  (and _many,     (dirty_delta.cu), float dtypes;  (integer and bool dtypes:
  block_deltas)   _many and block_deltas: one      exact != on any device)
                  launch for many pairs
  ssm_scan        ssm_scan.ssm_scan (ssm_scan.cu)  models/gla.gla_chunked
  flash_attention flash_attention.flash_attention  ref.attention_chunked
                  (flash_attention.cu)
  decode_attention decode_attention                ref.decode_attention_ref
                  .decode_attention
                  (decode_attention.cu): rotary,
                  the ring write and the
                  attention over the ring's
                  valid slots, in place
  ==============  ===============================  ===========================

``power_spectrum`` and ``autocorr_score`` take an optional ``mesh`` (a
1-D ``DeviceMesh``, ``core/shard.decide_mesh``): the rows are then split
over its ranks, each rank launching the kernel on its block, and
all-gathered (``launch/mesh.row_sharded``) -- the kernel half of the
sharded decide plane. Each kernel's row arithmetic does not depend on the
rows it is launched with, so the result is bit-identical to one launch.

A CUDA tensor goes to the hand-written kernel, which launches or raises;
there is no fallback to the plain version and no shape the kernel hands
back. A CPU tensor goes to the plain version, which is where the CPU tests
run. ``launch_counts`` reads the kernels' launch counters.

Under grad (training), ``ssm_scan`` and ``flash_attention`` return through
the ``torch.autograd.Function``s of ``kernels/vjp.py`` when an input
requires a gradient: the same forward as above, and a plain PyTorch
backward (the VJP of the chunked plain version, recomputed), as the JAX
package differentiates its XLA functions and never a kernel. With grad
off the path is the one above.

B4, B5 and decode attention are reached through operators of the
dispatcher (``repro_torch::ssm_scan``, ``repro_torch::flash_attention``,
``repro_torch::decode_attention``, which writes its two rings in place).
On a real CUDA tensor the op runs the same wrapper (``_ss.ssm_scan``,
``_fa.flash_attention``, ``_da.decode_attention``), which launches the
kernel or raises. Under ``FakeTensorMode`` (the dry run,
``launch/dryrun.py``) the op's fake form gives the output's shape, dtype
and strides; no library is built or touched. Each op has a flop formula
for ``torch.utils.flop_counter``: B5 4 D flops per causal (query, key)
pair inside the window, B4 the products of its chunked form (equal to the
count of ``models/gla.gla_chunked``), decode attention 4 hd flops per
(query head, ring slot), the count of its plain version's two einsums.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels import autocorr as _ac
from repro_torch.kernels import decode_attention as _da
from repro_torch.kernels import dft as _dft
from repro_torch.kernels import dirty_delta as _dd
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import ref
from repro_torch.kernels import ssm_scan as _ss
from repro_torch.kernels import vjp
from repro_torch.launch import mesh as meshlib
from repro_torch.models import gla


def _device_type(x: torch.Tensor) -> str:
    if x.device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {x.device}")
    return x.device.type


def _on_card(x: torch.Tensor) -> bool:
    return x.is_cuda


def _needs_grad(*inputs: Optional[torch.Tensor]) -> bool:
    """Grad mode is on and an input requires a gradient: the op then
    returns through its ``autograd.Function`` (``kernels/vjp.py``)."""
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in inputs)


def power_spectrum(x: torch.Tensor, *, center: bool = False,
                   mesh=None) -> torch.Tensor:
    """(B, N) -> (B, N//2+1) f32 one-sided power spectrum; ``center``
    removes each row's mean first. ``mesh`` splits the rows over its
    ranks."""
    x = x.float()
    if mesh is not None:
        return meshlib.row_sharded(lambda v: _power(v, center), mesh, x)
    return _power(x, center)


def _power(x: torch.Tensor, center: bool) -> torch.Tensor:
    if _device_type(x) == "cuda":
        return _dft.power_spectrum(x, center)
    return ref.power_spectrum_ref(x, center)


def autocorr_score(x: torch.Tensor, lags: torch.Tensor, *,
                   mesh=None) -> torch.Tensor:
    """(J, N) finite mean-removed rows x (L,) shared candidate lags ->
    (J, L) f32 unnormalized autocorrelation scores (lags clamped to
    [0, N]). ``mesh`` splits the rows over its ranks; every rank scores
    the one lag grid."""
    x = x.float()
    if mesh is not None:
        return meshlib.row_sharded(lambda v: _scores(v, lags), mesh, x)
    return _scores(x, lags)


def _scores(x: torch.Tensor, lags: torch.Tensor) -> torch.Tensor:
    if _device_type(x) == "cuda":
        return _ac.autocorr_score(x, lags)
    return ref.autocorr_score_ref(x, lags)


def dirty_blocks(new: torch.Tensor, old: torch.Tensor,
                 threshold: float = 0.0, *,
                 block: Optional[int] = None) -> torch.Tensor:
    """(n_blocks, block) x2 -> (n_blocks,) bool dirty mask; with ``block``
    the inputs are read flat in ``ceil(n / block)`` blocks, the last one
    ragged.

    Floating dtypes (f16, bf16, f32, f64) are cast to f32 before the
    difference and a block is dirty when its max |delta| is above
    ``threshold`` (a NaN delta is not). Integer and bool dtypes use an
    exact != (an f32 cast could alias distinct int32 values)."""
    if block is None:
        block = new.shape[1]
    if not new.dtype.is_floating_point:
        return ref.block_reduce(new.reshape(-1) != old.reshape(-1), block,
                                torch.any)
    if _device_type(new) == "cuda":
        d = _dd.max_abs_delta(new, old, block)
    else:
        d = ref.max_abs_delta_ref(new, old, block)
    return d[:, 0] > threshold


def _card_deltas(news: Sequence[torch.Tensor],
                 olds: Sequence[torch.Tensor], block: int
                 ) -> List[Tuple[List[int], torch.Tensor, List[int]]]:
    """B3 on the float pairs that lie on a card, those of each card
    together in one launch per ``dirty_delta.MAX_LEAVES`` pairs -> per
    card (the pairs' indices, their per-block maxima end to end, each
    pair's ``ceil(n_i / block)``)."""
    cards: Dict[torch.device, List[int]] = {}
    for i, new in enumerate(news):
        if new.dtype.is_floating_point and _on_card(new):
            cards.setdefault(new.device, []).append(i)
    return [(idx, _dd.max_abs_delta_many([news[i] for i in idx],
                                         [olds[i] for i in idx], block),
             [-(-news[i].numel() // block) for i in idx])
            for idx in cards.values()]


def dirty_blocks_many(news: Sequence[torch.Tensor],
                      olds: Sequence[torch.Tensor], threshold: float = 0.0,
                      *, block: int) -> Tuple[List[torch.Tensor], List[int]]:
    """``dirty_blocks`` of each pair, read flat -> (one (ceil(n_i / block),)
    bool mask per pair, each pair's number of dirty blocks). The float
    pairs on each card go to B3 together (``_card_deltas``) before the
    rest; the counts come back in one transfer per device."""
    masks: List[Optional[torch.Tensor]] = [None] * len(news)
    parts = []                       # (pairs, their counts on a device)
    for idx, d, sizes in _card_deltas(news, olds, block):
        dirty = d > threshold
        run = torch.zeros(d.numel() + 1, dtype=torch.int64, device=d.device)
        torch.cumsum(dirty, 0, out=run[1:])
        ends, e = [run[0]], 0
        for size in sizes:
            e += size
            ends.append(run[e])
        parts.append((idx, torch.diff(torch.stack(ends))))
        for i, m in zip(idx, dirty.split(sizes)):
            masks[i] = m
    for i, m in enumerate(masks):
        if m is None:
            masks[i] = dirty_blocks(news[i].reshape(-1), olds[i].reshape(-1),
                                    threshold, block=block)
            parts.append(([i], masks[i].sum().reshape(1)))
    counts = [0] * len(news)
    devices: Dict[torch.device, list] = {}
    for idx, c in parts:
        devices.setdefault(c.device, []).append((idx, c))
    for group in devices.values():
        values = torch.cat([c for _, c in group]).tolist()
        for i, v in zip([i for idx, _ in group for i in idx], values):
            counts[i] = int(v)
    return masks, counts


def block_deltas(news: Sequence[torch.Tensor], olds: Sequence[torch.Tensor],
                 *, block: int) -> List[torch.Tensor]:
    """Per-block ``max |f32(new) - f32(old)|`` of float pairs, read flat ->
    one (ceil(n_i / block),) f32 tensor per pair, NaN where a block holds a
    NaN difference. The pairs on each card go to B3 together
    (``_card_deltas``), CPU pairs to the plain version."""
    out: List[Optional[torch.Tensor]] = [None] * len(news)
    for i, new in enumerate(news):
        if not new.dtype.is_floating_point:
            raise ValueError(f"block_deltas takes float pairs, got "
                             f"{new.dtype}")
        if not _on_card(new):
            out[i] = ref.max_abs_delta_ref(new, olds[i], block)[:, 0]
    for idx, d, sizes in _card_deltas(news, olds, block):
        for i, part in zip(idx, d.split(sizes)):
            out[i] = part
    return out


# ---------------------------------------------------------------------------
# B4 and B5 as dispatcher operators: the kernel on a real CUDA tensor, a
# fake form under FakeTensorMode, a flop formula. Registered with
# ``torch.library.Library`` (a kernel at the CUDA key), not with
# ``torch.library.custom_op``, whose first call imports the compiler stack
# (seconds, on a process's first prefill or train step).
# ---------------------------------------------------------------------------
_LIB = torch.library.Library("repro_torch", "DEF")
_LIB.define("ssm_scan(Tensor q, Tensor k, Tensor v, Tensor log_decay, "
            "Tensor? bonus, Tensor? initial_state) -> (Tensor, Tensor)")
_LIB.define("flash_attention(Tensor q, Tensor k, Tensor v, int window, "
            "float scale=0.0) -> Tensor")
_LIB.define("decode_attention(Tensor q, Tensor k, Tensor v, Tensor angles, "
            "Tensor(a!) k_ring, Tensor(b!) v_ring, Tensor cache_pos, "
            "int window, float scale, int kv0, int kv1) -> Tensor")


def _ssm_scan_cuda(q, k, v, log_decay, bonus, initial_state):
    return _ss.ssm_scan(q, k, v, log_decay, bonus, initial_state)


def _flash_attention_cuda(q, k, v, window, scale=0.0):
    """B5's output in its (B, S, H, D) memory order."""
    return _fa.flash_attention(q, k, v, window, scale).transpose(1, 2)


_LIB.impl("ssm_scan", _ssm_scan_cuda, "CUDA")
_LIB.impl("flash_attention", _flash_attention_cuda, "CUDA")
_LIB.impl("decode_attention", _da.decode_attention, "CUDA")


@torch.library.register_fake("repro_torch::ssm_scan")
def _(q, k, v, log_decay, bonus, initial_state):
    B, H, S, Dk = q.shape
    Dv = v.shape[-1]
    return (q.new_empty((B, H, S, Dv), dtype=torch.float32),
            q.new_empty((B, H, Dk, Dv), dtype=torch.float32))


@torch.library.register_fake("repro_torch::flash_attention")
def _(q, k, v, window, scale=0.0):
    B, H, S, D = q.shape
    return q.new_empty((B, S, H, D))


@torch.library.register_fake("repro_torch::decode_attention")
def _(q, k, v, angles, k_ring, v_ring, cache_pos, window, scale, kv0, kv1):
    B, _, n, hd = q.shape
    return q.new_empty((B, 1, n * hd))


def attention_pairs(S: int, window: int) -> int:
    """Causal (query, key) pairs of S positions, trimmed to the window
    when one is set."""
    if window <= 0 or window >= S:
        return S * (S + 1) // 2
    return window * (window + 1) // 2 + (S - window) * window


def scan_flops(B: int, H: int, S: int, Dk: int, Dv: int, rwkv: bool) -> int:
    """The products of the chunked scan (chunks of ``gla.CHUNK``, S padded
    to a multiple), 2 flops each: a chunk's q k^T and its scores times v
    (Q^2 Dk and Q^2 Dv), its state summary and its inter-chunk read-out
    (Q Dk Dv each), and RWKV's bonus diagonal (Q Dk)."""
    Q = gla.CHUNK
    per_chunk = Q * Q * (Dk + Dv) + 2 * Q * Dk * Dv + (Q * Dk if rwkv else 0)
    return 2 * B * H * -(-S // Q) * per_chunk


@register_flop_formula(torch.ops.repro_torch.flash_attention)
def _attention_flops(q_shape, k_shape, v_shape, window, *args,
                     out_shape=None, **kwargs) -> int:
    B, H, S, D = q_shape
    return 4 * D * B * H * attention_pairs(S, window)


@register_flop_formula(torch.ops.repro_torch.decode_attention)
def _decode_flops(q_shape, k_shape, v_shape, angles_shape, ring_shape,
                  *args, out_shape=None, **kwargs) -> int:
    B, _, n, hd = q_shape
    return 4 * hd * B * n * ring_shape[1]


@register_flop_formula(torch.ops.repro_torch.ssm_scan)
def _scan_flops(q_shape, k_shape, v_shape, log_decay_shape, bonus_shape,
                *args, out_shape=None, **kwargs) -> int:
    B, H, S, Dk = q_shape
    return scan_flops(B, H, S, Dk, v_shape[-1], bonus_shape is not None)


def ssm_scan(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             log_decay: torch.Tensor, *, bonus: Optional[torch.Tensor] = None,
             initial_state: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked gated-linear-attention scan: q, k, log_decay (B, H, S, Dk),
    v (B, H, S, Dv), any strides -> (y (B, H, S, Dv) f32, final state
    (B, H, Dk, Dv) f32). ``bonus`` (H, Dk) selects RWKV semantics, else
    SSD; ``initial_state`` (B, H, Dk, Dv) defaults to zeros."""
    if _needs_grad(q, k, v, log_decay, bonus, initial_state):
        return vjp.Scan.apply(q, k, v, log_decay, bonus, initial_state,
                              _ssm_scan)
    return _ssm_scan(q, k, v, log_decay, bonus, initial_state)


def _ssm_scan(q, k, v, log_decay, bonus, initial_state):
    if _device_type(q) == "cuda":
        return torch.ops.repro_torch.ssm_scan(q, k, v, log_decay, bonus,
                                              initial_state)
    return gla.gla_chunked(q, k, v, log_decay, bonus=bonus,
                           initial_state=initial_state)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    window: int = 0, chunk: Optional[int] = None,
                    scale: Optional[float] = None) -> torch.Tensor:
    """Causal GQA attention: q (B, H, S, D), k and v (B, Hkv, S, D), any
    strides, query head h reading kv head h // (H // Hkv); ``window > 0``
    adds the sliding window; ``scale`` multiplies q . k (default
    ``D**-0.5``). Returns (B, H, S, D) in q's dtype. The CPU path runs the
    model's chunked online softmax over kv chunks of ``chunk`` (default
    ``ref.ATTN_CHUNK``; one pass when S <= chunk)."""
    chunk = ref.ATTN_CHUNK if chunk is None else chunk

    def forward(q, k, v):
        if _device_type(q) == "cuda":
            return torch.ops.repro_torch.flash_attention(
                q, k, v, window, 0.0 if scale is None else scale
            ).transpose(1, 2)
        return ref.attention_chunked(q, k, v, window=window, chunk=chunk,
                                     scale=scale)

    if _needs_grad(q, k, v):
        return vjp.Attention.apply(q, k, v, window, chunk, forward, scale)
    return forward(q, k, v)


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     angles: torch.Tensor, ring, cache_pos: torch.Tensor, *,
                     window: int = 0, scale: Optional[float] = None,
                     kv: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """One token's attention against a KV ring ``ring`` = (k, v), each
    (B, W, heads, hd): q (B, 1, n, hd) and k, v (B, 1, heads, hd) before
    rotary, ``angles`` (B, 1, hd/2) f32, ``cache_pos`` 0-dim. Rotary on q
    and k, the token's k and v written into slot ``cache_pos`` % W in
    place, the query heads reading the ring's KV heads ``kv`` = [kv0, kv1)
    (every head by default) in GQA groups over the valid slots (``window``
    > 0: the sliding window's), scores scaled by ``scale`` (default
    ``hd**-0.5``). Returns (B, 1, n hd) in q's dtype."""
    ck, cv = ring
    kv0, kv1 = kv or (0, ck.shape[2])
    if _device_type(q) == "cuda":
        return torch.ops.repro_torch.decode_attention(
            q, k, v, angles, ck, cv, cache_pos, window,
            0.0 if scale is None else scale, kv0, kv1)
    return ref.decode_attention_ref(q, k, v, angles, ring, cache_pos,
                                    window=window, scale=scale,
                                    kv=(kv0, kv1))


KERNELS = {"power_spectrum": _dft.power_spectrum,
           "autocorr_score": _ac.autocorr_score,
           "dirty_blocks": _dd.max_abs_delta,
           "ssm_scan": _ss.ssm_scan,
           "flash_attention": _fa.flash_attention,
           "decode_attention": _da.decode_attention}


def launch_counts() -> Dict[str, int]:
    """op -> number of kernel launches so far in this process."""
    return {name: fn.launches for name, fn in KERNELS.items()}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0

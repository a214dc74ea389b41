"""Plain PyTorch versions of the hand-written kernels.

They compute the same functions as ``csrc/dft_power.cu``,
``csrc/autocorr.cu`` and ``csrc/dirty_delta.cu`` on the same inputs, by the
same sums: the DFT as explicit cos/sin products over every time step, the
autocorrelation as the lag products of each row, the dirty-block scan as a
max of exact f32 differences per block. The first two accumulate in float64
and return float32, which makes them the yardstick the f32 kernels are held
to on the card; the third must equal its kernel bit for bit.
``kernels/ops.py`` sends every CPU tensor here, so they are also the CPU
path of the port.

The SSM scan (``csrc/ssm_scan.cu``) has two: its chunked plain version,
``models/gla.gla_chunked`` (the op's CPU path), and ``ssm_scan_ref`` here,
the token-by-token recurrence of decode, which shares nothing with the
chunked decomposition and is the strongest oracle for both.

So has flash attention (``csrc/flash_attention.cu``): its chunked plain
version, ``chunked_causal_attention`` (the model's layout) and
``attention_chunked`` (the kernel's (B, H, S, D) layout around it, the op's
CPU path), and ``attention_ref``, the naive softmax over the whole masked
score matrix, for tests and ``chip_smoke.py`` only.

Decode attention (``csrc/decode_attention.cu``) has one,
``decode_attention_ref``: the model's decode composition as it was before
the kernel, ``apply_rope`` on q and k, the ring write, then the two
einsums over the whole masked ring (``decode_valid``).
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Callable, Optional, Tuple

import torch

from repro_torch.models import gla

MASK_FILL = -1e30         # attention's fill for masked scores
ATTN_CHUNK = 512          # the plain attention's kv chunk
_TABLE_CACHE_MAX = 2
_TABLE_CACHE: "OrderedDict[tuple, Tuple[torch.Tensor, torch.Tensor]]" = \
    OrderedDict()


def apply_rope(x: torch.Tensor, angles: torch.Tensor) -> torch.Tensor:
    """x: (B, S, H, D); angles: (B, S, D/2). Rotate-half convention."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    cos = torch.cos(angles)[:, :, None, :].to(x.dtype)
    sin = torch.sin(angles)[:, :, None, :].to(x.dtype)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def dft_tables(n: int, device: torch.device
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(cos, sin) (n, n//2+1) f64 weights ``W[t, f] = cos/sin(2 pi t f / n)``
    with the phase index ``(t * f) mod n`` taken exactly in integers, as the
    kernel does. The last two sizes stay cached."""
    key = (n, str(device))
    if key in _TABLE_CACHE:
        _TABLE_CACHE.move_to_end(key)
        return _TABLE_CACHE[key]
    t = torch.arange(n, dtype=torch.int64, device=device)
    f = torch.arange(n // 2 + 1, dtype=torch.int64, device=device)
    ang = (2.0 * torch.pi / n) * ((t[:, None] * f[None, :]) % n).double()
    tables = (torch.cos(ang), torch.sin(ang))
    _TABLE_CACHE[key] = tables
    while len(_TABLE_CACHE) > _TABLE_CACHE_MAX:
        _TABLE_CACHE.popitem(last=False)
    return tables


def power_spectrum_ref(x: torch.Tensor, center: bool = False) -> torch.Tensor:
    """(B, N) -> (B, N//2+1) f32 one-sided power spectrum, by the DFT sums
    ``(x . cos_f)^2 + (x . sin_f)^2``; ``center`` removes each row's mean."""
    x64 = x.double()
    if center:
        x64 = x64 - x64.mean(dim=1, keepdim=True)
    cos_w, sin_w = dft_tables(x.shape[1], x.device)
    re, im = x64 @ cos_w, x64 @ sin_w
    return (re * re + im * im).float()


def autocorr_score_ref(x: torch.Tensor, lags: torch.Tensor) -> torch.Tensor:
    """(J, N) rows x (L,) lags -> (J, L) f32
    ``R[j, l] = sum_{t < N - lag} x[j, t] x[j, t + lag]``, lags clamped to
    [0, N] (lag N scores 0)."""
    x64 = x.double()
    J, N = x64.shape
    out = torch.zeros((J, lags.shape[0]), dtype=torch.float64,
                      device=x.device)
    for li, p in enumerate(lags.clamp(0, N).tolist()):
        if p < N:
            out[:, li] = (x64[:, : N - p] * x64[:, p:]).sum(dim=1)
    return out.float()


def block_reduce(x: torch.Tensor, block: int,
                 reduce: Callable[..., torch.Tensor]) -> torch.Tensor:
    """``reduce(rows, dim=1)`` over the ``ceil(n / block)`` blocks of the
    flat ``x``; the ragged last block is reduced as it is, not padded."""
    flat = x.reshape(-1)
    full = flat.numel() // block
    parts = [reduce(flat[: full * block].view(full, block), dim=1)]
    if flat.numel() > full * block:
        parts.append(reduce(flat[full * block:].view(1, -1), dim=1))
    return torch.cat(parts)


def max_abs_delta_ref(new: torch.Tensor, old: torch.Tensor,
                      block: Optional[int] = None) -> torch.Tensor:
    """Per-block ``max |f32(new) - f32(old)|`` -> (n_blocks, 1) f32, NaN
    where a block holds a NaN difference. ``block=None`` takes
    (n_blocks, block) tiles; else the flat inputs are cut into
    ``ceil(n / block)`` blocks, the last one as if zero-padded (a padded
    |0 - 0| adds nothing to a max of absolute values)."""
    if block is None:
        block = new.shape[1]
    d = (new.reshape(-1).float() - old.reshape(-1).float()).abs()
    return block_reduce(d, block, torch.amax)[:, None]


def ssm_scan_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 log_decay: torch.Tensor, *,
                 bonus: Optional[torch.Tensor] = None,
                 initial_state: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The SSM scan token by token (``gla.gla_decode_step`` S times):
    q/k/log_decay (B, H, S, Dk), v (B, H, S, Dv) -> (y (B, H, S, Dv) f32,
    final state (B, H, Dk, Dv) f32). ``bonus`` (H, Dk) selects RWKV
    semantics, else SSD; ``initial_state`` defaults to zeros."""
    B, H, S, Dk = q.shape
    state = (torch.zeros((B, H, Dk, v.shape[-1]), dtype=torch.float32,
                         device=q.device)
             if initial_state is None else initial_state.float())
    ys = []
    for t in range(S):
        y, state = gla.gla_decode_step(q[:, :, t], k[:, :, t], v[:, :, t],
                                       log_decay[:, :, t], state, bonus=bonus)
        ys.append(y)
    return torch.stack(ys, dim=2), state


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  window: int = 0, scale: Optional[float] = None
                  ) -> torch.Tensor:
    """Naive causal GQA attention: q (B, H, S, D), k and v (B, Hkv, S, D)
    -> (B, H, S, D) in q's dtype. The kv heads are repeated G = H / Hkv
    times, the scores taken in f32 times ``scale`` (default ``D**-0.5``),
    masked entries (the future, and with ``window > 0`` keys ``window`` or
    more behind) filled with -1e30, and the softmax taken in f32."""
    B, H, S, D = q.shape
    G = H // k.shape[1]
    kx = k.repeat_interleave(G, dim=1).float()
    vx = v.repeat_interleave(G, dim=1).float()
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), kx) * (
        D ** -0.5 if scale is None else scale)
    pos = torch.arange(S, device=q.device)
    mask = pos[:, None] >= pos[None, :]
    if window > 0:
        mask &= (pos[:, None] - pos[None, :]) < window
    s = torch.where(mask, s, -1e30)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, vx).to(q.dtype)


def _attn_scores_mask(q_pos: torch.Tensor, k_pos: torch.Tensor,
                      window: int) -> torch.Tensor:
    """Causal (+ optional sliding window) mask. q_pos/k_pos: (Sq,), (Sk,)."""
    causal = q_pos[:, None] >= k_pos[None, :]
    if window > 0:
        causal &= q_pos[:, None] - k_pos[None, :] < window
    return causal


def chunked_causal_attention(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, window: int,
                             chunk: int = ATTN_CHUNK,
                             scale: Optional[float] = None) -> torch.Tensor:
    """Memory-O(S·chunk) causal attention (online softmax over KV chunks).

    Outer loop over query chunks (the triangular structure is static, so
    no masked-out chunk is computed), inner loop over the causal KV range
    with a running (m, l, acc); SWA trims the range to the window.

    q: (B, S, Hkv, G, hd); k, v: (B, S, Hkv, hd) -> (B, S, Hkv, G, hd);
    the scores scaled by ``scale`` (default hd^-0.5).
    """
    B, S, Hkv, G, hd = q.shape
    scale = hd ** -0.5 if scale is None else scale
    if S <= chunk:
        logits = torch.einsum("bqhgd,bkhd->bhgqk", q, k).float() * scale
        pos = torch.arange(S, device=q.device)
        mask = _attn_scores_mask(pos, pos, window)
        logits = torch.where(mask, logits, MASK_FILL)
        probs = torch.softmax(logits, dim=-1).to(q.dtype)
        return torch.einsum("bhgqk,bkhd->bqhgd", probs, v)

    assert S % chunk == 0, (S, chunk)
    nq = S // chunk
    pos = torch.arange(chunk, device=q.device)
    blocks = []
    for qi in range(nq):
        # causal range: kv chunks [lo, qi]; SWA trims lo to the window
        lo = 0 if window <= 0 else max(0, qi - (window + chunk - 1) // chunk)
        q_blk = q[:, qi * chunk:(qi + 1) * chunk]
        q_pos = qi * chunk + pos
        m = torch.full((B, Hkv, G, chunk), -torch.inf, dtype=torch.float32,
                       device=q.device)
        l = torch.zeros((B, Hkv, G, chunk), dtype=torch.float32,
                        device=q.device)
        acc = torch.zeros((B, Hkv, G, chunk, hd), dtype=q.dtype,
                          device=q.device)
        for kj in range(lo, qi + 1):
            k_blk = k[:, kj * chunk:(kj + 1) * chunk]
            v_blk = v[:, kj * chunk:(kj + 1) * chunk]
            s = torch.einsum("bqhgd,bkhd->bhgqk", q_blk, k_blk).float() * scale
            mask = _attn_scores_mask(q_pos, kj * chunk + pos, window)
            s = torch.where(mask, s, MASK_FILL)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            pv = torch.einsum("bhgqk,bkhd->bhgqd", p.to(v_blk.dtype), v_blk)
            acc = acc * corr[..., None].to(acc.dtype) + pv
            m = m_new
        out = acc / torch.clamp(l, min=1e-30)[..., None].to(acc.dtype)
        blocks.append(out.permute(0, 3, 1, 2, 4))        # (B, chunk, Hkv, G, hd)
    return torch.cat(blocks, dim=1)


def attention_chunked(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      window: int = 0, chunk: int = ATTN_CHUNK,
                      scale: Optional[float] = None) -> torch.Tensor:
    """``chunked_causal_attention`` on the kernel's layout: q (B, H, S, D),
    k and v (B, Hkv, S, D), any strides -> (B, H, S, D) in q's dtype."""
    B, H, S, D = q.shape
    Hkv = k.shape[1]
    out = chunked_causal_attention(
        q.transpose(1, 2).reshape(B, S, Hkv, H // Hkv, D),
        k.transpose(1, 2), v.transpose(1, 2), window, chunk=chunk,
        scale=scale)
    return out.reshape(B, S, H, D).transpose(1, 2)


def decode_valid(window: int, W: int, cache_pos, slot, idx):
    """Which ring slots ``idx`` (of a ring of ``W``) hold tokens the new
    one at ``cache_pos`` (ring slot ``slot``) attends to: with a sliding
    ``window`` > 0 those inside it, else every slot written so far."""
    if window > 0:
        abs_pos = torch.where(idx <= slot, cache_pos - slot + idx,
                              cache_pos - slot + idx - W)
        return (abs_pos >= 0) & (abs_pos > cache_pos - window)
    return idx < cache_pos + 1


def decode_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         angles: torch.Tensor, ring, cache_pos, *,
                         window: int = 0, scale: Optional[float] = None,
                         kv: Optional[Tuple[int, int]] = None
                         ) -> torch.Tensor:
    """One token's decode against a ring that holds every slot of the
    window: ``q`` (B, 1, n, hd) and ``k``/``v`` (B, 1, heads, hd), the
    heads the ring holds, before rotary; ``angles`` (B, 1, hd/2). Rotary
    on q and k, then k/v written into slot ``cache_pos`` % W in place; the
    query heads read the ring's KV heads ``kv`` = [kv0, kv1) (all of them
    by default) in GQA groups, the scores scaled by ``scale`` (default
    ``hd**-0.5``). Returns (B, 1, n hd)."""
    q, k = apply_rope(q, angles), apply_rope(k, angles)
    ck, cv = ring
    B, _, n, hd = q.shape
    W = ck.shape[1]
    slot = torch.remainder(cache_pos, W).long()
    ck.index_copy_(1, slot.view(1), k.to(ck.dtype))
    cv.index_copy_(1, slot.view(1), v.to(cv.dtype))
    kv0, kv1 = kv or (0, ck.shape[2])
    ck, cv = ck[:, :, kv0:kv1], cv[:, :, kv0:kv1]
    qh = q.reshape(B, 1, kv1 - kv0, n // (kv1 - kv0), hd)
    logits = (torch.einsum("bqhgd,bkhd->bhgqk", qh, ck).float()
              * (scale or hd ** -0.5))
    logits = torch.where(decode_valid(window, W, cache_pos, slot,
                                      torch.arange(W, device=q.device)),
                         logits, MASK_FILL)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhgqk,bkhd->bqhgd", probs, cv).reshape(B, 1, n * hd)

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
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Callable, Optional, Tuple

import torch

from repro_torch.models import gla

_TABLE_CACHE_MAX = 2
_TABLE_CACHE: "OrderedDict[tuple, Tuple[torch.Tensor, torch.Tensor]]" = \
    OrderedDict()


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

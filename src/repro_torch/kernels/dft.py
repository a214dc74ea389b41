"""Wrapper of the hand-written DFT power-spectrum kernels
(``csrc/dft_power.cu``).

Replaces the Pallas TPU kernel ``repro/kernels/dft.py`` (``dft_power``),
the cycle-recognition spectrum of every surveillance tick. The TPU version
ran two N x N matmuls on the MXU; on Hopper an f32 product on the tensor
cores is TF32 and misses the spectrum tolerance, so both routes run on the
CUDA cores, and the function's least time is set by the bytes it moves.

Two routes, chosen by N (``route``):

- ``"fft"``, every 5-smooth N (all the paths send: 512, 600, 1,440,
  2,880, 4,096): a Stockham mixed-radix FFT of each row in shared memory,
  one pass per radix of ``fft_plan(N)``, twiddles from a length-N f32
  table built once per N in f64 and kept on the card (``twiddles``).
- ``"direct"``, N with a prime factor above 5: the DFT sums with the
  twiddles taken from a length-N table by an exact integer phase index,
  B * (N//2+1) * N complex multiply-adds.

Mean removal is fused into both prologues. This wrapper only launches: it
takes CUDA tensors and raises on anything else. The plain version lives in
``kernels/ref.py``; ``kernels/ops.py`` chooses between the two by the
tensor's device.
"""
from __future__ import annotations

import ctypes
import math
from collections import OrderedDict
from typing import Dict, List, Optional

import torch

from repro_torch.kernels import build

#: the shared-memory buffer caps N (one complex row of N f32 pairs on the
#: FFT route; 2 * N f32 table entries beside the tiles on the direct one)
MAX_N = 16384
_TWIDDLE_CACHE_MAX = 8
_TWIDDLES: "OrderedDict[tuple, torch.Tensor]" = OrderedDict()
#: N -> the FFT plan as the C entry takes it (None: the direct route)
_PLANS: Dict[int, Optional[ctypes.Array]] = {}


def fft_plan(n: int) -> Optional[List[int]]:
    """The FFT route's radices for N, in the kernel's pass order (8s, then
    a 4 or a 2, then 5s, then 3s), or None when N has a prime factor above
    5 (the direct route)."""
    if n < 2:
        return None
    counts = {}
    for p in (2, 3, 5):
        counts[p] = 0
        while n % p == 0:
            n //= p
            counts[p] += 1
    if n != 1:
        return None
    eights, rest = divmod(counts[2], 3)
    return ([8] * eights + ([4] if rest == 2 else [2] if rest == 1 else [])
            + [5] * counts[5] + [3] * counts[3])


def route(n: int) -> str:
    """``"fft"`` for a 5-smooth N, else ``"direct"``."""
    return "direct" if fft_plan(n) is None else "fft"


def twiddles(n: int, device: torch.device) -> torch.Tensor:
    """(N, 2) f32 ``W_N^m = exp(-2 pi i m / N)`` as (re, im), computed in
    f64; the last few sizes stay cached per device."""
    key = (n, str(device))
    if key in _TWIDDLES:
        _TWIDDLES.move_to_end(key)
        return _TWIDDLES[key]
    ang = (2.0 * math.pi / n) * torch.arange(n, dtype=torch.float64,
                                             device=device)
    table = torch.stack([torch.cos(ang), -torch.sin(ang)], dim=1).float()
    _TWIDDLES[key] = table.contiguous()
    while len(_TWIDDLES) > _TWIDDLE_CACHE_MAX:
        _TWIDDLES.popitem(last=False)
    return _TWIDDLES[key]


def power_spectrum(x: torch.Tensor, center: bool = False) -> torch.Tensor:
    """x: (B, N) f32 CUDA, 2 <= N <= MAX_N -> (B, N//2+1) f32 one-sided
    power spectrum; ``center`` removes each row's mean in the kernel."""
    if x.device.type != "cuda":
        raise ValueError(f"dft kernel needs a CUDA tensor, got {x.device}")
    if x.dim() != 2 or x.dtype != torch.float32:
        raise ValueError(f"dft kernel takes (B, N) float32, got "
                         f"{tuple(x.shape)} {x.dtype}")
    B, N = x.shape
    if not 2 <= N <= MAX_N:
        raise ValueError(f"dft kernel takes 2 <= N <= {MAX_N}, got {N}")
    x = x.contiguous()
    out = torch.empty((B, N // 2 + 1), dtype=torch.float32, device=x.device)
    if B == 0:
        return out
    lib = build.load("dft_power")
    if N not in _PLANS:
        plan = fft_plan(N)
        _PLANS[N] = None if plan is None else (ctypes.c_int * len(plan))(*plan)
    radix = _PLANS[N]
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        if radix is None:
            err = lib.dft_power_launch(x.data_ptr(), out.data_ptr(), B, N,
                                       int(bool(center)), stream)
        else:
            tw = twiddles(N, x.device)
            err = lib.dft_power_fft_launch(
                x.data_ptr(), out.data_ptr(), tw.data_ptr(), B, N,
                int(bool(center)), ctypes.addressof(radix), len(radix),
                stream)
    if err:
        raise RuntimeError(f"dft_power kernel launch failed: cudaError {err}")
    power_spectrum.launches += 1
    return out


power_spectrum.launches = 0

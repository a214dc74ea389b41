"""Wrapper of the hand-written autocorrelation kernel (``csrc/autocorr.cu``).

Replaces the Pallas TPU kernel ``repro/kernels/autocorr.py``
(``autocorr_score``): the period refinement of the cycle fit scores every
job's mean-removed row against one shared grid of candidate lags. This
direct method is bound by its operations (J * sum over lags of N - lag
multiply-adds); the function needs less (Wiener-Khinchin), so its least
time is set by the bytes it moves. One block
per (row, lag tile) keeps the row in shared memory; each warp reduces one
lag with shuffles in a fixed order, with no atomics, so the result is the
same on every run.

This wrapper only launches: it takes CUDA tensors and raises on anything
else. The plain version lives in ``kernels/ref.py``; ``kernels/ops.py``
chooses between the two by the tensor's device.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build

#: the row is staged whole in shared memory
MAX_N = 16384


def autocorr_score(x: torch.Tensor, lags: torch.Tensor) -> torch.Tensor:
    """x: (J, N) f32 CUDA rows, lags: (L,) integer CUDA -> (J, L) f32
    ``R[j, l] = sum_{t < N - lag} x[j, t] x[j, t + lag]``, lags clamped to
    [0, N]."""
    if x.device.type != "cuda" or lags.device != x.device:
        raise ValueError(f"autocorr kernel needs CUDA tensors on one device, "
                         f"got {x.device} and {lags.device}")
    if x.dim() != 2 or x.dtype != torch.float32 or lags.dim() != 1:
        raise ValueError(f"autocorr kernel takes (J, N) float32 and (L,) "
                         f"lags, got {tuple(x.shape)} {x.dtype} and "
                         f"{tuple(lags.shape)}")
    J, N = x.shape
    if not 1 <= N <= MAX_N:
        raise ValueError(f"autocorr kernel takes 1 <= N <= {MAX_N}, got {N}")
    x = x.contiguous()
    lags = lags.to(torch.int32).contiguous()
    L = lags.shape[0]
    out = torch.empty((J, L), dtype=torch.float32, device=x.device)
    if J == 0 or L == 0:
        return out
    lib = build.load("autocorr")
    with torch.cuda.device(x.device):
        err = lib.autocorr_launch(
            x.data_ptr(), lags.data_ptr(), out.data_ptr(), J, N, L,
            torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError(f"autocorr kernel launch failed: cudaError {err}")
    autocorr_score.launches += 1
    return out


autocorr_score.launches = 0

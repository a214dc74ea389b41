"""Wrapper of the hand-written DFT power-spectrum kernel (``csrc/dft_power.cu``).

Replaces the Pallas TPU kernel ``repro/kernels/dft.py`` (``dft_power``),
the cycle-recognition spectrum of every surveillance tick. The TPU version
ran two N x N matmuls on the MXU; on Hopper an f32 product on the tensor
cores is TF32 and misses the spectrum tolerance, so the kernel runs on the
CUDA cores with the twiddles taken from a length-N table by an exact
integer phase index. This direct method is bound by its operations
(B * (N//2+1) * N complex multiply-adds); the function needs only an FFT's
O(N log N) per row, so its least time is set by the bytes it moves. Mean
removal is fused into its prologue.

This wrapper only launches: it takes CUDA tensors and raises on anything
else. The plain version lives in ``kernels/ref.py``; ``kernels/ops.py``
chooses between the two by the tensor's device.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build

#: the shared-memory cos/sin table caps N (2 * N f32 beside the tiles)
MAX_N = 16384


def power_spectrum(x: torch.Tensor, center: bool = False) -> torch.Tensor:
    """x: (B, N) f32 CUDA, N >= 2 -> (B, N//2+1) f32 one-sided power
    spectrum; ``center`` removes each row's mean in the kernel."""
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
    with torch.cuda.device(x.device):
        err = lib.dft_power_launch(
            x.data_ptr(), out.data_ptr(), B, N, int(bool(center)),
            torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError(f"dft_power kernel launch failed: cudaError {err}")
    power_spectrum.launches += 1
    return out


power_spectrum.launches = 0

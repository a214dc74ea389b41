"""The port's accelerated ops, dispatched by the tensor's device: the cycle
fit's spectrum and lag scores, and pre-copy's dirty-block scan.

  ==============  ===============================  ===========================
  op              CUDA tensor                      CPU tensor
  ==============  ===============================  ===========================
  power_spectrum  dft.power_spectrum (dft_power.cu) ref.power_spectrum_ref
  autocorr_score  autocorr.autocorr_score          ref.autocorr_score_ref
                  (autocorr.cu)
  dirty_blocks    dirty_delta.max_abs_delta        ref.max_abs_delta_ref
                  (dirty_delta.cu), float dtypes   (integer and bool dtypes:
                                                   exact != on any device)
  ==============  ===============================  ===========================

A CUDA tensor goes to the hand-written kernel, which launches or raises;
there is no fallback to the plain version and no shape the kernel hands
back. A CPU tensor goes to the plain version, which is where the CPU tests
run. ``launch_counts`` reads the kernels' launch counters.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.kernels import autocorr as _ac
from repro_torch.kernels import dft as _dft
from repro_torch.kernels import dirty_delta as _dd
from repro_torch.kernels import ref


def _device_type(x: torch.Tensor) -> str:
    if x.device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {x.device}")
    return x.device.type


def power_spectrum(x: torch.Tensor, *, center: bool = False) -> torch.Tensor:
    """(B, N) -> (B, N//2+1) f32 one-sided power spectrum; ``center``
    removes each row's mean first."""
    x = x.float()
    if _device_type(x) == "cuda":
        return _dft.power_spectrum(x, center)
    return ref.power_spectrum_ref(x, center)


def autocorr_score(x: torch.Tensor, lags: torch.Tensor) -> torch.Tensor:
    """(J, N) mean-removed rows x (L,) shared candidate lags -> (J, L) f32
    unnormalized autocorrelation scores (lags clamped to [0, N])."""
    x = x.float()
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


KERNELS = {"power_spectrum": _dft.power_spectrum,
           "autocorr_score": _ac.autocorr_score,
           "dirty_blocks": _dd.max_abs_delta}


def launch_counts() -> Dict[str, int]:
    """op -> number of kernel launches so far in this process."""
    return {name: fn.launches for name, fn in KERNELS.items()}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0

"""The cycle fit's two accelerated ops, dispatched by the tensor's device.

  ==============  ===============================  ===========================
  op              CUDA tensor                      CPU tensor
  ==============  ===============================  ===========================
  power_spectrum  dft.power_spectrum (dft_power.cu) ref.power_spectrum_ref
  autocorr_score  autocorr.autocorr_score          ref.autocorr_score_ref
                  (autocorr.cu)
  ==============  ===============================  ===========================

A CUDA tensor goes to the hand-written kernel, which launches or raises;
there is no fallback to the plain version and no shape the kernel hands
back. A CPU tensor goes to the plain version, which is where the CPU tests
run. ``launch_counts`` reads the kernels' launch counters.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.kernels import autocorr as _ac
from repro_torch.kernels import dft as _dft
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


KERNELS = {"power_spectrum": _dft.power_spectrum,
           "autocorr_score": _ac.autocorr_score}


def launch_counts() -> Dict[str, int]:
    """op -> number of kernel launches so far in this process."""
    return {name: fn.launches for name, fn in KERNELS.items()}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0

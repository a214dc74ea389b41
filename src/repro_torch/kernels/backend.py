"""Device resolution for the port: the card unless the caller asks for the
CPU.

Every entry point that holds fleet-sized tensors (``FleetSim``, ``LMCM``,
``SurveillanceEngine``, ``FleetTelemetry``, the NB model) takes
``device=None``, which resolves to ``cuda``. When no CUDA device is
visible that default raises instead of quietly running on the host: a
CPU run is something the caller asks for by name (``device="cpu"``), as
the tests do. Kernel dispatch (``kernels/ops.py``) then follows the
device of the tensor it is handed.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` -> ``cuda`` (raises without a visible CUDA device); any
    explicit device is honored, and an explicit ``cuda`` device also
    raises when CUDA is absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available: pass device='cpu' to run the port on "
            "the host")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev

"""Carry weights across from the JAX package.

``repro.models.lm.init_params`` gives a nested dict of arrays; handed over
as numpy (``jax.tree.map(np.asarray, params)``), it maps onto the port's
tensors key for key, since both packages use the same tree. bfloat16
arrives as ``float32`` (exact: every bf16 value is an f32 value), as
``uint16`` bit patterns, or as an array whose dtype is named ``bfloat16``
(read through its bits, so this module needs no package that defines it).
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels.backend import DeviceLike, resolve_device
from repro_torch.models import lm


def _tensor(arr: np.ndarray, dtype: torch.dtype) -> torch.Tensor:
    arr = np.array(arr, order="C")           # writable, contiguous copy
    if arr.dtype.name == "bfloat16" or arr.dtype == np.uint16:
        if dtype != torch.bfloat16:
            raise ValueError(f"bfloat16 bits given for a {dtype} leaf")
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr).to(dtype)


def params_from_numpy(cfg: ArchConfig, params: Dict[str, Any], *,
                      device: DeviceLike = None) -> Dict[str, Any]:
    """The port's params for ``cfg`` from the JAX package's, as numpy.

    Keys and shapes must be those of ``lm.init_params(cfg)``; each leaf
    takes that leaf's dtype (``cfg.dtype``) and lands on ``device``
    (``None`` is the card)."""
    dev = resolve_device(device)
    want = lm.init_params(cfg, device="meta")

    def walk(w, got, path):
        if isinstance(w, dict):
            if not isinstance(got, dict) or set(got) != set(w):
                raise ValueError(f"{path or 'params'}: keys "
                                 f"{sorted(got) if isinstance(got, dict) else type(got).__name__}"
                                 f" != {sorted(w)}")
            return {k: walk(w[k], got[k], f"{path}/{k}") for k in w}
        arr = np.asarray(got)
        if tuple(arr.shape) != tuple(w.shape):
            raise ValueError(f"{path}: shape {arr.shape} != {tuple(w.shape)}")
        return _tensor(arr, w.dtype).to(dev)

    return walk(want, params, "")

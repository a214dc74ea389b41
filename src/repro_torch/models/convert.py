"""Carry weights and train states across from the JAX package.

``repro.models.lm.init_params`` gives a nested dict of arrays; handed over
as numpy (``jax.tree.map(np.asarray, params)``), it maps onto the port's
tensors key for key, since both packages use the same tree; so does
``repro.train.init_train_state``'s state (``train_state_from_numpy``). bfloat16
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

    Keys and shapes must be those of ``lm.init_params(cfg)`` (the MoE
    wirings' ``moe`` and ``dense0`` trees included); each leaf takes that
    leaf's dtype (``cfg.dtype``, or f32 for the leaves the reference keeps
    in f32: the SSM's ``A_log``, ``D``, ``dt_bias``, ``decay_base``,
    ``faaaa`` and the MoE ``router``) and lands on ``device`` (``None`` is
    the card)."""
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


def train_state_from_numpy(cfg: ArchConfig, state: Dict[str, Any], *,
                           device: DeviceLike = None) -> Dict[str, Any]:
    """The port's train state from the JAX package's
    (``repro.train.init_train_state`` after any number of steps), as numpy:
    ``{"params", "opt": {"m", "v", "master", "count"} (AdamW) or
    {"v": {"vr", "vc"} or {"v"} per leaf, "count"} (Adafactor), "step"}``.
    Params take ``params_from_numpy``'s dtypes, moments and master f32,
    ``count`` and ``step`` int32 0-dim, leaf for leaf."""
    dev = resolve_device(device)
    params = params_from_numpy(cfg, state["params"], device=dev)
    opt = state["opt"]
    if set(opt) != ({"v", "count"} if cfg.optimizer == "adafactor"
                    else {"m", "v", "master", "count"}):
        raise ValueError(f"opt keys {sorted(opt)} do not fit "
                         f"{cfg.optimizer!r}")

    def f32(tree):
        if isinstance(tree, dict):
            return {k: f32(v) for k, v in tree.items()}
        return _tensor(np.asarray(tree), torch.float32).to(dev)

    def int32(x):
        return torch.tensor(int(np.asarray(x)), dtype=torch.int32,
                            device=dev)

    moments = {k: f32(v) for k, v in opt.items() if k != "count"}
    return {"params": params, "opt": {**moments, "count": int32(opt["count"])},
            "step": int32(state["step"])}

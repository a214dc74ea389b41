"""Input specs for every (arch x shape) cell: the dry run's stand-ins.

Counterpart of ``repro/launch/specs.py``. The reference describes each
input with a ``jax.ShapeDtypeStruct``; the port with a **meta** tensor,
which has a shape and a dtype and holds no memory. ``launch/dryrun.py``
turns them into fake tensors on the traced device and cuts a rank's
slices from them.

``input_specs(cfg, shape)`` returns (mode, args), where args are the trees
the step function is called with:

  train   -> (train_state, batch)
  prefill -> (params, batch)              # without ``targets``
  decode  -> (params, token, cache)       # serve_step, cache at seq_len
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.models import lm
from repro_torch.train import init_train_state

META = torch.device("meta")


def _spec(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=META)


def batch_specs(cfg: ArchConfig, batch: int, seq: int) -> Dict[str, Any]:
    """tokens and targets (B, S) int32; a frontend's ``prefix_embeds``
    (B, min(prefix, S), d) f32; M-RoPE ``positions`` (3, B, S) int32."""
    specs = {"tokens": _spec((batch, seq), torch.int32),
             "targets": _spec((batch, seq), torch.int32)}
    if cfg.frontend_prefix:
        specs["prefix_embeds"] = _spec(
            (batch, min(cfg.frontend_prefix, seq), cfg.d_model),
            torch.float32)
    if cfg.mrope:
        specs["positions"] = _spec((3, batch, seq), torch.int32)
    return specs


def state_specs(cfg: ArchConfig) -> Any:
    return init_train_state(cfg, device=META)


def params_specs(cfg: ArchConfig) -> Any:
    return lm.init_params(cfg, device=META)


def cache_specs(cfg: ArchConfig, batch: int, cache_len: int) -> Any:
    return lm.init_cache(cfg, batch, cache_len, device=META)


def input_specs(cfg: ArchConfig, shape: ShapeConfig) -> Tuple[str, Tuple]:
    if shape.mode == "train":
        return "train", (state_specs(cfg),
                         batch_specs(cfg, shape.global_batch, shape.seq_len))
    if shape.mode == "prefill":
        b = batch_specs(cfg, shape.global_batch, shape.seq_len)
        b.pop("targets")
        return "prefill", (params_specs(cfg), b)
    if shape.mode == "decode":
        token = _spec((shape.global_batch, 1), torch.int32)
        cache = cache_specs(cfg, shape.global_batch, shape.seq_len)
        return "decode", (params_specs(cfg), token, cache)
    raise ValueError(shape.mode)

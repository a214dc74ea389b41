"""A language-model configuration file as the port runs it, and its
weights: drawn on the device from the seed, one call a leaf, in the
layout ``repro_torch.models.lm`` takes, and handed alike to the program and
to the plain reference.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict

#: keys of a configuration file that describe it and configure no part of
#: the model (a nested key by its dotted path): read by the harness and
#: the reference, never passed to the port. ``ssm.log_decay_clamp`` is
#: checked against the program's constant instead.
DESCRIPTIVE = ("source", "deployment", "context", "reduced", "assumed",
               "ssm.log_decay_clamp")


def _build(cls, cfg: dict, prefix: str = "", nested=None):
    """``cls`` from every key of ``cfg`` that names one of its dataclass
    fields (lists as tuples, ``nested`` keys built by their own function);
    ``DESCRIPTIVE`` keys are left out, and any other key raises."""
    names = {f.name for f in dataclasses.fields(cls)}
    nested = nested or {}
    kw = {}
    for k, v in cfg.items():
        if prefix + k in DESCRIPTIVE:
            continue
        if k not in names:
            raise ValueError(f"configuration key {prefix + k!r} names no "
                             f"field of the port's {cls.__name__} and is "
                             f"not descriptive")
        if k in nested:
            v = nested[k](v) if v else None
        elif isinstance(v, list):
            v = tuple(v)
        kw[k] = v
    return cls(**kw)


def arch_config(cfg: dict):
    """The port's ``ArchConfig`` for a configuration file: every key that
    names one of its fields, ``ssm`` built into ``SSMConfig`` and ``moe``
    into ``MoEConfig`` the same way, the ``DESCRIPTIVE`` keys left out.
    Raises on any other key, and where the program's fixed constants
    depart from what the file states."""
    from repro_torch.configs.base import ArchConfig, MoEConfig, SSMConfig
    from repro_torch.models import gla

    def ssm(s: dict):
        clamp = s.get("log_decay_clamp", gla.LOG_DECAY_CLAMP)
        if clamp != gla.LOG_DECAY_CLAMP:
            raise ValueError(f"the program clamps the log decay at "
                             f"{gla.LOG_DECAY_CLAMP}, the configuration "
                             f"states {clamp}")
        return _build(SSMConfig, s, "ssm.")

    return _build(ArchConfig, cfg, nested={
        "ssm": ssm, "moe": lambda m: _build(MoEConfig, m, "moe.")})


def _fill(path: str, t, gen, cfg: dict) -> None:
    """Draw leaf ``path`` in place: products' weights normal with a fan-in
    scale (output projections also over sqrt(2 L)), norm scales near 1,
    Mamba2's decay, step and skip parameters in their usual ranges."""
    import torch
    leaf = path.rsplit(".", 1)[-1]
    L = cfg["num_layers"]
    if leaf == "scale":
        t.normal_(1.0, 0.1, generator=gen)
    elif leaf == "A_log":                  # A in [1, 16]
        t.uniform_(0.0, math.log(16.0), generator=gen)
    elif leaf == "D":
        t.uniform_(0.5, 1.5, generator=gen)
    elif leaf == "dt_bias":                # softplus^-1 of dt in [1e-3, 0.1]
        t.uniform_(math.log(1e-3), math.log(1e-1), generator=gen)
        t.copy_(torch.log(torch.expm1(torch.exp(t))))
    elif leaf == "conv_b":
        t.normal_(0.0, 0.1, generator=gen)
    elif leaf == "conv_w":
        t.normal_(0.0, 1.0 / math.sqrt(t.shape[-2]), generator=gen)
    elif leaf == "embed":
        t.normal_(0.0, cfg["d_model"] ** -0.5, generator=gen)
    else:
        fan_in = t.shape[-2]
        std = fan_in ** -0.5
        if leaf in ("wo", "w_down", "out_proj"):
            std /= math.sqrt(2 * L)
        t.normal_(0.0, std, generator=gen)


def make_params(cfg: dict, seed: int, device: str) -> Dict[str, Any]:
    """The weights of configuration ``cfg`` for seed ``seed`` on
    ``device``, in the port's layout (its shapes and dtypes read from
    ``lm.init_params`` on the meta device)."""
    import torch
    from repro_torch.models import lm
    meta = lm.init_params(arch_config(cfg), device="meta")
    gen = torch.Generator(device=device).manual_seed(seed)

    def build(tree, prefix):
        if isinstance(tree, dict):
            return {k: build(v, f"{prefix}.{k}" if prefix else k)
                    for k, v in tree.items()}
        t = torch.empty(tree.shape, dtype=tree.dtype, device=device)
        _fill(prefix, t, gen, cfg)
        return t

    return build(meta, "")

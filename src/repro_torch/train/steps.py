"""Serving step builders (``repro``'s ``train/steps.py``, serving half).

``make_prefill_step`` and ``make_decode_step`` return the functions a
serving replica runs; PyTorch runs them eagerly, so there is nothing to
jit. The training half (``make_train_step``, ``init_train_state``,
``dirty_block_stats``) is ported in slice 3 of the port (ROADMAP Queue A).
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import lm


def make_prefill_step(cfg: ArchConfig, cache_len: int):
    """fn(params, batch) -> (last_logits (B, V), cache)."""

    def prefill_step(params, batch):
        x, _, cache = lm.forward(params, cfg, batch, want_cache=True,
                                 cache_len=cache_len)
        logits = lm._head(cfg, params, x[:, -1:, :])[:, 0]
        return logits, cache

    return prefill_step


def make_decode_step(cfg: ArchConfig):
    """serve_step: fn(params, token (B,1), cache) -> (greedy next_token,
    logits, cache). The cache's KV rings are written in place."""

    def serve_step(params, token, cache):
        logits, cache = lm.decode_step(params, cfg, token, cache)
        nxt = logits.argmax(dim=-1).to(torch.int32)[:, None]
        return nxt, logits, cache

    return serve_step

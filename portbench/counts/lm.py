"""The operations a language-model step needs, from a configuration's
published widths: 2 per weight a token for every product with a weight
matrix (the embedding lookup is none), the attention's 4 hd per (query,
key) pair a head, and the SSD recurrence's 5 N P per head and token.
Elementwise work (norms, activations, the conv) is left out, as the usual
model-flops count leaves it. Written for layers of the kinds ``attn``,
``shared_attn`` (attention and a SwiGLU MLP) and ``mamba`` (Mamba2), and
an untied head.
"""
from __future__ import annotations

from typing import Tuple


def _mamba(cfg: dict) -> Tuple[int, int]:
    """(weights in a Mamba2 layer's products, SSD flops a token); none
    without an SSM."""
    if not cfg.get("ssm"):
        return 0, 0
    d, s = cfg["d_model"], cfg["ssm"]
    d_in = s["expand"] * d
    N, P = s["state_dim"], s["head_dim"]
    H = d_in // P
    proj = d * (2 * d_in + 2 * N + H) + d_in * d
    return proj, 5 * H * N * P


def _attn_weights(cfg: dict) -> int:
    d, H, Hkv = cfg["d_model"], cfg["num_heads"], cfg["num_kv_heads"]
    hd = d // H
    return d * H * hd * 2 + d * Hkv * hd * 2 + 3 * d * cfg["d_ff"]


def _counts(cfg: dict) -> Tuple[int, int, int]:
    """(Mamba2 layers, attention applications, head weights)."""
    pat = cfg["block_pattern"]
    groups = cfg["num_layers"] // len(pat)
    return (groups * pat.count("mamba"),
            groups * (pat.count("shared_attn") + pat.count("attn")),
            cfg["d_model"] * cfg["vocab_size"])


def decode_flops(cfg: dict, batch: int, kv_len: int) -> float:
    """One decode step of ``batch`` sequences, each attending to
    ``kv_len`` positions (its own included)."""
    n_m, n_a, head = _counts(cfg)
    w_m, ssd = _mamba(cfg)
    hd = cfg["d_model"] // cfg["num_heads"]
    per_token = (2 * (n_m * w_m + n_a * _attn_weights(cfg) + head)
                 + n_m * ssd + n_a * 4 * hd * kv_len * cfg["num_heads"])
    return float(batch) * per_token


def prefill_flops(cfg: dict, batch: int, S: int) -> float:
    """A prefill of ``batch`` prompts of ``S``: every layer on every
    position, causal attention, the head on the last position only."""
    n_m, n_a, head = _counts(cfg)
    w_m, ssd = _mamba(cfg)
    hd = cfg["d_model"] // cfg["num_heads"]
    pairs = S * (S + 1) // 2
    return float(batch) * (
        S * (2 * (n_m * w_m + n_a * _attn_weights(cfg)) + n_m * ssd)
        + n_a * 4 * hd * pairs * cfg["num_heads"] + 2 * head)

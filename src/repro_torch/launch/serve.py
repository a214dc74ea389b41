"""Serving launcher: batched prefill + decode with the KV cache
(``repro``'s ``launch/serve.py`` on torch).

  PYTHONPATH=src python -m repro_torch.launch.serve --arch h2o_danube3_4b \
      --tokens 32 [--no-smoke] [--device cpu]

Any config of the dense, SSM and hybrid families runs (``qwen3_8b``,
``zamba2_2p7b``, ``rwkv6_1p6b`` too); the MoE ones raise. ``--device``
defaults to the card and raises without one. On the card, attention
prefill runs kernel B5 (``kernels/csrc/flash_attention.cu``) and the SSM
layers kernel B4; on the CPU both run their plain versions.
"""
from __future__ import annotations

import argparse
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict

import torch

from repro_torch.configs import ArchConfig, get_config
from repro_torch.data import make_batch
from repro_torch.kernels.backend import DeviceLike, resolve_device
from repro_torch.models import lm
from repro_torch.train import make_decode_step, make_prefill_step


@dataclass
class Replica:
    """What a serving replica holds before its first request: the config,
    weights, one prompt batch and its two step functions."""
    cfg: ArchConfig
    params: Dict[str, Any]
    batch: Dict[str, torch.Tensor]
    prefill: Callable
    decode: Callable
    device: torch.device


def build_replica(arch: str, batch: int, prompt_len: int, tokens: int, *,
                  smoke: bool = True, seed: int = 0,
                  device: DeviceLike = None) -> Replica:
    """Config (``.smoke()`` unless ``smoke=False``), seeded random weights
    and a synthetic prompt batch on ``device`` (``None`` is the card), with
    a decode cache sized for ``prompt_len + tokens``."""
    dev = resolve_device(device)
    cfg = get_config(arch)
    if smoke:
        cfg = cfg.smoke()
    params = lm.init_params(cfg, seed, device=dev)
    prompts = make_batch(cfg, batch, prompt_len, device=dev)
    prompts.pop("targets")
    return Replica(cfg, params, prompts,
                   make_prefill_step(cfg, cache_len=prompt_len + tokens),
                   make_decode_step(cfg), dev)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="internlm2_1p8b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--tokens", type=int, default=32)
    ap.add_argument("--smoke", action=argparse.BooleanOptionalAction,
                    default=True)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args()

    r = build_replica(args.arch, args.batch, args.prompt_len, args.tokens,
                      smoke=args.smoke, device=args.device)
    t0 = time.monotonic()
    logits, cache = r.prefill(r.params, r.batch)
    _sync(r.device)
    t_prefill = time.monotonic() - t0

    tok = logits.argmax(-1)[:, None].to(torch.int32)
    out_tokens = [tok]
    t0 = time.monotonic()
    for _ in range(args.tokens - 1):
        tok, logits, cache = r.decode(r.params, tok, cache)
        out_tokens.append(tok)
    _sync(r.device)
    t_decode = time.monotonic() - t0

    gen = torch.cat(out_tokens, dim=1)
    print(f"prefill: {args.batch}x{args.prompt_len} in {t_prefill*1e3:.1f}ms")
    print(f"decode:  {args.tokens-1} steps in {t_decode*1e3:.1f}ms "
          f"({(args.tokens-1)*args.batch/max(t_decode,1e-9):.1f} tok/s)")
    print("sample token ids:", gen[0, :16].tolist())


if __name__ == "__main__":
    main()

"""Wrapper of the hand-written dirty-block kernel (``csrc/dirty_delta.cu``).

Replaces the Pallas TPU kernel ``repro/kernels/dirty_delta.py``
(``max_abs_delta``): pre-copy migration cuts each state leaf into blocks of
``block`` elements and re-sends the blocks whose largest ``|new - old|`` is
above a threshold. The function streams both inputs once and writes one
f32 per block, so it is bound by its bytes. One warp per block reads
16-byte vectors and keeps the max of |delta| as its bits (an integer max,
NaN kept), reduced by one warp-wide max, with no atomics; the ragged last
block is read in place, never padded. One launch takes up to
``MAX_LEAVES`` pairs of any lengths and dtypes, so a scan of a whole
state tree is one grid (``max_abs_delta_many``).

This wrapper only launches: it takes CUDA tensors and raises on anything
else. The plain version lives in ``kernels/ref.py``; ``kernels/ops.py``
chooses between the two by the tensor's device.
"""
from __future__ import annotations

import array
from typing import Optional, Sequence

import torch

from repro_torch.kernels import build

#: dtypes the kernel reads, with the code its C entry takes
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2,
               torch.float64: 3}
#: pairs one launch takes (``MAX_LEAVES`` in the source)
MAX_LEAVES = 64


def max_abs_delta(new: torch.Tensor, old: torch.Tensor,
                  block: Optional[int] = None) -> torch.Tensor:
    """Per-block ``max |f32(new) - f32(old)|`` -> (n_blocks, 1) f32 CUDA.

    With ``block=None`` the inputs are (n_blocks, block) tiles, as the
    reference's; with ``block`` given they are read flat, ``ceil(n / block)``
    blocks, the last one as if zero-padded. NaN in a block gives NaN."""
    if block is None:
        if new.dim() != 2:
            raise ValueError(f"without block, inputs are (n_blocks, block), "
                             f"got {tuple(new.shape)}")
        block = new.shape[1]
    return max_abs_delta_many([new], [old], block)[:, None]


def max_abs_delta_many(news: Sequence[torch.Tensor],
                       olds: Sequence[torch.Tensor],
                       block: int) -> torch.Tensor:
    """``max_abs_delta`` of each pair, read flat, in one launch per
    ``MAX_LEAVES`` pairs -> (sum_i ceil(n_i / block),) f32 CUDA, the
    pairs' blocks in pair order. Every tensor lies on one card; each pair
    shares a dtype and a shape, dtypes may differ between pairs."""
    if len(news) != len(olds):
        raise ValueError(f"{len(news)} new tensors, {len(olds)} old ones")
    if block < 1:
        raise ValueError(f"block must be >= 1, got {block}")
    card = news[0].get_device() if news else -1
    rows, held, first = [], [], [0]      # first[i]: pair i's first block
    for new, old in zip(news, olds):
        if card < 0 or new.get_device() != card or old.get_device() != card:
            raise ValueError(f"dirty_delta kernel needs CUDA tensors on one "
                             f"device, got {new.device} and {old.device}")
        code = DTYPE_CODES.get(new.dtype)
        if code is None or old.dtype != new.dtype:
            raise ValueError(f"dirty_delta kernel takes two tensors of one of"
                             f" {sorted(map(str, DTYPE_CODES))}, got "
                             f"{new.dtype} and {old.dtype}")
        if new.shape != old.shape:
            raise ValueError(f"shapes differ: {tuple(new.shape)} and "
                             f"{tuple(old.shape)}")
        if not new.is_contiguous():
            new = new.contiguous()
        if not old.is_contiguous():
            old = old.contiguous()
        n = new.numel()
        if n:
            rows.append((first[-1], new.data_ptr(), old.data_ptr(), n, code))
            held.append((new, old))      # alive until their launch is queued
        first.append(first[-1] + -(-n // block))
    out = torch.empty(first[-1], dtype=torch.float32,
                      device=news[0].device if news else None)
    if not rows:
        return out
    lib = build.load("dirty_delta")
    table = array.array("q", [v for row in rows for v in row[1:]])
    base = table.buffer_info()[0]
    with torch.cuda.device(card):
        stream = torch.cuda.current_stream(card).cuda_stream
        for c in range(0, len(rows), MAX_LEAVES):
            n_pairs = min(MAX_LEAVES, len(rows) - c)
            err = lib.dirty_delta_launch(base + 32 * c, n_pairs,
                                         out.data_ptr() + 4 * rows[c][0],
                                         block, stream)
            if err:
                raise RuntimeError(f"dirty_delta kernel launch failed: "
                                   f"cudaError {err}")
            max_abs_delta.launches += 1
    return out


max_abs_delta.launches = 0

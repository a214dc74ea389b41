"""Wrapper of the hand-written dirty-block kernel (``csrc/dirty_delta.cu``).

Replaces the Pallas TPU kernel ``repro/kernels/dirty_delta.py``
(``max_abs_delta``): pre-copy migration cuts each state leaf into blocks of
``block`` elements and re-sends the blocks whose largest ``|new - old|`` is
above a threshold. The function streams both inputs once and writes one
f32 per block, so it is bound by its bytes. One warp per block reads
16-byte vectors and reduces with shuffles in a fixed order, with no
atomics; the ragged last block is read in place, never padded.

This wrapper only launches: it takes CUDA tensors and raises on anything
else. The plain version lives in ``kernels/ref.py``; ``kernels/ops.py``
chooses between the two by the tensor's device.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import build

#: dtypes the kernel reads, with the code its C entry takes
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2,
               torch.float64: 3}


def max_abs_delta(new: torch.Tensor, old: torch.Tensor,
                  block: Optional[int] = None) -> torch.Tensor:
    """Per-block ``max |f32(new) - f32(old)|`` -> (n_blocks, 1) f32 CUDA.

    With ``block=None`` the inputs are (n_blocks, block) tiles, as the
    reference's; with ``block`` given they are read flat, ``ceil(n / block)``
    blocks, the last one as if zero-padded. NaN in a block gives NaN."""
    if new.device.type != "cuda" or old.device != new.device:
        raise ValueError(f"dirty_delta kernel needs CUDA tensors on one "
                         f"device, got {new.device} and {old.device}")
    if new.dtype != old.dtype or new.dtype not in DTYPE_CODES:
        raise ValueError(f"dirty_delta kernel takes two tensors of one of "
                         f"{sorted(map(str, DTYPE_CODES))}, got {new.dtype} "
                         f"and {old.dtype}")
    if new.shape != old.shape:
        raise ValueError(f"shapes differ: {tuple(new.shape)} and "
                         f"{tuple(old.shape)}")
    if block is None:
        if new.dim() != 2:
            raise ValueError(f"without block, inputs are (n_blocks, block), "
                             f"got {tuple(new.shape)}")
        block = new.shape[1]
    if block < 1:
        raise ValueError(f"block must be >= 1, got {block}")
    new, old = new.contiguous(), old.contiguous()
    n = new.numel()
    nb = -(-n // block)
    out = torch.empty((nb, 1), dtype=torch.float32, device=new.device)
    if nb == 0:
        return out
    lib = build.load("dirty_delta")
    with torch.cuda.device(new.device):
        err = lib.dirty_delta_launch(
            new.data_ptr(), old.data_ptr(), out.data_ptr(), n, block,
            DTYPE_CODES[new.dtype],
            torch.cuda.current_stream(new.device).cuda_stream)
    if err:
        raise RuntimeError(f"dirty_delta kernel launch failed: cudaError {err}")
    max_abs_delta.launches += 1
    return out


max_abs_delta.launches = 0

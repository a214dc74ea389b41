"""Wrapper of the hand-written chunked SSM-scan kernel (``csrc/ssm_scan.cu``).

Replaces the Pallas TPU kernel ``repro/kernels/ssm_scan.py``
(``ssm_scan``) and the function the JAX package's SSM layers run in its
place, ``repro/models/gla.py`` ``gla_chunked``: the chunked
gated-linear-attention scan of Mamba2 (SSD mode) and RWKV6 (RWKV mode,
strict past plus the bonus ``u``). Four warps a head walk the chunks of
32 tokens with the f32 state in their mma accumulators; the products run
on the tensor cores as 3xTF32 (each f32 operand split hi + lo, three
TF32 products summed in f32, which keeps 2e-4 where one plain TF32
product does not; a raw bf16 operand is exact and needs no lo term).
The kernel picks its form from the inputs: SSD with a log decay of
stride 0 over Dk (Mamba2's) scales the raw q k^T by one exp per token
pair, two heads a block when q and k are shared by every head; any other
decay (RWKV, per-channel SSD) takes ``gla_chunked``'s factored form.
Each chunk's inputs are staged in shared memory while the chunk before
computes (one TMA box a tile where TMA takes the layout, else element by
element; bf16 when q, k and v are bf16) and the products read them
there. Fixed orders and no atomics, so a second launch is bit-equal.

It computes what ``gla_chunked`` computes: ``y`` in f32, an optional
initial state, any ``S >= 1`` (the ragged last chunk is masked in the
kernel, not padded) and inputs read through their strides, stride 0
included, in f32 or bf16.

This wrapper only launches: it takes CUDA tensors and raises on anything
else. The plain version is ``models/gla.gla_chunked`` and the step
recurrence ``kernels/ref.ssm_scan_ref``; ``kernels/ops.py`` chooses by the
tensor's device.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.kernels import build

#: dtypes the kernel reads, with the code its C entry takes
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
#: the shared-memory tiles cap the state's two dimensions
MAX_D = 64


def ssm_scan(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             log_decay: torch.Tensor, bonus: Optional[torch.Tensor] = None,
             initial_state: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """q, k, log_decay: (B, H, S, Dk); v: (B, H, S, Dv), CUDA, any strides.
    ``bonus`` (H, Dk) selects RWKV mode; ``initial_state`` (B, H, Dk, Dv).
    Returns (y (B, H, S, Dv) f32, final state (B, H, Dk, Dv) f32)."""
    ins = (q, k, v, log_decay)
    dev = q.device
    if dev.type != "cuda" or any(t.device != dev for t in ins):
        raise ValueError(f"ssm_scan kernel needs CUDA tensors on one device, "
                         f"got {[str(t.device) for t in ins]}")
    if any(t.dtype not in DTYPE_CODES for t in ins):
        raise ValueError(f"ssm_scan kernel reads {sorted(map(str, DTYPE_CODES))}"
                         f", got {[str(t.dtype) for t in ins]}")
    if any(t.dim() != 4 for t in ins):
        raise ValueError("ssm_scan kernel takes (B, H, S, D) inputs")
    B, H, S, Dk = q.shape
    Dv = v.shape[3]
    if k.shape != q.shape or log_decay.shape != q.shape or \
            v.shape[:3] != q.shape[:3]:
        raise ValueError(f"shapes differ: q {tuple(q.shape)} k "
                         f"{tuple(k.shape)} v {tuple(v.shape)} log_decay "
                         f"{tuple(log_decay.shape)}")
    if min(B, H, S) < 1 or not (1 <= Dk <= MAX_D and 1 <= Dv <= MAX_D):
        raise ValueError(f"ssm_scan kernel takes B, H, S >= 1 and "
                         f"1 <= Dk, Dv <= {MAX_D}, got {(B, H, S, Dk, Dv)}")
    if bonus is not None:
        if tuple(bonus.shape) != (H, Dk):
            raise ValueError(f"bonus is (H, Dk) = {(H, Dk)}, got "
                             f"{tuple(bonus.shape)}")
        bonus = bonus.to(dev, torch.float32).contiguous()
    if initial_state is not None:
        if tuple(initial_state.shape) != (B, H, Dk, Dv):
            raise ValueError(f"initial_state is {(B, H, Dk, Dv)}, got "
                             f"{tuple(initial_state.shape)}")
        initial_state = initial_state.to(dev, torch.float32).contiguous()
    y = torch.empty((B, H, S, Dv), dtype=torch.float32, device=dev)
    state = torch.empty((B, H, Dk, Dv), dtype=torch.float32, device=dev)
    shape = (ctypes.c_longlong * 5)(B, H, S, Dk, Dv)
    strides = (ctypes.c_longlong * 16)(*(s for t in ins for s in t.stride()))
    dtypes = (ctypes.c_int * 4)(*(DTYPE_CODES[t.dtype] for t in ins))
    lib = build.load("ssm_scan")
    with torch.cuda.device(dev):
        err = lib.ssm_scan_launch(
            *(t.data_ptr() for t in ins),
            None if bonus is None else bonus.data_ptr(),
            None if initial_state is None else initial_state.data_ptr(),
            y.data_ptr(), state.data_ptr(), ctypes.addressof(shape),
            ctypes.addressof(strides), ctypes.addressof(dtypes),
            torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"ssm_scan kernel launch failed: cudaError {err}")
    ssm_scan.launches += 1
    return y, state


ssm_scan.launches = 0

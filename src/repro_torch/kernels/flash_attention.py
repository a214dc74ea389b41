"""Wrapper of the hand-written flash-attention kernel
(``csrc/flash_attention.cu``).

Replaces the Pallas TPU kernel ``repro/kernels/flash_attention.py``
(``flash_attention``) and the function the JAX package's attention prefill
runs in its place, ``repro/models/blocks.py`` ``_chunked_causal_attention``:
causal GQA attention with an optional sliding window, by an online softmax
in f32 over the kv tiles that a block's query rows can see. Both paths
are bound by their operations (4 D flops per causal pair):

- bf16 (every prefill of the port): the products run on the tensor cores
  (``wgmma`` bf16 x bf16 -> f32: exact products, f32 sums, as the TPU
  kernel's), 128 query rows a block in two consumer warpgroups walking kv
  tiles of 128 keys, Q, K and V tiles loaded by TMA into a 3-stage ring by
  a producer warpgroup; D is padded to a multiple of 16 with zero columns
  by the loads.
- f32 (the shallow card-against-CPU checks): f32 FMAs on the CUDA cores
  over kv tiles of 64, which keep the 2e-5 tolerance that TF32 tensor
  cores would miss.

Each sum has a fixed order, so a second launch is bit-equal, and inputs
that TMA cannot take (unaligned, or a d stride != 1) go through the same
kernel with element-wise loads into the same tiles, so every layout gives
the same bits.

It takes any ``S >= 1`` (the ragged last tile is masked in the kernel),
any ``D <= 128`` (bf16 also ``D <= 224``: Zamba2's 224-wide heads, on kv
tiles of 64 keys), any ``H % Hkv == 0``, q, k, v of one dtype (f32 or
bf16) through their strides, and the softmax's scale from the caller
(``D**-0.5`` by default). The output, in q's dtype, is written in
(B, S, H, D) memory order and returned as a (B, H, S, D) view.

This wrapper only launches: it takes CUDA tensors and raises on anything
else. The plain versions are ``kernels/ref.attention_chunked`` (the op's
CPU path) and ``kernels/ref.attention_ref`` (the naive oracle);
``kernels/ops.py`` chooses by the tensor's device.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

#: dtypes the kernel reads, with the code its C entry takes
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
#: the shared-memory tiles cap the head dimension, by dtype
MAX_D = {torch.float32: 128, torch.bfloat16: 224}


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    window: int = 0, scale: float = 0.0) -> torch.Tensor:
    """q: (B, H, S, D); k, v: (B, Hkv, S, D), CUDA, one dtype, any strides.
    Causal; ``window > 0`` adds the sliding window; ``scale > 0`` scales
    q . k (else ``D**-0.5``). Returns (B, H, S, D) in q's dtype, a view of
    a (B, S, H, D) tensor."""
    ins = (q, k, v)
    dev = q.device
    if dev.type != "cuda" or any(t.device != dev for t in ins):
        raise ValueError(f"flash_attention kernel needs CUDA tensors on one "
                         f"device, got {[str(t.device) for t in ins]}")
    if q.dtype not in DTYPE_CODES or any(t.dtype != q.dtype for t in ins):
        raise ValueError(f"flash_attention kernel reads q, k, v of one dtype "
                         f"in {sorted(map(str, DTYPE_CODES))}, got "
                         f"{[str(t.dtype) for t in ins]}")
    if any(t.dim() != 4 for t in ins):
        raise ValueError("flash_attention kernel takes (B, H, S, D) inputs")
    B, H, S, D = q.shape
    Hkv = k.shape[1]
    if k.shape != v.shape or k.shape != (B, Hkv, S, D):
        raise ValueError(f"shapes differ: q {tuple(q.shape)} k "
                         f"{tuple(k.shape)} v {tuple(v.shape)}")
    if min(B, H, S, Hkv) < 1 or not 1 <= D <= MAX_D[q.dtype] or H % Hkv:
        raise ValueError(f"flash_attention kernel takes B, S >= 1, "
                         f"1 <= D <= {MAX_D[q.dtype]} ({q.dtype}) and "
                         f"H % Hkv == 0, got {(B, H, Hkv, S, D)}")
    if window < 0:
        raise ValueError(f"window must be >= 0, got {window}")
    out = torch.empty((B, S, H, D), dtype=q.dtype, device=dev)
    shape = (ctypes.c_longlong * 5)(B, H, Hkv, S, D)
    strides = (ctypes.c_longlong * 12)(*(s for t in ins for s in t.stride()))
    lib = build.load("flash_attention")
    with torch.cuda.device(dev):
        err = lib.flash_attention_launch(
            *(t.data_ptr() for t in ins), out.data_ptr(),
            ctypes.addressof(shape), ctypes.addressof(strides),
            DTYPE_CODES[q.dtype], int(window), ctypes.c_double(scale),
            torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"flash_attention kernel launch failed: "
                           f"cudaError {err}")
    flash_attention.launches += 1
    return out.transpose(1, 2)


flash_attention.launches = 0

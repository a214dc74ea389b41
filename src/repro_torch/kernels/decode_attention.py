"""Wrapper of the hand-written decode-attention kernel
(``csrc/decode_attention.cu``).

Replaces no TPU kernel: the JAX package decodes outside any Pallas kernel.
One token's attention against a KV ring, from the projections' outputs:
rotary on q and k, the token's k and v written into ring slot
``cache_pos % W`` of every ring head, and the query heads of the KV heads
[kv0, kv1) attending to the ring's valid slots (the full ring, or the
sliding window's), read in place. The kernel is bound by its bytes (each
valid K and V slot read once); ``plan`` splits the ring's slots so that
the blocks fill the card, from the shapes alone, and the splits are merged
in a fixed order, so a second launch is bit-equal.

It takes q (B, 1, n, hd) and k, v (B, 1, Hr, hd) of one dtype (f32 or
bf16) through their strides, angles (B, 1, hd/2) f32, rings (B, W, Hr, hd)
of that dtype with a unit hd stride and 16-byte aligned rows (a layer's
slice of the stacked cache, any batch stride), ``cache_pos`` a 0-dim int32
on the card, and hd in ``HEAD_DIMS``. Returns (B, 1, n hd) in q's
dtype. The rings are written in place.

This wrapper only launches: it takes CUDA tensors and raises on anything
else. The plain version is ``kernels/ref.decode_attention_ref``;
``kernels/ops.py`` chooses by the tensor's device.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.kernels import build

#: dtypes the kernel reads, with the code its C entry takes
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
#: head dims with a compiled instantiation (every head the port decodes)
HEAD_DIMS = (32, 64, 80, 112, 120, 128, 224)
TILE = 32                 # ring slots a tile (``TILE`` in the source)
TARGET_BLOCKS = 4 * 132   # blocks that fill an H100's 132 SMs four deep
MIN_SPLIT = 256           # the fewest slots a split is cut to
MAX_SCORES = 8192         # a split's f32 scores kept in shared memory


def plan(pairs: int, W: int, G: int) -> Tuple[int, int]:
    """(splits, slots a split) for ``pairs`` = B Hkv (batch row, KV head)
    pairs over a ring of ``W`` slots with ``G`` query heads a KV head:
    enough splits for about ``TARGET_BLOCKS`` blocks, none shorter than
    ``MIN_SPLIT`` slots, few enough scores a split for shared memory, the
    length a whole number of tiles. From the shapes alone, never from the
    position."""
    n = min(max(1, -(-TARGET_BLOCKS // pairs)), max(1, -(-W // MIN_SPLIT)))
    n = max(n, -(-W * G // MAX_SCORES))
    length = -(-(-(-W // n)) // TILE) * TILE
    return -(-W // length), length


def _ring_ok(t: torch.Tensor) -> bool:
    """Unit hd stride, and every row on a 16-byte boundary (cp.async)."""
    size = t.element_size()
    return (t.stride(3) == 1 and t.data_ptr() % 16 == 0
            and all(s * size % 16 == 0 for s in t.stride()[:3]))


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     angles: torch.Tensor, k_ring: torch.Tensor,
                     v_ring: torch.Tensor, cache_pos: torch.Tensor,
                     window: int = 0, scale: float = 0.0, kv0: int = 0,
                     kv1: int = -1) -> torch.Tensor:
    """The module docstring's op on CUDA tensors; ``scale > 0`` scales
    q . k (else ``hd**-0.5``), ``kv1 < 0`` means every ring head."""
    ins = (q, k, v, angles, k_ring, v_ring, cache_pos)
    dev = q.device
    if dev.type != "cuda" or any(t.device != dev for t in ins):
        raise ValueError(f"decode_attention kernel needs CUDA tensors on one "
                         f"device, got {[str(t.device) for t in ins]}")
    rows = (q, k, v, k_ring, v_ring)
    if q.dtype not in DTYPE_CODES or any(t.dtype != q.dtype for t in rows):
        raise ValueError(f"decode_attention kernel reads q, k, v and the "
                         f"rings in one dtype of "
                         f"{sorted(map(str, DTYPE_CODES))}, got "
                         f"{[str(t.dtype) for t in rows]}")
    if any(t.dim() != 4 for t in rows):
        raise ValueError("decode_attention kernel takes 4-d q, k, v, rings")
    B, _, n, hd = q.shape
    W, Hr = k_ring.shape[1], k_ring.shape[2]
    kv1 = Hr if kv1 < 0 else kv1
    if (q.shape[1] != 1 or k.shape != (B, 1, Hr, hd) or v.shape != k.shape
            or k_ring.shape != (B, W, Hr, hd) or v_ring.shape != k_ring.shape
            or angles.shape != (B, 1, hd // 2)):
        raise ValueError(f"decode_attention shapes: q {tuple(q.shape)} k "
                         f"{tuple(k.shape)} v {tuple(v.shape)} angles "
                         f"{tuple(angles.shape)} rings {tuple(k_ring.shape)} "
                         f"{tuple(v_ring.shape)}")
    if not 0 <= kv0 < kv1 <= Hr or n % (kv1 - kv0):
        raise ValueError(f"decode_attention: {n} query heads over KV heads "
                         f"[{kv0}, {kv1}) of {Hr}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"decode_attention kernel takes hd in {HEAD_DIMS}, "
                         f"got {hd}")
    if angles.dtype != torch.float32:
        raise ValueError(f"angles must be f32, got {angles.dtype}")
    if cache_pos.dim() != 0 or cache_pos.dtype != torch.int32:
        raise ValueError(f"cache_pos must be a 0-dim int32, got "
                         f"{cache_pos.dtype} {tuple(cache_pos.shape)}")
    if not (_ring_ok(k_ring) and _ring_ok(v_ring)):
        raise ValueError("decode_attention kernel reads ring rows by "
                         "16-byte copies: unit hd stride and 16-byte aligned "
                         "rows")
    if window < 0:
        raise ValueError(f"window must be >= 0, got {window}")
    G = n // (kv1 - kv0)
    n_splits, length = plan(B * (kv1 - kv0), W, G)
    out = torch.empty((B, 1, n * hd), dtype=q.dtype, device=dev)
    part = (torch.empty(n_splits * B * n * (hd + 2), dtype=torch.float32,
                        device=dev) if n_splits > 1 else None)
    dims = (ctypes.c_longlong * 11)(
        B, W, Hr, kv0, kv1, G, hd, int(window), n_splits, length,
        DTYPE_CODES[q.dtype])
    strides = (ctypes.c_longlong * 17)(
        *(s for t in (q, k, v) for s in (t.stride(0), t.stride(2),
                                          t.stride(3))),
        *(s for t in (k_ring, v_ring) for s in t.stride()[:3]),
        angles.stride(0), angles.stride(2))
    lib = build.load("decode_attention")
    with torch.cuda.device(dev):
        err = lib.decode_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), angles.data_ptr(),
            k_ring.data_ptr(), v_ring.data_ptr(), cache_pos.data_ptr(),
            out.data_ptr(), 0 if part is None else part.data_ptr(),
            ctypes.addressof(dims), ctypes.addressof(strides),
            ctypes.c_double(scale if scale > 0 else hd ** -0.5),
            torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"decode_attention kernel launch failed: "
                           f"cudaError {err}")
    decode_attention.launches += 1
    return out


decode_attention.launches = 0

"""Wrapper of the hand-written autocorrelation kernel (``csrc/autocorr.cu``).

Replaces the Pallas TPU kernel ``repro/kernels/autocorr.py``
(``autocorr_score``): the period refinement of the cycle fit scores every
job's mean-removed row against one shared grid of candidate lags. The
direct sums are J * sum over lags of N - lag multiply-adds; the function
needs less (Wiener-Khinchin), so its least time is set by the bytes it
moves.

The lags are cut into tiles (``lag_tiles``), and the kernel picks each
tile's route on the device from the lags it reads (``tile_routes`` is the
same rule in Python, for the tests and ``chip_smoke.py``):

- ``"tensor"``, a tile of consecutive clamped lags (every grid the cycle
  fit sends): the tile's scores are the diagonal sums of one Hankel
  product of two shifted views of the row, run on the tensor cores as
  3xTF32 ``mma.sync`` m16n8k4 (each f32 operand split hi + lo, both
  TF32);
- ``"cuda"``, any other tile (scattered lags, or lags that clamp to one
  value): each warp scores 4 lags of a row at once (5 for a tile's last
  5) with lane-strided sums on the CUDA cores, reduced by shuffles.

A block stages its rows once and hands its units, in (row, tile) order,
to its warps in turn: a tensor tile is one unit, a CUDA tile one unit per
4 lags (the last up to 5). ``plan`` shrinks the tiles until the launch has a unit for every
warp the card holds (or the tiles are as small as they go). No atomics,
so the result is the same on every run. The host never reads the lags:
``plan`` chooses the tiles and the blocks from (J, N, L) and the card's
SM count alone.

A lag's score does not depend on the tile it falls in: every tensor
tile's k-steps start at t = 0 in the same chunks, and the k-steps a lag
does not need add exact zeros. So a launch over a block of the rows (a
rank of the sharded tick, ``core/shard.py``), which ``plan`` may tile
otherwise, gives the whole launch's bits for those rows (held on the
card by ``chip_smoke.py``'s ``_blocks_bit_equal``).

The rows must be finite. A tensor tile's products take the zeros past N,
so a NaN or an inf reaches every lag of its tile, where the plain version
poisons only the lags whose sums hold it.

This wrapper only launches: it takes CUDA tensors and raises on anything
else. The plain version lives in ``kernels/ref.py``; ``kernels/ops.py``
chooses between the two by the tensor's device.
"""
from __future__ import annotations

import ctypes
import functools
from typing import List, NamedTuple, Sequence

import torch

from repro_torch.kernels import build

#: the rows are staged whole in shared memory
MAX_N = 16384
#: time block of the tensor route's Hankel product: the n side of m16n8k4
T = 8
#: 16-row tiles of lag offsets in one product, at most
MAX_MT = 8
#: lag tiles a block, at most (the kernel's table of tiles)
MAX_TILES = 64
#: warps a block
WARPS = 4
#: blocks resident on an SM (the kernel's launch bounds)
BLOCKS_PER_SM = 4
#: staged rows a block may take, in bytes
ROWS_BYTES = 32 * 1024
#: zeros staged past N
PAD = 256


class Plan(NamedTuple):
    mt: int        # 16-row tiles of lag offsets a product
    lt: int        # lags a tile, 16 mt - 7
    tiles: int     # lag tiles, ceil(L / lt)
    rows: int      # rows a block
    group: int     # lag tiles a block
    groups: int    # blocks along the lag tiles


def lag_tiles(L: int, want: int = 1):
    """(mt, lt, tiles): the fewest tiles of at most ``16 MAX_MT - 7`` lags,
    the smallest tile that still takes L in that many, then smaller tiles
    (mt down to 1) until there are ``want`` of them."""
    n0 = -(-L // (16 * MAX_MT - (T - 1)))
    mt = -(-(-(-L // n0) + T - 1) // 16)
    while mt > 1 and -(-L // (16 * mt - (T - 1))) < want:
        mt -= 1
    lt = 16 * mt - (T - 1)
    return mt, lt, -(-L // lt)


@functools.lru_cache(maxsize=256)
def plan(J: int, N: int, L: int, sms: int) -> Plan:
    """Tiles and blocks of a launch on a card of ``sms`` SMs. A block takes
    4 rows when J still gives every SM its ``BLOCKS_PER_SM`` blocks and the
    rows fit ``ROWS_BYTES``, else one. Each warp scores whole (row, tile)
    units, so the tiles shrink until J times the tiles covers every warp of
    a full card and every block has a unit a warp. A launch whose rows fill
    the card puts all its tiles in one block (its rows staged once);
    otherwise a block takes a unit a warp and the rest spread over blocks
    (a small J's work is latency, not products)."""
    fill = BLOCKS_PER_SM * sms
    row_bytes = 4 * (-(-(N + PAD) // 4) * 4)
    rows = next(rb for rb in (4, 2, 1)
                if rb == 1 or (J // rb >= fill and rb * row_bytes
                               <= ROWS_BYTES))
    per = -(-WARPS // rows)
    mt, lt, tiles = lag_tiles(L, max(per, -(-WARPS * fill // J)))
    group = min(tiles, MAX_TILES if -(-J // rows) >= fill else per)
    groups = -(-tiles // group)
    return Plan(mt, lt, tiles, rows, -(-tiles // groups), groups)


def sm_count(device) -> int:
    """The card's SM count (what ``plan`` fills)."""
    return _sm_count(torch.device(device).index
                     if torch.device(device).index is not None
                     else torch.cuda.current_device())


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


@functools.lru_cache(maxsize=None)
def _lib():
    """The kernel's library, its planning constants checked against ours."""
    lib = build.load("autocorr")
    got = (ctypes.c_int * 8)()
    n = lib.autocorr_constants(got)
    want = (T, PAD, MAX_MT, MAX_TILES, WARPS)
    if tuple(got[:n]) != want:
        raise RuntimeError(f"autocorr.cu plans with (T, PAD, MAX_MT, MAX_TG, "
                           f"WARPS) = {tuple(got[:n])}, this wrapper with "
                           f"{want}")
    return lib


def tile_routes(lags: Sequence[int], N: int, lt: int) -> List[str]:
    """Each tile's route (tiles of ``lt`` lags, ``plan(...).lt``), as the
    kernel decides it: ``"tensor"`` when the tile's lags clamped to [0, N]
    run a0, a0 + 1, ..., else ``"cuda"``."""
    lags = [min(max(int(v), 0), N) for v in lags]
    routes = []
    for t in range(-(-len(lags) // lt)):
        tile = lags[t * lt:(t + 1) * lt]
        routes.append("tensor" if all(v == tile[0] + k
                                      for k, v in enumerate(tile))
                      else "cuda")
    return routes


def autocorr_score(x: torch.Tensor, lags: torch.Tensor) -> torch.Tensor:
    """x: (J, N) f32 CUDA rows, finite, lags: (L,) integer CUDA -> (J, L)
    f32 ``R[j, l] = sum_{t < N - lag} x[j, t] x[j, t + lag]``, lags clamped
    to [0, N]."""
    if x.device.type != "cuda" or lags.device != x.device:
        raise ValueError(f"autocorr kernel needs CUDA tensors on one device, "
                         f"got {x.device} and {lags.device}")
    if x.dim() != 2 or x.dtype != torch.float32 or lags.dim() != 1:
        raise ValueError(f"autocorr kernel takes (J, N) float32 and (L,) "
                         f"lags, got {tuple(x.shape)} {x.dtype} and "
                         f"{tuple(lags.shape)}")
    J, N = x.shape
    if not 1 <= N <= MAX_N:
        raise ValueError(f"autocorr kernel takes 1 <= N <= {MAX_N}, got {N}")
    x = x.contiguous()
    lags = lags.to(torch.int32).contiguous()
    L = lags.shape[0]
    out = torch.empty((J, L), dtype=torch.float32, device=x.device)
    if J == 0 or L == 0:
        return out
    p = plan(J, N, L, sm_count(x.device))
    if p.groups > 65535:
        raise ValueError(f"autocorr kernel takes at most "
                         f"{65535 * MAX_TILES * p.lt} lags, got {L}")
    lib = _lib()
    with torch.cuda.device(x.device):
        err = lib.autocorr_launch(
            x.data_ptr(), lags.data_ptr(), out.data_ptr(), J, N, L, p.mt,
            p.rows, p.group, torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError(f"autocorr kernel launch failed: cudaError {err}")
    autocorr_score.launches += 1
    return out


autocorr_score.launches = 0

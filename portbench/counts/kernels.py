"""The least work of each hand-written kernel's call, from its shapes alone:
each input byte read once, each output byte written once, and the fewest
operations any method of computing the same result needs. One peak per
quantity for the whole chip: every kernel's result needs at least bfloat16
products, and no published H100 rate that gives those is above the bf16
tensor-core rate; the bytes move at most at HBM3's rate. So no
implementation of the same work can take less than ``seconds(...)``, and a
share of it never passes 1.

Peaks: NVIDIA H100 SXM data sheet, dense, at the full 700 W.
"""
from __future__ import annotations

import math
from typing import Iterable, Sequence, Tuple

PEAK_FLOPS = 989e12          # bf16 tensor cores, dense
PEAK_BYTES = 3.35e12         # HBM3


def seconds(flops: float, nbytes: float) -> float:
    """The least time of a call: the larger of its operations and its
    bytes at their peaks."""
    return max(flops / PEAK_FLOPS, nbytes / PEAK_BYTES)


def _rfft_flops(m: int) -> float:
    """One real FFT of length m: the usual 2.5 m log2 m."""
    return 2.5 * m * math.log2(max(m, 2))


def spectrum(B: int, N: int) -> Tuple[float, float]:
    """B1, the one-sided power spectrum of B mean-removed f32 rows of N:
    a mean removal (2N), a real FFT and |.|^2 of N//2+1 bins (3 each) a
    row; the rows read, the spectra written (f32)."""
    bins = N // 2 + 1
    return (B * (2.0 * N + _rfft_flops(N) + 3.0 * bins),
            4.0 * B * N + 4.0 * B * bins)


def autocorr(J: int, N: int, lags: Sequence[int]) -> Tuple[float, float]:
    """B2, the scores sum_t x[t] x[t + lag] of J f32 rows of N at L shared
    lags (clamped to [0, N]): a row's direct products (2 a term) or its
    Wiener-Khinchin form (a real FFT of the row padded to N + the largest
    lag, |.|^2, an inverse FFT), whichever is fewer; rows and lags read,
    (J, L) f32 written."""
    lag = [min(max(int(l), 0), N) for l in lags]
    direct = 2.0 * sum(N - l for l in lag)
    m = N + max(lag)
    wk = 2.0 * _rfft_flops(m) + 3.0 * (m // 2 + 1)
    L = len(lag)
    return J * min(direct, wk), 4.0 * J * N + 4.0 * L + 4.0 * J * L


def dirty_scan(leaves: Iterable[Tuple[int, int]], block: int
               ) -> Tuple[float, float]:
    """B3, the largest |new - old| of each block of ``block`` elements of
    every float leaf (numel, bytes per element): both copies read, one f32
    a block written; a subtraction, an absolute value and a max an
    element."""
    flops = nbytes = 0.0
    for n, size in leaves:
        flops += 3.0 * n
        nbytes += 2.0 * n * size + 4.0 * math.ceil(n / block)
    return flops, nbytes


def causal_pairs(S: int, window: int = 0) -> int:
    """(query, key) pairs of causal attention over S, with a window."""
    if window <= 0 or window >= S:
        return S * (S + 1) // 2
    return window * (window + 1) // 2 + (S - window) * window


def attention(B: int, H: int, Hkv: int, S: int, D: int, *, in_bytes: int,
              window: int = 0) -> Tuple[float, float]:
    """B5, causal attention: q.k and p.v, 4 D a (query, key) pair a head;
    q, k, v read and the output written in ``in_bytes``."""
    return (4.0 * D * causal_pairs(S, window) * B * H,
            in_bytes * (2.0 * B * H * S * D + 2.0 * B * Hkv * S * D))


def ssm_scan(B: int, H: int, S: int, Dk: int, Dv: int,
             inputs: Sequence[Tuple[int, int]]) -> Tuple[float, float]:
    """B4, the gated linear-attention scan of B x H heads over S positions
    (keys of Dk, values of Dv): the SSD recurrence's 5 Dk Dv a head a
    token, as ``counts.lm`` counts it; each input's distinct elements read
    once (``inputs``: (elements, bytes each) of q, k, v, the log decay
    and any bonus and initial state, in that order; a stride-0 dimension,
    as the port broadcasts B, C and the decay, counts once), y written once
    in v's dtype and the final state once in f32."""
    v_bytes = inputs[2][1]
    return (5.0 * B * H * S * Dk * Dv,
            float(sum(n * size for n, size in inputs))
            + v_bytes * B * H * S * Dv + 4.0 * B * H * Dk * Dv)

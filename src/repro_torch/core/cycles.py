"""FFT cycle recognition and cycle decomposition (paper §4.2, Algorithm 1).

Counterpart of ``repro/core/cycles.py``. Input is the chronologically
ordered LM/NLM classification series from the characterizer, one row per
job. ``fit_cycle_batch`` finds each row's dominant period from its power
spectrum (``kernels.ops.power_spectrum``: the DFT kernel on the card, the
plain DFT sums on the CPU), sharpens it with a shared candidate-lag
autocorrelation search (``kernels.ops.autocorr_score``), and splits one
cycle window into the ArrayLM / ArrayNLM moment sets (Algorithm 1).
``fold_profile`` is the 'alma-plus' phase-folded majority vote.

Spectra, peak pick and lag scores stay on the series' device; periods
and confidences come back to the host as whole arrays
(``fit_cycle_rows``), and a row's ``CycleModel`` is built from them only
when asked for (``model_view``; ``fit_cycle_batch`` builds one a row, as
the reference does). ``profile_rows`` gives Algorithm 2's packed profiles
straight from the rows. Argmax ties pick the first index, as
``np.argmax``.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.kernels import ops as kops
from repro_torch.kernels.backend import DeviceLike, resolve_device
from repro_torch.runtime import spans


@dataclass
class CycleModel:
    period: int                    # samples per cycle (0 = acyclic)
    confidence: float              # spectral peak share in (0, 1]
    profile_lm: np.ndarray         # (period,) int8: 1 = LM at this phase
    array_lm: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int64))
    array_nlm: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int64))

    @property
    def cyclic(self) -> bool:
        return self.period > 1 and 0 < self.profile_lm.sum() < self.period


def _as_rows(series, device: DeviceLike) -> torch.Tensor:
    """A tensor keeps its own device; host arrays go to ``device``."""
    if isinstance(series, torch.Tensor):
        return series
    return torch.as_tensor(np.asarray(series), device=resolve_device(device))


def _spectra(X: torch.Tensor, mesh=None) -> torch.Tensor:
    """(J, n) f32 -> (J, n//2+1) one-sided power of the mean-removed rows;
    ``mesh`` splits the rows over its ranks (bit-identical)."""
    return kops.power_spectrum(X, center=True, mesh=mesh)


def power_spectrum(series, device: DeviceLike = None) -> np.ndarray:
    """One-sided |DFT|^2 of the mean-removed series, on ``device``."""
    x = _as_rows(series, device).to(torch.float32)[None]
    return _spectra(x)[0].cpu().numpy()


# A near-constant window leaves only float rounding residue after mean
# removal; relative to the raw signal power that residue is ~eps(f32)^2
# (~1e-14). Real 0/1 classification series with any structure carry
# DC-removed mass >= ~1e-2 of total power, so 1e-9 cleanly separates
# "all noise floor" from "has a cycle to score".
_DEGENERATE_MASS_FRAC = 1e-9


def _total_power(X: torch.Tensor) -> torch.Tensor:
    """(J, n) -> (J,) f64 raw per-row signal power (DC included), the
    reference scale for the degenerate-window confidence clamp."""
    X = X.double()
    return (X * X).sum(dim=1)


def _peak_pick(P: torch.Tensor, n: int, min_period: int, max_period: int,
               total_power: Optional[torch.Tensor] = None
               ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Fleet peak pick. P: (J, n//2+1) one-sided power. Returns host
    (k_star (J,), confidence (J,), found (J,) bool)."""
    ks = torch.arange(P.shape[1], device=P.device)
    periods = torch.where(ks > 0, n / ks.clamp(min=1).double(),
                          torch.full_like(ks, float("inf"), dtype=torch.float64))
    valid = (periods >= min_period) & (periods <= max_period)
    valid[0] = False                               # drop DC
    Pv = torch.where(valid[None, :], P, torch.full_like(P, -1.0))
    k_star = torch.argmax(Pv, dim=1)
    rows = torch.arange(P.shape[0], device=P.device)
    peak = P[rows, k_star]
    found = Pv[rows, k_star] > 0
    # confidence: peak bin's share of the DC-removed one-sided spectral mass
    mass = P[:, 1:].sum(dim=1)
    conf = peak / mass.clamp(min=1e-12)
    if total_power is not None:
        # degenerate-window clamp: a DC-removed mass that is pure float
        # noise gets confidence 0, so gates on confidence fall back
        degen = mass.double() <= _DEGENERATE_MASS_FRAC * total_power
        conf = torch.where(degen, torch.zeros_like(conf), conf)
    return k_star.cpu().numpy(), conf.cpu().numpy(), found.cpu().numpy()


def _lag_window(p0: np.ndarray, n: int, min_period: int, max_period: int
                ) -> Tuple[np.ndarray, np.ndarray]:
    """Per-job candidate lags ``lo .. hi`` around the FFT period ``p0``:
    +/- one bin width (p0^2/n) plus one, clipped to the period range."""
    span = np.maximum(2, np.ceil(p0 * p0 / n).astype(np.int64) + 1)
    lo = np.maximum(min_period, p0 - span)
    hi = np.minimum(np.minimum(max_period, n - 1), p0 + span)
    return lo, hi


def _refine_period_batch(X: torch.Tensor, p0: np.ndarray, min_period: int,
                         max_period: int, mesh=None) -> np.ndarray:
    """Sharpen FFT bin estimates with a local autocorrelation search, for
    the whole fleet at once.

    FFT periods are quantized to n/k; the lag search de-quantizes them
    within +/- one bin width. Rows are centered in f64 and cast to f32,
    and every job scores the one shared lag grid
    ``lo[ok].min() .. hi[ok].max()``; each job's argmax is masked to its
    own window. ``mesh`` splits the lag scores' rows over its ranks.
    """
    J, n = X.shape
    p0 = np.asarray(p0, np.int64)
    lo, hi = _lag_window(p0, n, min_period, max_period)
    ok = hi >= lo
    if not ok.any():
        return p0.copy()
    X = X.double()
    Xc = (X - X.mean(dim=1, keepdim=True)).to(torch.float32)
    lags = torch.arange(int(lo[ok].min()), int(hi[ok].max()) + 1,
                        device=X.device)
    R = kops.autocorr_score(Xc, lags.to(torch.int32), mesh=mesh).double()
    lo_t = torch.as_tensor(lo, device=X.device)
    hi_t = torch.as_tensor(hi, device=X.device)
    valid = (lags[None, :] >= lo_t[:, None]) & (lags[None, :] <= hi_t[:, None])
    R = torch.where(valid, R, torch.full_like(R, float("-inf")))
    best = lags[torch.argmax(R, dim=1)].cpu().numpy()
    return np.where(ok, best, p0)


def cycle_length(series, *, min_period: int = 2,
                 max_period: Optional[int] = None,
                 device: DeviceLike = None) -> Tuple[int, float]:
    """Dominant cycle length of a series. Returns (period, confidence)."""
    x = _as_rows(series, device).to(torch.float32)
    n = x.shape[0]
    if n < 2 * min_period:
        return 0, 0.0
    max_p = min(max_period or n // 2, n // 2)
    X = x[None]
    k_star, conf, found = _peak_pick(_spectra(X), n, min_period, max_p,
                                     total_power=_total_power(X))
    if not found[0]:
        return 0, 0.0
    p0 = np.asarray([int(round(n / k_star[0]))])
    return int(_refine_period_batch(X, p0, min_period, max_p)[0]), \
        float(conf[0])


def decompose(classes: np.ndarray, period: int
              ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Algorithm 1 (verbatim): split the first cycle window of the LM/NLM
    series into (ArrayLM, ArrayNLM) moment-index arrays; also returns the
    (period,) LM profile used by Algorithm 2."""
    c = np.asarray(classes[:period], np.int8)
    idx = np.arange(len(c))
    array_lm = idx[c == 1]
    array_nlm = idx[c != 1]
    return array_lm, array_nlm, c


def fold_profile(classes: np.ndarray, period: int) -> np.ndarray:
    """'alma-plus': phase-folded majority vote across all observed cycles."""
    n = (len(classes) // period) * period
    if n == 0:
        return np.asarray(classes[:period], np.int8)
    folded = np.asarray(classes[:n]).reshape(-1, period)
    return (folded.mean(axis=0) >= 0.5).astype(np.int8)


class CycleFits(NamedTuple):
    """Whole-array cycle fits of J rows. ``period``: (J,) int64, 0 where no
    cycle was found; ``confidence``: (J,) f32, 0 there too; ``host``: the
    (J, n) int8 rows on the host, from which ``model_view`` builds each
    row's ``CycleModel``."""
    period: np.ndarray
    confidence: np.ndarray
    host: np.ndarray


def fit_cycle_rows(classes_batch, *, min_period: int = 2,
                   max_period: Optional[int] = None,
                   device: DeviceLike = None, mesh=None) -> CycleFits:
    """Fleet-scale cycle recognition: one batched power spectrum, one
    batched peak pick, one batched autocorrelation refinement for all
    rows, with no per-row Python. ``classes_batch`` is a (J, n) tensor
    (which keeps its device) or a host array (sent to ``device``).
    ``mesh`` splits the kernel stages' rows over its ranks
    (``core/shard.py``); the peak pick runs on the gathered spectra, so the
    fits are bit-identical."""
    with spans.span("cycles.fit"):
        rows = _as_rows(classes_batch, device)
        X = rows.to(torch.float32)
        J, n = X.shape
        with spans.span("cycles.to_host"):
            cls_host = rows.cpu().numpy().astype(np.int8)
        max_p = min(max_period or n // 2, n // 2)
        if J == 0 or n < 2 * min_period:
            return CycleFits(np.zeros(J, np.int64), np.zeros(J, np.float32),
                             cls_host)
        with spans.span("cycles.spectrum"):
            k_star, conf, found = _peak_pick(_spectra(X, mesh), n,
                                             min_period, max_p,
                                             total_power=_total_power(X))
        p0 = np.round(n / np.maximum(k_star, 1)).astype(np.int64)
        periods = np.where(found, p0, 1)
        if found.any():
            with spans.span("cycles.refine"):
                sel = torch.as_tensor(np.flatnonzero(found), device=X.device)
                periods[found] = _refine_period_batch(X[sel], p0[found],
                                                      min_period, max_p, mesh)
        with spans.span("cycles.models"):
            return CycleFits(np.where(found, periods, 0),
                             np.where(found, conf, np.float32(0)), cls_host)


def model_view(row: np.ndarray, period: int, confidence: float, *,
               folded: bool = False) -> CycleModel:
    """One row's ``CycleModel`` from its fit: period 0 is acyclic, its
    profile the row's majority (LM where at least half the samples are);
    otherwise Algorithm 1's split of the first cycle, or with ``folded``
    the phase-folded vote. Keeps nothing of ``row`` but copies."""
    cls = np.array(row, np.int8)
    if period == 0:
        lm = 1 if len(cls) and 2 * int(cls.sum()) >= len(cls) else 0
        return CycleModel(0, 0.0, np.asarray([lm], np.int8))
    array_lm, array_nlm, profile = decompose(cls, period)
    if folded:
        profile = fold_profile(cls, period)
        idx = np.arange(period)
        array_lm, array_nlm = idx[profile == 1], idx[profile != 1]
    return CycleModel(period, confidence, profile, array_lm, array_nlm)


def profile_rows(rows: torch.Tensor, period: np.ndarray, *,
                 folded: bool = False,
                 lengths: Optional[np.ndarray] = None) -> torch.Tensor:
    """Algorithm 2's (J, P) int8 profiles of J fitted rows, in the layout
    the reference's ``postpone.pack_fleet`` gives ``model_view``'s
    profiles: P the longest period above 1 (1 without one), -1 past each
    row's period and across rows of period <= 1. Whole-tensor ops on the rows' device.
    ``rows``: (J, n) int8 LM series, the first ``lengths`` (J,) of each
    valid (default n); ``period``: (J,) host. ``folded`` takes, for each
    phase, the vote over the row's whole cycles: LM where at least half of
    them are (``fold_profile``)."""
    J, n = rows.shape
    dev = rows.device
    period = np.asarray(period, np.int64)
    cyc = period > 1
    P = int(period[cyc].max()) if cyc.any() else 1
    if folded:
        lengths = np.full(J, n) if lengths is None else np.asarray(lengths)
        p = np.maximum(period, 1)
        count = torch.as_tensor(lengths // p, device=dev)[:, None]
        p = torch.as_tensor(p, device=dev)[:, None]
        t = torch.arange(n, device=dev)[None, :]
        whole = torch.where(t < count * p, rows.to(torch.int32), 0)
        sums = torch.zeros((J, n), dtype=torch.int32, device=dev)
        sums.scatter_add_(1, torch.remainder(t, p).expand(J, n), whole)
        vote = (2 * sums >= count).to(torch.int8)
        rows = torch.where(count > 0, vote, rows)
    prof = rows[:, :P]
    idx = torch.arange(P, device=dev)[None, :]
    per = torch.as_tensor(period, device=dev)[:, None]
    keep = (idx < per) & torch.as_tensor(cyc, device=dev)[:, None]
    return torch.where(keep, prof, torch.full_like(prof, -1))


def fit_cycle_batch(classes_batch, *, min_period: int = 2,
                    max_period: Optional[int] = None,
                    folded: bool = False,
                    device: DeviceLike = None,
                    mesh=None) -> List[CycleModel]:
    """``fit_cycle_rows`` as a list of ``CycleModel`` objects, one a row
    (``model_view``)."""
    fits = fit_cycle_rows(classes_batch, min_period=min_period,
                          max_period=max_period, device=device, mesh=mesh)
    return [model_view(fits.host[j], int(fits.period[j]),
                       float(fits.confidence[j]), folded=folded)
            for j in range(len(fits.period))]


def fit_cycle(classes, *, min_period: int = 2,
              max_period: Optional[int] = None, folded: bool = False,
              device: DeviceLike = None) -> CycleModel:
    """Characterized series -> CycleModel: a J=1 view of
    ``fit_cycle_batch``."""
    rows = _as_rows(classes, device)[None]
    return fit_cycle_batch(rows, min_period=min_period,
                           max_period=max_period, folded=folded)[0]

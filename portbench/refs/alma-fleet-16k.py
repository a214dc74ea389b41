"""Plain reference of the LMCM decide plane (paper §4–§5), for the
``alma-fleet-16k`` configuration: Naive Bayes LM/NLM classification of
every telemetry sample (§4.1), the dominant cycle of the LM series from
its power spectrum, sharpened to one sample by an autocorrelation search
around the spectral period (§4.2, Algorithm 1), the LM profile of the
first cycle of the window, and Algorithm 2's RemainTime (§5.2).

Written from the paper, with the JAX package's modules as the pattern for
what the configuration states (bin edges, lag window, staleness rule).
Plain PyTorch in float64 on whatever device the tensors are on; it imports
nothing of the program and takes nothing the program made: it fits its own
classifier from the training set and replays the traffic log (which VMs
were fitted or ticked at which step) against the raw telemetry.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

LM_OF_CLASS = (1, 0, 1, 1)          # CPU, MEM, IO, IDLE: MEM is not LM


@dataclass
class NB:
    edges: torch.Tensor             # (F, bins-1) f32, nondecreasing
    loglik: torch.Tensor            # (C, F, bins) f64
    logprior: torch.Tensor          # (C,) f64


def nb_fit(features: np.ndarray, labels: np.ndarray, *, bins: int,
           alpha: float, n_classes: int, device) -> NB:
    """Binned NB: per-feature quantile edges (nondecreasing, plus i * 1e-9,
    in f32), Laplace-smoothed per-class bin frequencies, smoothed prior."""
    feats = np.asarray(features, np.float32)
    qs = np.linspace(0.0, 1.0, bins + 1)[1:-1]
    edges = np.quantile(feats, qs, axis=0).T.astype(np.float32)
    edges = np.maximum.accumulate(edges, axis=1)
    edges = edges + (np.arange(edges.shape[1], dtype=np.float32)
                     * np.float32(1e-9))[None, :]
    loglik = np.empty((n_classes, feats.shape[1], bins))
    for f in range(feats.shape[1]):
        b = np.searchsorted(edges[f], feats[:, f], side="left")
        for c in range(n_classes):
            cnt = np.bincount(b[labels == c], minlength=bins).astype(float)
            loglik[c, f] = np.log((cnt + alpha) / (cnt.sum() + alpha * bins))
    prior = np.bincount(labels, minlength=n_classes).astype(float)
    logprior = np.log((prior + alpha) / (prior.sum() + alpha * n_classes))
    return NB(torch.as_tensor(edges, device=device),
              torch.as_tensor(loglik, device=device),
              torch.as_tensor(logprior, device=device))


def nb_lm(nb: NB, windows: torch.Tensor) -> torch.Tensor:
    """(J, T, F) samples -> (J, T) int8 LM series: each sample binned in
    f32 (bin i holds edge[i-1] < x <= edge[i]), the most likely class."""
    x = windows.to(torch.float32)
    J, T, F = x.shape
    lp = nb.logprior.view(1, 1, -1).expand(J, T, -1).clone()
    for f in range(F):
        b = torch.searchsorted(nb.edges[f].contiguous(),
                               x[..., f].contiguous(), right=False)
        lp += nb.loglik[:, f, :].T[b]                     # (J, T, C)
    table = torch.as_tensor(LM_OF_CLASS, dtype=torch.int8, device=x.device)
    return table[lp.argmax(dim=-1)]


def lag_window(p0: torch.Tensor, n: int, min_p: int, max_p: int):
    """Candidate lags lo..hi around the spectral period: one bin width
    (p0^2 / n, rounded up) plus one, at least 2, inside the period range."""
    span = torch.clamp(torch.ceil(p0.double() ** 2 / n).long() + 1, min=2)
    lo = torch.clamp(p0 - span, min=min_p)
    hi = torch.clamp(p0 + span, max=min(max_p, n - 1))
    return lo, hi


def fit(lm: torch.Tensor, *, min_period: int = 2, refine: bool = True
        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(J, n) LM series -> (period (J,) int64, profile (J, n//2) int8 padded
    with -1). Period 0 is acyclic (profile: the majority class, one entry).
    ``refine=False`` keeps the spectral period (the control)."""
    J, n = lm.shape
    dev = lm.device
    max_p = n // 2
    x = lm.double()
    xc = x - x.mean(dim=1, keepdim=True)
    P = torch.fft.rfft(xc, dim=1).abs() ** 2               # (J, n//2+1)
    k = torch.arange(P.shape[1], device=dev)
    per = n / k.clamp(min=1).double()
    ok_k = (k > 0) & (per >= min_period) & (per <= max_p)
    Pv = torch.where(ok_k[None, :], P, torch.full_like(P, -1.0))
    kstar = Pv.argmax(dim=1)
    found = Pv.gather(1, kstar[:, None])[:, 0] > 0
    p0 = torch.from_numpy(np.round(n / np.maximum(
        kstar.cpu().numpy(), 1)).astype(np.int64)).to(dev)
    period = p0.clone()
    if refine and bool(found.any()):
        lo, hi = lag_window(p0, n, min_period, max_p)
        has = found & (hi >= lo)
        if bool(has.any()):
            L0, L1 = int(lo[has].min()), int(hi[has].max())
            best = torch.full((J,), -math.inf, dtype=torch.float64, device=dev)
            arg = p0.clone()
            for lag in range(L0, L1 + 1):
                r = (xc[:, :n - lag] * xc[:, lag:]).sum(dim=1)
                inside = has & (lag >= lo) & (lag <= hi) & (r > best)
                best = torch.where(inside, r, best)
                arg = torch.where(inside, torch.full_like(arg, lag), arg)
            period = torch.where(has, arg, p0)
    period = torch.where(found, period, torch.zeros_like(period))
    idx = torch.arange(max_p, device=dev)[None, :]
    prof = torch.where(idx < period[:, None], lm[:, :max_p].to(torch.int8),
                       torch.full((J, max_p), -1, dtype=torch.int8,
                                  device=dev))
    majority = (x.mean(dim=1) >= 0.5).to(torch.int8)
    prof[:, 0] = torch.where(found, prof[:, 0], majority)
    return period, prof


def remain(period: torch.Tensor, profile: torch.Tensor,
           m_now: torch.Tensor) -> torch.Tensor:
    """Algorithm 2's RemainTime: 0 where the current relative moment is LM,
    else the samples to the next LM moment, wrapping into the next cycle;
    one full period where the profile has no LM moment; 0 without a
    cycle (period 0 or 1)."""
    per = period.clamp(min=1)
    m_rel = torch.remainder(m_now, per)
    idx = torch.arange(profile.shape[1], device=period.device)[None, :]
    is_lm = (profile == 1) & (idx < period[:, None])
    dist = torch.remainder(idx - m_rel[:, None], per[:, None])
    big = torch.full_like(dist, torch.iinfo(torch.int64).max)
    r = torch.where(is_lm, dist, big).min(dim=1).values
    r = torch.where(is_lm.any(dim=1), r, period)
    return torch.where(period <= 1, torch.zeros_like(r), r)


class Fleet:
    """Replays a tick cell's traffic log over the raw telemetry and gives
    the decisions Algorithm 2 makes at any logged tick.

    ``values(steps)`` returns the (n_vms, len(steps), F) samples recorded
    at those steps. Staleness follows the configuration: a fit is redone
    once the window has moved by period // 4 samples (at least 1), or by
    ``acyclic_refit`` samples without a cycle."""

    def __init__(self, cfg: dict, nb: NB, values, n_vms: int, device,
                 refine: bool = True):
        self.window = int(cfg["window"])
        self.min_period = int(cfg["min_period"])
        self.acyclic_refit = int(cfg["acyclic_refit"])
        self.nb, self.values, self.refine = nb, values, refine
        self.dev = device
        self.fitted = torch.full((n_vms,), -1, dtype=torch.int64, device=device)
        self.period = torch.zeros(n_vms, dtype=torch.int64, device=device)
        self.profile = torch.full((n_vms, self.window // 2), -1,
                                  dtype=torch.int8, device=device)
        # VMs marked fitted at ``fitted`` whose fit is not computed yet
        self.pending = torch.zeros(n_vms, dtype=torch.bool, device=device)

    def _fit(self, rows: torch.Tensor, step: int) -> None:
        if rows.numel() == 0:
            return
        steps = np.arange(step - self.window + 1, step + 1)
        w = self.values(steps, rows)                       # (R, T, F)
        lm = nb_lm(self.nb, w)
        period, prof = fit(lm, min_period=self.min_period,
                           refine=self.refine)
        self.period[rows] = period
        self.profile[rows] = prof
        self.fitted[rows] = step
        self.pending[rows] = False

    def _materialize(self, rows: torch.Tensor) -> None:
        """Compute the fits marked pending among ``rows``, by fit step."""
        rows = rows[self.pending[rows]]
        for s in torch.unique(self.fitted[rows]).tolist():
            self._fit(rows[self.fitted[rows] == s], s)

    def fit_all(self, step: int, rows: Optional[torch.Tensor] = None) -> None:
        """A forced refit (of ``rows``, default every VM) at ``step``:
        marked now, computed when first needed."""
        rows = (torch.arange(self.fitted.numel(), device=self.dev)
                if rows is None else rows.to(self.dev))
        self.fitted[rows] = step
        self.pending[rows] = True

    def tick(self, step: int, decide: bool) -> Optional[torch.Tensor]:
        """Refit every stale VM at ``step``; with ``decide``, return every
        VM's RemainTime at ``step``."""
        old = (self.fitted >= 0) & (self.fitted < step)
        self._materialize(torch.nonzero(old & self.pending)[:, 0])
        adv = step - self.fitted
        cyc = self.period > 1
        thr = torch.where(cyc, torch.clamp(self.period // 4, min=1),
                          torch.full_like(self.period, self.acyclic_refit))
        stale = (self.fitted < 0) | (old & (adv >= thr))
        rows = torch.nonzero(stale)[:, 0]
        self._fit(rows, step)
        if not decide:
            return None
        self._materialize(torch.nonzero(self.pending)[:, 0])
        origin = self.fitted - self.window + 1
        return remain(self.period, self.profile, step - origin)


def replay(cfg: dict, nb: NB, values, n_vms: int, log: Sequence[tuple],
           wanted: Sequence[int], device, refine: bool = True
           ) -> Tuple[Dict[int, torch.Tensor], Dict[str, torch.Tensor]]:
    """Decisions at the logged ticks numbered in ``wanted``, and every VM's
    fit as the last of them left it (``period``, and ``origin``: the first
    step of the window it was fit on). ``log`` holds ("fit", step, rows or
    None) and ("tick", step) entries in order."""
    fleet = Fleet(cfg, nb, values, n_vms, device, refine=refine)
    want = set(wanted)
    out: Dict[int, torch.Tensor] = {}
    n_tick = 0
    last_tick = max(want) if want else -1
    for entry in log:
        if n_tick > last_tick:
            break
        if entry[0] == "fit":
            rows = None if entry[2] is None else torch.as_tensor(entry[2])
            fleet.fit_all(entry[1], rows)
        else:
            r = fleet.tick(entry[1], n_tick in want)
            if r is not None:
                out[n_tick] = r
            n_tick += 1
    return out, {"period": fleet.period.clone(),
                 "origin": fleet.fitted - fleet.window + 1}


def mismatches(program: Dict[str, int], ids: List[str], want: torch.Tensor,
               fits: Optional[Dict[str, np.ndarray]] = None,
               want_fits: Optional[Dict[str, torch.Tensor]] = None) -> int:
    """VMs whose RemainTime differs from ``want`` (a missing one counts),
    or, given ``fits`` and ``want_fits``, whose period or fit window
    differs."""
    got = np.asarray([program.get(i, -1) for i in ids], np.int64)
    bad = got != want.cpu().numpy()
    if fits is not None:
        for k in ("period", "origin"):
            bad |= np.asarray(fits[k]) != want_fits[k].cpu().numpy()
    return int(bad.sum())

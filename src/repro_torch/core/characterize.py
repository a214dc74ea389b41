"""Naive Bayes workload characterization (paper §4.1, Table 5) on tensors.

Counterpart of ``repro/core/characterize.py``. The model is the same
binned NB: quantile bin edges per load index, per-class Laplace-smoothed
likelihood tables, a class prior. ``fit`` is the reference's numpy code
unchanged, so the tables are bit-equal to the JAX package's; they then
live as tensors on the model's device, where prediction is a
``searchsorted`` + table gather + sum of logs over a whole fleet's windows.

Bit-identity with the reference (``classify_lm_batch``): windows are cast
to f32 before binning, binning is ``searchsorted(right=False)`` (JAX's
``side="left"``), and the per-feature log-likelihoods are summed in
feature order, as XLA sums them, before the prior is added.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.kernels.backend import DeviceLike, resolve_device

# canonical workload classes (paper §6.2)
CLASSES = ("CPU", "MEM", "IO", "IDLE")
CPU, MEM, IO, IDLE = range(4)
# suitability collapse: pre-copy cost tracks the memory dirty rate
LM_SUITABLE = np.array([True, False, True, True])   # MEM -> NLM


@dataclass
class NaiveBayes:
    """Binned NB model; every table is a tensor on one device."""

    bin_edges: torch.Tensor      # (F, n_bins-1) f32 quantile edges per feature
    log_likelihood: torch.Tensor  # (C, F, n_bins) f32
    log_prior: torch.Tensor      # (C,) f32

    @property
    def n_classes(self) -> int:
        return self.log_prior.shape[0]

    @property
    def device(self) -> torch.device:
        return self.log_prior.device

    def predict_logprob(self, x: torch.Tensor) -> torch.Tensor:
        """x: (..., F) -> log-posterior (..., C) (unnormalized)."""
        lead = x.shape[:-1]
        lp = _nb_logprob(self.bin_edges, self.log_likelihood, self.log_prior,
                         x.reshape(-1, x.shape[-1]))
        return lp.reshape(*lead, -1)

    def predict(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """Returns (class (...,) int32, posterior (..., C))."""
        lp = self.predict_logprob(x)
        return (torch.argmax(lp, dim=-1).to(torch.int32),
                torch.softmax(lp, dim=-1))


def _nb_logprob(edges: torch.Tensor, ll: torch.Tensor, prior: torch.Tensor,
                x: torch.Tensor) -> torch.Tensor:
    """x: (M, F) f32 -> (M, C) unnormalized log-posterior."""
    bins = torch.searchsorted(edges, x.T.contiguous(), right=False)  # (F, M)
    feats = torch.arange(edges.shape[0], device=x.device)[:, None]
    lp = ll[:, feats, bins]                                  # (C, F, M)
    acc = lp[:, 0]
    for f in range(1, lp.shape[1]):                          # feature order
        acc = acc + lp[:, f]
    return acc.T + prior


def _nb_predict_lm(nb: NaiveBayes, x: torch.Tensor) -> torch.Tensor:
    """(..., F) f32 -> (...,) int8 LM/NLM signal: the argmax class mapped
    through ``LM_SUITABLE``, with no softmax posterior."""
    lead = x.shape[:-1]
    lp = _nb_logprob(nb.bin_edges, nb.log_likelihood, nb.log_prior,
                     x.reshape(-1, x.shape[-1]))
    cls = torch.argmax(lp, dim=-1)
    table = torch.as_tensor(LM_SUITABLE, dtype=torch.int8, device=x.device)
    return table[cls.clamp(0, len(LM_SUITABLE) - 1)].reshape(lead)


def naive_bayes_from_arrays(bin_edges, log_likelihood, log_prior,
                            device: DeviceLike = None) -> NaiveBayes:
    """A model from the reference's ``NaiveBayes`` arrays (as numpy), kept
    bit for bit: edges, likelihoods and prior as f32 tensors on
    ``device``."""
    dev = resolve_device(device)

    def t(a):
        return torch.from_numpy(np.array(a, np.float32, order="C")).to(dev)

    return NaiveBayes(t(bin_edges), t(log_likelihood), t(log_prior))


def fit(features: np.ndarray, labels: np.ndarray, *, n_bins: int = 16,
        n_classes: int = len(CLASSES), alpha: float = 1.0,
        device: DeviceLike = None) -> NaiveBayes:
    """features: (N, F) f32; labels: (N,) int in [0, n_classes)."""
    N, F = features.shape
    qs = np.linspace(0, 1, n_bins + 1)[1:-1]
    edges = np.quantile(features, qs, axis=0).T.astype(np.float32)  # (F, nb-1)
    # enforce strictly increasing edges (constant features -> tiny ramp)
    edges = np.maximum.accumulate(edges, axis=1)
    bump = np.arange(edges.shape[1], dtype=np.float32) * 1e-9
    edges = edges + bump[None, :]

    bins = np.stack([np.searchsorted(edges[f], features[:, f])
                     for f in range(F)], axis=1)     # (N, F)
    counts = np.zeros((n_classes, F, n_bins), np.float64)
    for c in range(n_classes):
        sel = bins[labels == c]
        for f in range(F):
            counts[c, f] = np.bincount(sel[:, f], minlength=n_bins)
    ll = np.log((counts + alpha)
                / (counts.sum(axis=2, keepdims=True) + alpha * n_bins))
    prior = np.bincount(labels, minlength=n_classes).astype(np.float64)
    log_prior = np.log((prior + alpha) / (prior.sum() + alpha * n_classes))
    return naive_bayes_from_arrays(edges, ll, log_prior, device)


def _as_f32(nb: NaiveBayes, windows) -> torch.Tensor:
    return torch.as_tensor(windows, device=nb.device).to(torch.float32)


def classify_series(nb: NaiveBayes, window,
                    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Classify a telemetry window (T, F) sample-by-sample.

    Returns (classes (T,), lm_binary (T,) {0=NLM,1=LM}, posterior (T, C)),
    as host arrays like the reference.
    """
    cls, post = nb.predict(_as_f32(nb, window))
    cls = cls.cpu().numpy()
    lm = LM_SUITABLE[np.clip(cls, 0, len(LM_SUITABLE) - 1)].astype(np.int8)
    return cls, lm, post.cpu().numpy()


def classify_series_batch(nb: NaiveBayes, windows,
                          ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Classify a fleet of telemetry windows (J, T, F) in one call. Per-row
    results equal ``classify_series`` on each window (prediction flattens
    leading axes). Returns (classes (J, T), lm (J, T), posterior
    (J, T, C))."""
    return classify_series(nb, windows)


def classify_lm_batch(nb: NaiveBayes, windows) -> torch.Tensor:
    """LM-only fleet classification: (J, T, F) -> (J, T) int8 tensor
    {0=NLM,1=LM} on the model's device — the surveillance tick's classify
    stage. Windows are cast to f32 before binning, as the reference does."""
    return _nb_predict_lm(nb, _as_f32(nb, windows))


def primary_secondary(classes: np.ndarray) -> Tuple[int, Optional[int]]:
    """Paper Table 5 reporting: the dominant and runner-up workload class."""
    counts = np.bincount(classes, minlength=len(CLASSES))
    order = np.argsort(-counts)
    primary = int(order[0])
    secondary = int(order[1]) if counts[order[1]] > 0.1 * counts.sum() else None
    return primary, secondary

"""The whole tick's share of the card's peak: the least time of the work
its kernels need (the spectra and lag scores of every refit VM, at the
peaks of ``counts.kernels``) over the host time of the traced ticks
(record, refresh and tick spans)."""
from portbench.counts import kernels as K


def read(rec):
    wall = sum(sum(rec.spans.get(k, [])) for k in ("record", "refresh",
                                                     "tick"))
    spec = rec.counters.get("spectrum", [])
    scores = rec.counters.get("autocorr", [])
    if wall <= 0 or not (spec or scores):
        return None
    least = (sum(K.seconds(*K.spectrum(B, N)) for B, N in spec)
             + sum(K.seconds(*K.autocorr(J, N, lags))
                   for J, N, lags in scores))
    return 100.0 * least / wall

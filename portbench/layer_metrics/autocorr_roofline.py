"""B2 (``autocorr.cu``): the least time of the traced ticks' lag scores
(``counts.kernels.autocorr`` of each call's rows and lags) over the
kernel's device time."""
from portbench.counts import kernels as K


def read(rec):
    dev = rec.kernel_seconds("autocorr_kernel")
    calls = rec.counters.get("autocorr", [])
    if dev <= 0 or not calls:
        return None
    return 100.0 * sum(K.seconds(*K.autocorr(J, N, lags))
                       for J, N, lags in calls) / dev

"""B1 (``dft_power.cu``): the least time of the traced ticks' power
spectra (``counts.kernels.spectrum`` of each call's shape) over the
kernel's device time."""
from portbench.counts import kernels as K


def read(rec):
    dev = rec.kernel_seconds("fft_power_kernel", "dft_power_kernel")
    calls = rec.counters.get("spectrum", [])
    if dev <= 0 or not calls:
        return None
    return 100.0 * sum(K.seconds(*K.spectrum(B, N)) for B, N in calls) / dev

"""B3 (``dirty_delta.cu``): the least time of the traced migrations' dirty
scans (``counts.kernels.dirty_scan``: both copies of every float leaf read
once) over the kernel's device time."""
from portbench.counts import kernels as K


def read(rec):
    dev = rec.kernel_seconds("dirty_delta_kernel")
    calls = rec.counters.get("scans", [])
    if dev <= 0 or not calls:
        return None
    return 100.0 * sum(K.seconds(*K.dirty_scan(leaves, block))
                       for leaves, block in calls) / dev

"""B4 (``ssm_scan.cu``): the least time of the traced window's scans
(``counts.kernels.ssm_scan`` of each recorded call's shapes and distinct
input elements) over the kernel's device time."""
from portbench.counts import kernels as K


def read(rec):
    dev = rec.kernel_seconds("ssm_scan_kernel")
    calls = rec.counters.get("ssm_scan", [])
    if dev <= 0 or not calls:
        return None
    least = sum(K.seconds(*K.ssm_scan(*c[:6])) for c in calls)
    return 100.0 * least / dev

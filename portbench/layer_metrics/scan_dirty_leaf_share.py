"""Of the bytes the traced migrations' dirty scans read, the share in
leaves in which that scan found a dirty block: the program's
``precopy.scan_bytes`` counter, one (bytes of the leaves the scan read,
bytes of those with a dirty block) a scan. A scan that reads leaves that
never change (the weights, while serving) lowers it; one that skips them
raises it."""
from portbench.lib import program as P


def read(rec):
    got = P.recording(rec)
    if got is None:
        return None
    scans = [v for _, v in got[1].get("precopy.scan_bytes", [])]
    scanned = sum(s for s, _ in scans)
    return 100.0 * sum(d for _, d in scans) / scanned if scanned else None

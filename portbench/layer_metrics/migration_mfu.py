"""The whole migration's share of the card's peak: the least time of what
the traced migrations needed (the decode steps' operations; the state read
and written by the round-0 copy, both copies read by every scan, the dirty
bytes read and written by every merge) at the peaks of ``counts.kernels``,
over their wall time."""
from portbench.counts import kernels as K


def read(rec):
    m = rec.counters.get("migrations", [])
    wall = sum(w for w, _, _, _, _ in m)
    if wall <= 0:
        return None
    nbytes = sum(2.0 * vm + 2.0 * (b - vm) for _, _, _, b, vm in m)
    nbytes += sum(K.dirty_scan(leaves, block)[1]
                  for leaves, block in rec.counters.get("scans", []))
    flops = rec.counters.get("decode_flops", 0.0)
    return 100.0 * max(flops / K.PEAK_FLOPS, nbytes / K.PEAK_BYTES) / wall

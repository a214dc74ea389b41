"""The decode step's share of the card's peak: the traced steps' operations
from the published widths (``counts.lm.decode_flops``) over their time
(the benchmark's spans, each ending when its tokens reach the host) at the
bf16 peak."""
from portbench.counts import kernels as K


def read(rec):
    t = sum(rec.spans.get("decode", []))
    f = rec.counters.get("decode_flops", 0.0)
    return 100.0 * f / (t * K.PEAK_FLOPS) if t > 0 and f > 0 else None

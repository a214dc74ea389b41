"""The prefill's share of the card's peak: the traced prefills' operations
from the published widths (``counts.lm.prefill_flops``) over their time
(the benchmark's spans, synchronised) at the bf16 peak."""
from portbench.counts import kernels as K


def read(rec):
    t = sum(rec.spans.get("prefill", []))
    f = rec.counters.get("prefill_flops", 0.0)
    return 100.0 * f / (t * K.PEAK_FLOPS) if t > 0 and f > 0 else None

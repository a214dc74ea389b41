"""B5 (``flash_attention.cu``): the least time of the traced prefills'
causal attention (``counts.kernels.attention`` of each call's shapes)
over the kernel's device time."""
from portbench.counts import kernels as K


def read(rec):
    dev = rec.kernel_seconds("attn_wg", "attn_f32")
    calls = rec.counters.get("attention", [])
    if dev <= 0 or not calls:
        return None
    least = sum(K.seconds(*K.attention(B, H, Hkv, S, D, in_bytes=nb,
                                       window=w))
                for B, H, Hkv, S, D, nb, w in calls)
    return 100.0 * least / dev

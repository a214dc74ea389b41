"""Mean host time of one send of the dirty blocks (the program's
``precopy.send`` spans: a round's per-leaf merges, or the stop-and-copy's)
in the traced migrations."""
from portbench.lib import program as P


def read(rec):
    return P.mean_ms(rec, "precopy.send")

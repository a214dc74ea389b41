"""The pause a migrated replica's users feel, as a time: the mean host
time of the program's ``precopy.stop_and_copy`` spans (the last scan, the
last dirty set sent, and the destination synchronised)."""
from portbench.lib import program as P


def read(rec):
    return P.mean_ms(rec, "precopy.stop_and_copy")

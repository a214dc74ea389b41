"""The refit's per-VM Python a tick: the summed host time of the
program's ``surveillance.select`` (the staleness scan and grouping),
``cycles.models`` (a ``CycleModel`` a VM) and ``surveillance.commit`` (the
per-job state writes) spans over the traced ticks."""
from portbench.lib import program as P


def read(rec):
    return P.per_tick_ms(rec, "surveillance.select", "cycles.models",
                         "surveillance.commit")

"""Algorithm 2's operands rebuilt a tick: the host time of the program's
``surveillance.pack`` spans (``pp.pack_fleet`` for the fitted fleet, run
whenever a refit cleared the cache) over the traced ticks."""
from portbench.lib import program as P


def read(rec):
    return P.per_tick_ms(rec, "surveillance.pack")

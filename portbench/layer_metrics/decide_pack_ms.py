"""Algorithm 2's operands rebuilt a tick: the host time of the program's
``surveillance.pack`` spans (the fitted fleet's profiles, periods and
origins gathered from the engine's fit store, run whenever a refit
cleared the cache) over the traced ticks."""
from portbench.lib import program as P


def read(rec):
    return P.per_tick_ms(rec, "surveillance.pack")

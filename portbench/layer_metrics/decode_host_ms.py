"""Mean host time of one decode step inside the program (its
``lm.decode_step`` spans): the enqueue of the step's launches with no
synchronise, beside the benchmark's ``decode`` span, which waits for the
tokens."""
from portbench.lib import program as P


def read(rec):
    return P.mean_ms(rec, "lm.decode_step")

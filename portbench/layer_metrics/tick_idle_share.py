"""Share of the traced tick window in which no operation ran on the card
(``Record.idle_share``)."""


def read(rec):
    return rec.idle_share()

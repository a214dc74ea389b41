"""Share of the traced serving window (decode and migrate, or batches of
prefills) in which no operation ran on the card (``Record.idle_share``)."""


def read(rec):
    return rec.idle_share()

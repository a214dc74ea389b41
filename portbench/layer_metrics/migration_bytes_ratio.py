"""Bytes a traced migration sent over the state's size
(``PrecopyReport``: ``bytes_sent`` / ``v_mem``)."""


def read(rec):
    m = rec.counters.get("migrations", [])
    v = sum(vm for _, _, _, _, vm in m)
    return sum(b for _, _, _, b, _ in m) / v if v else None

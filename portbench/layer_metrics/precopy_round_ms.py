"""Mean time of one pre-copy round without the job's own step: each traced
migration's wall time less the decode steps inside it (the benchmark's
spans around its ``step_fn``), over its rounds (``PrecopyReport``)."""


def read(rec):
    m = rec.counters.get("migrations", [])
    rounds = sum(r for _, _, r, _, _ in m)
    if not rounds:
        return None
    return 1e3 * sum(w - d for w, d, _, _, _ in m) / rounds

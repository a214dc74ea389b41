"""The program's own spans and counters in a traced run, and the device's
idle gaps named after them.

The port's recorder (``repro_torch.runtime.spans``) follows
``torch.profiler`` until ``lib/trace.py``'s window turns it on and off
itself, so the traced window holds the program's spans on the host clock
of the benchmark's own spans. ``recording`` drains it once and keeps the
result on the record (``Record.program``), for every reader of the run. A
program without the recorder gives None, and so does each reader of it.

A span is (name, start, end, parent, key), ``parent`` the index of the
span open around it or -1; a counter is a list of (index of the innermost
span open at the count or -1, value).
"""
from __future__ import annotations

import bisect
from typing import Dict, List, Optional, Sequence, Tuple


def recording(rec) -> Optional[tuple]:
    """(spans, counters) the program recorded in the traced window, or
    None where the program has no recorder."""
    got = getattr(rec, "program", None)
    if got is None:
        try:
            from repro_torch.runtime import spans
        except ImportError:
            return None
        got = rec.program = spans.drain()
    return got


def seconds(rec, *names: str) -> Optional[List[float]]:
    """Host seconds of each closed span named one of ``names``, in start
    order; None without a recording."""
    got = recording(rec)
    if got is None:
        return None
    return [s.end - s.start for s in got[0]
            if s.name in names and s.end is not None]


def mean_ms(rec, name: str) -> Optional[float]:
    t = seconds(rec, name)
    return 1e3 * sum(t) / len(t) if t else None


def per_tick_ms(rec, *names: str) -> Optional[float]:
    """The summed time of spans ``names`` over the traced ticks' number."""
    ticks = seconds(rec, "surveillance.tick")
    if not ticks:
        return None
    return 1e3 * sum(seconds(rec, *names)) / len(ticks)


# ---------------------------------------------------------------------------
# the idle gaps
# ---------------------------------------------------------------------------
def _innermost(intervals: Sequence[Tuple[float, float, str]]
               ) -> Tuple[List[float], List[Optional[str]]]:
    """The line cut at every interval's ends: (cuts, name of the shortest
    interval covering each piece between two cuts, None where none
    does)."""
    cuts = sorted({t for a, b, _ in intervals for t in (a, b)})
    starts: Dict[float, list] = {}
    ends: Dict[float, list] = {}
    for k, (a, b, _) in enumerate(intervals):
        starts.setdefault(a, []).append(k)
        ends.setdefault(b, []).append(k)
    active: set = set()
    names: List[Optional[str]] = []
    for t in cuts:
        active.difference_update(ends.get(t, ()))
        active.update(k for k in starts.get(t, ()) if intervals[k][1] > t)
        inner = min(active, key=lambda k: intervals[k][1] - intervals[k][0],
                    default=None)
        names.append(None if inner is None else intervals[inner][2])
    return cuts, names


def _name_at(line, t: float) -> Optional[str]:
    cuts, names = line
    i = bisect.bisect_right(cuts, t) - 1
    return names[i] if 0 <= i < len(cuts) else None


def cut_gaps(gaps: Sequence[Tuple[float, float]],
             host: Sequence[Tuple[float, float, str]],
             program: Sequence[Tuple[float, float, str]]
             ) -> List[Tuple[str, float]]:
    """Each idle gap (start, end) cut at the boundaries of the program's
    spans (start, end, name), each piece named after the innermost program
    span that covers it; a piece no program span covers takes the
    innermost benchmark span (``host``) around its middle, or ``host``.
    Adjacent pieces of one name are joined. Returns (name, seconds)."""
    prog, bench = _innermost(program), _innermost(host)
    out: List[Tuple[str, float]] = []
    for a, b in gaps:
        cuts = prog[0]
        inner = cuts[bisect.bisect_right(cuts, a):bisect.bisect_left(cuts, b)]
        pieces: List[list] = []
        for p, q in zip([a] + inner, inner + [b]):
            name = _name_at(prog, 0.5 * (p + q))
            name = name or _name_at(bench, 0.5 * (p + q)) or "host"
            if pieces and pieces[-1][0] == name:
                pieces[-1][1] += q - p
            else:
                pieces.append([name, q - p])
        out.extend((n, s) for n, s in pieces)
    return out


def named_gaps(tracer, bench, program) -> List[Tuple[str, float]]:
    """The traced window's idle gaps (as ``Tracer.read`` finds them), cut
    by ``cut_gaps`` at the program's spans: ``tracer`` after its window,
    ``bench`` the benchmark's ``Spans``, ``program`` the recorder's spans.
    Every interval is moved to the device clock as ``Tracer.read`` moves
    the benchmark's. A stand-in, with ``scripts/torch_spans_chip.py``, until
    ``Tracer.read`` names its own gaps with ``cut_gaps``; both go then."""
    import torch
    from portbench.lib.trace import _merge
    cuda = torch.autograd.DeviceType.CUDA
    dev = sorted((e.time_range.start / 1e6, e.time_range.end / 1e6)
                 for e in tracer.prof.events() if e.device_type == cuda)
    shift = (dev[0][0] - tracer.h0) if dev else 0.0
    w0, w1 = tracer.h0 + shift, tracer.h1 + shift
    busy = _merge([(max(a, w0), min(b, w1)) for a, b in dev
                   if b > w0 and a < w1])
    gaps, t = [], w0
    for a, b in busy + [(w1, w1)]:
        if a > t:
            gaps.append((t, a))
        t = max(t, b)
    host = [(a + shift, b + shift, n) for n, a, b in bench.intervals]
    prog = [(s.start + shift, s.end + shift, s.name) for s in program
            if s.end is not None]
    return cut_gaps(gaps, host, prog)

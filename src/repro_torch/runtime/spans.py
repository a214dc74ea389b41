"""The port's span-and-counter recorder: where the host's time goes inside
a tick, a migration or a model step.

A span is a named interval of the host clock (``time.perf_counter``, the
clock the benchmark's own spans read), with the span that was open around
it on the same thread as its parent and an optional key (the tick's step,
the pre-copy round, the layer). A count is a value recorded under a name,
with the innermost open span as its place::

    from repro_torch.runtime import spans
    with spans.span("precopy.round", rounds):
        ...
    spans.count("precopy.scan_bytes", (scanned, in_dirty_leaves))

Off, as it starts, a span site tests one module global and returns a
shared no-op context, and ``count`` returns at once: nothing is allocated
and nothing appended. ``enable()`` starts a recording and ``disable()``
ends it; records stay in memory until ``drain()``, at most ``LIMIT`` of
them (spans and counts), past which a recording keeps nothing more and
warns once.

Until the benchmark's traced window calls ``enable``/``disable`` itself,
the recorder also follows ``torch.profiler``: torch's profiler start and
stop hooks start and end a recording as ``enable`` and ``disable`` do, so
a profiled window holds the program's spans on the clock its host marks
use. A recording started by ``enable()`` is left alone by them: a
profiler that starts inside it neither clears it nor, when it stops,
turns it off.

No span synchronises the device. A span times the host: the launches it
enqueues and whatever the host waits for (a copy to the host waits for
the device's queue). The device side is the profiler's. Spans go around
loops over VMs, leaves or rows, never inside them.
"""
from __future__ import annotations

import threading
import time
import warnings
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

#: records (spans and counts) a recording keeps before it drops the rest
LIMIT = 100_000


class Span(NamedTuple):
    name: str
    start: float
    #: None while the span is still open
    end: Optional[float]
    #: index in the drained list of the span open around it; -1 for none
    parent: int
    key: Any


_on = False
#: True while the recording is the profiler's, not ``enable()``'s
_by_profiler = False
#: records the recording may still keep
_room = LIMIT
#: [name, start, end, parent record, key] in start order
_records: List[list] = []
#: name -> [(innermost open record, value)]
_counts: Dict[str, List[tuple]] = {}
_local = threading.local()


def _stack() -> List[list]:
    try:
        return _local.stack
    except AttributeError:
        _local.stack = []
        return _local.stack


class _Noop:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> bool:
        return False


_NOOP = _Noop()


class _Open:
    __slots__ = ("rec",)

    def __init__(self, name: str, key: Any):
        self.rec = [name, 0.0, None, None, key]

    def __enter__(self):
        stack, rec = _stack(), self.rec
        rec[3] = stack[-1] if stack else None
        stack.append(rec)
        _records.append(rec)
        rec[1] = time.perf_counter()
        return self

    def __exit__(self, *exc) -> bool:
        self.rec[2] = time.perf_counter()
        _stack().pop()
        return False


def _take() -> bool:
    """Whether the recording has room for one more record (and books it);
    warns the first time it has none."""
    global _room
    _room -= 1
    if _room >= 0:
        return True
    if _room == -1:
        warnings.warn(f"repro_torch.runtime.spans: {LIMIT} records undrained;"
                      f" the rest of this recording is dropped",
                      RuntimeWarning, stacklevel=3)
    return False


def span(name: str, key: Any = None):
    """A context that records ``name`` while the recorder is on."""
    if not _on or not _take():
        return _NOOP
    return _Open(name, key)


def count(name: str, value: Any) -> None:
    """Record ``value`` under ``name`` while the recorder is on."""
    if not _on or not _take():
        return
    stack = _stack()
    _counts.setdefault(name, []).append((stack[-1] if stack else None,
                                         value))


def enabled() -> bool:
    return _on


def enable() -> None:
    """Start a recording; what an earlier one left undrained is dropped."""
    global _on, _by_profiler, _records, _counts, _room
    _records, _counts, _room = [], {}, LIMIT
    _on, _by_profiler = True, False


def disable() -> None:
    global _on, _by_profiler
    _on = _by_profiler = False


def drain() -> Tuple[List[Span], Dict[str, List[Tuple[int, Any]]]]:
    """(spans, counters) recorded since ``enable()`` or the last drain, and
    empties the recorder. Spans are in start order; a counter is a list of
    (index of the innermost span open at the count or -1, value)."""
    global _records, _counts, _room
    recs, counts = _records, _counts
    _records, _counts, _room = [], {}, LIMIT
    at = {id(r): i for i, r in enumerate(recs)}

    def index(rec) -> int:
        return -1 if rec is None else at.get(id(rec), -1)

    out = [Span(r[0], r[1], r[2], index(r[3]), r[4]) for r in recs]
    counters = {name: [(index(rec), v) for rec, v in values]
                for name, values in counts.items()}
    return out, counters


def _follow_profiler() -> bool:
    """Turn the recorder on and off with ``torch.profiler``'s sessions,
    through the start and stop hooks torch calls at each, unless
    ``enable()`` started the recording. Returns whether torch has the
    hooks; without them only ``enable`` turns the recorder on."""
    from torch.autograd import profiler as prof
    start = getattr(prof, "_run_on_profiler_start", None)
    stop = getattr(prof, "_run_on_profiler_stop", None)
    if start is None or stop is None:
        warnings.warn("repro_torch.runtime.spans: this torch has no profiler "
                      "start/stop hooks; a profiled window records no "
                      "program spans", RuntimeWarning, stacklevel=2)
        return False
    if getattr(start, "follows", False):
        return True

    def on_start() -> None:
        global _by_profiler
        start()
        if not _on:
            enable()
            _by_profiler = True

    def on_stop() -> None:
        if _by_profiler:
            disable()
        stop()

    on_start.follows = True
    prof._run_on_profiler_start, prof._run_on_profiler_stop = on_start, on_stop
    return True


#: whether a ``torch.profiler`` session turns the recorder on
FOLLOWS_PROFILER = _follow_profiler()

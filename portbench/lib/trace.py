"""The traced window: ``torch.profiler`` over the device (kernels, copies
and sets), read back into a ``Record`` that the per-layer metrics read:
the device busy time (the union of the device operations' intervals inside
the window), each device operation's name and time, the benchmark's own
spans, the program's counters and the call shapes of every hand-written
kernel the window ran (``lib/calls.py``), and a breakdown of where the
device time and the idle gaps went (each gap named by the innermost
benchmark span around it, or ``host``).
"""
from __future__ import annotations

import contextlib
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

@dataclass
class Record:
    """What a traced run read. Times in seconds."""
    cell: str
    workload: dict
    config: dict
    window_s: float = 0.0
    busy_s: float = 0.0
    #: (name, seconds) of each device operation inside the window
    device_ops: List[Tuple[str, float]] = field(default_factory=list)
    #: the benchmark's spans: name -> host seconds of each
    spans: Dict[str, List[float]] = field(default_factory=dict)
    #: counts and values read from the program (``TickResult.refitted``,
    #: ``PrecopyReport`` fields, operation counts) and the kernels' call
    #: shapes (``lib/calls.py``)
    counters: Dict[str, Any] = field(default_factory=dict)
    idle_gaps: List[Tuple[str, float]] = field(default_factory=list)

    def kernel_seconds(self, *names: str) -> float:
        """Device seconds of the operations whose name holds one of
        ``names`` as a whole word."""
        import re
        pat = re.compile(r"\b(" + "|".join(map(re.escape, names)) + r")\b")
        return sum(s for n, s in self.device_ops if pat.search(n))

    def idle_share(self) -> Optional[float]:
        """Percent of the window in which no operation ran on the device:
        1 - the union of kernels, copies and sets / the window."""
        if self.window_s <= 0:
            return None
        return 100.0 * (1.0 - self.busy_s / self.window_s)

    def breakdown(self) -> dict:
        by: Dict[str, float] = {}
        for n, s in self.device_ops:
            key = n if len(n) <= 96 else n[:96]
            by[key] = by.get(key, 0.0) + s
        top = sorted(by.items(), key=lambda kv: -kv[1])[:10]
        gaps = sorted(self.idle_gaps, key=lambda g: -g[1])[:10]
        return {"device_ops": [[n, s] for n, s in top],
                "idle_gaps": [[n, s] for n, s in gaps]}


def _merge(iv: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for a, b in sorted(iv):
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


class Tracer:
    """``with tracer.window(): ...`` profiles that block; ``read(record,
    spans)`` fills the record from the profile.

    Only the device is profiled (CUPTI's kernels, copies and sets), so the
    host pays a few microseconds a launch and no cost a host operation.
    The window opens on an idle device with one marker launch; its start on
    the device clock, against the host clock read just before it, maps the
    benchmark's host spans onto the device's timeline to name the gaps.
    Inside the window every kernel entry of ``ops`` is recorded
    (``calls.recorded``); ``read`` puts the records among the counters."""

    def __init__(self, device: str = "cuda"):
        self.prof = None
        self.calls: Dict[str, list] = {}
        self.cuda = device == "cuda"
        self.h0 = self.h1 = 0.0

    @contextlib.contextmanager
    def window(self):
        import time
        import torch
        from torch.profiler import ProfilerActivity, profile
        from portbench.lib import calls
        from portbench.lib.harness import settle
        settle()
        acts = [ProfilerActivity.CUDA] if self.cuda else [ProfilerActivity.CPU]
        with calls.recorded() as self.calls, profile(activities=acts) as prof:
            if self.cuda:
                torch.cuda.synchronize()
                self.h0 = time.perf_counter()
                torch.ones(1, device="cuda")              # the marker
            else:
                self.h0 = time.perf_counter()
            yield
            if self.cuda:
                torch.cuda.synchronize()
            self.h1 = time.perf_counter()
        self.prof = prof

    def read(self, rec: Record, spans) -> Record:
        import torch
        cuda = torch.autograd.DeviceType.CUDA
        dev = sorted((e.time_range.start / 1e6, e.time_range.end / 1e6,
                      e.name) for e in self.prof.events()
                     if e.device_type == cuda)
        rec.window_s = self.h1 - self.h0
        # host clock -> device clock: the marker is the window's first launch
        shift = (dev[0][0] - self.h0) if dev else 0.0
        w0, w1 = self.h0 + shift, self.h1 + shift
        dev = [(max(a, w0), min(b, w1), n) for a, b, n in dev
               if b > w0 and a < w1]
        busy = _merge([(a, b) for a, b, _ in dev])
        rec.busy_s = sum(b - a for a, b in busy)
        rec.device_ops = [(n, b - a) for a, b, n in dev]
        host = [(a + shift, b + shift, n) for n, a, b in spans.intervals]
        gaps, t = [], w0
        for a, b in busy + [(w1, w1)]:
            if a > t:
                gaps.append((t, a))
            t = max(t, b)
        for a, b in gaps:
            mid = 0.5 * (a + b)
            inner = [(s, e_, n) for s, e_, n in host if s <= mid <= e_]
            name = (min(inner, key=lambda h: h[1] - h[0])[2] if inner
                    else "host")
            rec.idle_gaps.append((name, b - a))
        rec.spans = dict(spans.times)
        rec.counters.update(self.calls)
        return rec
